"""VGG stage 1 (conv 3 -> 64 + folded BN + ReLU + 2x2 maxpool).

Port of vqa_tpu/ops/conv_stage1.py. The TPU kernels feed the MXU a
space-to-depth K=108 dot; on the H100 a direct 3x3 conv over the four pool
phases gives the same sums:

- int8 route: kernel A (``csrc/conv0_s2d_i8.cu``, ``mma.sync`` s8 on the
  tensor cores, the int32 sums of ``_kernel_i8``). Quantizing the image
  stays plain PyTorch, as the JAX package leaves it to XLA.
  :func:`conv0_i8` is its wrapper.
- float route (int8 off): kernel C (``csrc/conv0_f.cu``), the port of
  ``_kernel`` / ``_kernel_v2`` / ``_kernel_wide``. :func:`conv0_f` is its
  wrapper. Both its modes sum on the tensor cores, in another order than
  :func:`conv0_f_plain` (f32 through 3xTF32, with the weights split by
  :func:`pack_conv0_f32_weights`), and are held within :func:`conv0_f_bound`.

Each wrapper calls its kernel's registered operator (``ops.library``), which
launches the kernel for a CUDA tensor (or raises) and runs its plain version
(:func:`conv0_i8_plain`, :func:`conv0_f_plain`, the same arithmetic as
separate eager ops) for a CPU tensor. No autograd: the JAX package
stop-gradients these kernels' inputs (vqa_tpu/models/vgg.py:276-277), and
the port's VGG runs under ``no_grad``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from .._build import CONV0_F, CONV0_S2D_I8
from .quant import activation_quant, epilogue, int_conv3x3, weight_quant

_MODES = {torch.float32: 0, torch.bfloat16: 1}


def _pick_blocking(ho: int, wo: int, itemsize: int = 2):
    """The TPU kernel's row blocking (vqa_tpu/ops/conv_stage1.py:234-251).

    Kept only as a routing predicate: ``conv_stem.stem_supported`` reads it,
    and both packages must route a config the same way."""
    r_blk = 16 if ho % 16 == 0 else (8 if ho % 8 == 0 else None)
    if r_blk is None:
        return None
    row_bytes = max(wo, 8) * 128 * itemsize
    seg = r_blk
    for m in range(ho // r_blk, 0, -1):
        if ho % (m * r_blk) == 0 and m * r_blk * row_bytes <= 2 ** 21:
            seg = m * r_blk
            break
    return ho // seg, r_blk


def conv0_i8_plain(x_q, w_q, scale, bias, *, out_dtype=torch.float32, s1=None):
    """Kernel A's arithmetic in plain PyTorch: exact int sums, 2x2 max on
    the sums, then the f32 epilogue (see ``quant.epilogue``)."""
    if x_q.is_cuda:
        CONV0_S2D_I8.plain_on_cuda += 1
    acc = F.max_pool2d(int_conv3x3(x_q, w_q), 2)
    return epilogue(acc, scale, bias, out_dtype, s1)


def conv0_i8(x_q, w_q, scale, bias, *, out_dtype=torch.float32, s1=None):
    """int8 conv3x3 (C_in 3 -> 64) + dequant + bias + ReLU + 2x2 maxpool.

    ``x_q`` int8 NHWC [B, H, W, 3]; ``w_q`` int8 HWIO [3, 3, 3, 64];
    ``scale``/``bias`` float32 [64] (``scale`` = activation x weight scale).
    Returns [B, H/2, W/2, 64] in ``out_dtype``, or, with ``s1`` (float32
    [64], conv1's per-input-channel scales), int8 ``clip(rint(y / s1))``.
    Calls the operator ``vqa_tpu_torch::conv0_i8`` (``ops.library``).
    """
    return torch.ops.vqa_tpu_torch.conv0_i8(x_q, w_q, scale, bias, out_dtype, s1)


@functools.lru_cache(maxsize=8)
def _conv0_i8_fragment_index(device: str) -> torch.Tensor:
    """Where each byte of kernel A's B fragments comes from in the HWIO
    weights flattened with one zero appended (index 1728)."""
    g, t, j, r, c = np.meshgrid(*map(np.arange, (8, 4, 8, 2, 4)), indexing="ij")
    k, o = t + 4 * r, 8 * j + g                     # K word, output channel
    idx = np.where(c < 3, (3 * k + c) * 64 + o, np.where(k < 3, (24 + k) * 64 + o, 27 * 64))
    return torch.from_numpy(idx.reshape(-1)).to(device)


def pack_conv0_i8_weights(w_q):
    """Kernel A's weights as its ``mma.sync`` B fragments: [3,3,3,64] ->
    int32 [8 (g), 4 (t), 8 (j), 2 (r)], lane 4g + t's registers for n-tile j.

    Register r of lane (g, t) is K word k = t + 4r of output channel
    8j + g. K word k holds tap k's (c0, c1, c2) in bytes 0-2 (tap k = (ky,
    kx) = (k // 3, k % 3)) and, for k < 3, tap 8's channel k in byte 3
    (else 0): the 27 (tap, channel) pairs in one 32-byte k-step.
    """
    flat = torch.cat([w_q.reshape(-1), w_q.new_zeros(1)])
    return flat[_conv0_i8_fragment_index(str(w_q.device))].view(torch.int32).reshape(8, 4, 8, 2)


def launch_conv0_i8(x_q, wf, scale, bias, *, out_dtype=torch.float32, s1=None):
    """Launch kernel A on operands already in its layout: ``x_q`` contiguous
    int8 NHWC on the card, ``wf`` from :func:`pack_conv0_i8_weights`."""
    b, h, w, _ = x_q.shape
    dev = x_q.device
    if x_q.data_ptr() % 4:
        x_q = x_q.clone()        # the launcher refuses an image that is not 4-byte aligned
    scale = scale.to(dev, torch.float32).contiguous()
    bias = bias.to(dev, torch.float32).contiguous()
    if s1 is not None:
        s1 = s1.to(dev, torch.float32).contiguous()
        out = torch.empty((b, h // 2, w // 2, 64), dtype=torch.int8, device=dev)
        mode = 2
    else:
        out = torch.empty((b, h // 2, w // 2, 64), dtype=out_dtype, device=dev)
        mode = _MODES[out_dtype]
    CONV0_S2D_I8.launch(x_q.data_ptr(), wf.data_ptr(), scale.data_ptr(),
                        bias.data_ptr(), s1.data_ptr() if s1 is not None else None,
                        out.data_ptr(), b, h, w, mode)
    return out


def conv0_f_operands(x, w, b):
    """Kernel C's operands: the weights [3,3,3,64] as [27, 64] and the bias
    [64], each rounded to x.dtype (as vqa_tpu/models/vgg.py:249 and
    conv_stage1.py:292-297 do) and widened to f32."""
    dev = x.device
    w32 = w.to(dev, x.dtype).float().reshape(27, -1).contiguous()
    b32 = b.to(dev, x.dtype).float().contiguous()
    return w32, b32


def conv0_f_plain(x, w, b):
    """Kernel C's arithmetic in plain PyTorch, the float route's reference.

    The 27 products (x.dtype operands widened to f32, separate f32
    multiplies) are summed into f32 in one fixed order, taps (kh, kw, c)
    row-major, starting from zero; the 2x2 pool is a max over the f32 sums;
    then + b (b rounded to x.dtype), ReLU, one rounding to x.dtype. Kernel C
    sums on the tensor cores in its own order (in f32 through 3xTF32) and
    is held within :func:`conv0_f_bound` of this version. It differs from
    vqa_tpu's CPU fallback ``_xla_reference``, which rounds the conv to
    x.dtype before the bias.
    """
    if x.is_cuda:
        CONV0_F.plain_on_cuda += 1
    bsz, h, wd, c = x.shape
    w32, b32 = conv0_f_operands(x, w, b)
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))
    acc = torch.zeros((bsz, h, wd, w32.shape[1]), dtype=torch.float32, device=x.device)
    for kh in range(3):
        for kw in range(3):
            for ci in range(c):
                acc = acc + xp[:, kh:kh + h, kw:kw + wd, ci:ci + 1] * w32[(kh * 3 + kw) * c + ci]
    m = acc.reshape(bsz, h // 2, 2, wd // 2, 2, -1).amax(dim=(2, 4))
    return torch.relu(m + b32).to(x.dtype)


def conv0_f(x, w, b):
    """Float conv3x3 (pad 1, C_in 3 -> 64) + bias + ReLU + 2x2 maxpool.

    ``x`` NHWC [B, H, W, 3] float32 or bfloat16 (H, W even); ``w`` HWIO
    [3, 3, 3, 64] and ``b`` [64], BN-folded, any float dtype (rounded to
    x.dtype). Returns [B, H/2, W/2, 64] in x.dtype. Calls the operator
    ``vqa_tpu_torch::conv0_f`` (``ops.library``).
    """
    return torch.ops.vqa_tpu_torch.conv0_f(x, w, b)


def tf32_rna(v):
    """f32 rounded to TF32 (10 mantissa bits), to nearest with ties away
    from zero, the 13 low bits zero: ``cvt.rna.tf32.f32`` on finite values."""
    bits = v.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


@functools.lru_cache(maxsize=8)
def _conv0_f32_fragment_index(device: str) -> torch.Tensor:
    """Where each value of kernel C's f32 A fragments comes from in the
    [27, 64] weights flattened with one zero appended (index 1728)."""
    w, g, q, j, r = np.meshgrid(*map(np.arange, (4, 8, 4, 5, 4)), indexing="ij")
    tap, o = 2 * j + r // 2, 16 * w + g + 8 * (r % 2)   # tap (kh, kw), output channel
    idx = np.where((tap < 9) & (q < 3), (3 * tap + q) * 64 + o, 27 * 64)
    return torch.from_numpy(idx.reshape(128, 1, 5, 4)).to(device)


def pack_conv0_f32_weights(w32):
    """Kernel C's f32 weights as its ``wgmma`` A fragments (the weights are
    the M = 64 side), split once into hi = rna_tf32(w) and lo = rna_tf32(w -
    hi): [27, 64] f32 -> f32 [128 (thread 32w + 4g + q), 2 (hi, lo), 5
    (k-step j), 4 (register r)]. K-step j holds taps 2j and 2j + 1 (tap = 3
    kh + kw), 4 slots each (c0, c1, c2, 0); register r of thread (w, g, q)
    is slot q of tap 2j + r // 2 (zero for slot 3 and tap 9) of output
    channel 16w + g + 8 (r % 2), the m64nNk8 TF32 register layout.
    """
    flat = torch.cat([w32.reshape(-1).float(), w32.new_zeros(1, dtype=torch.float32)])
    v = flat[_conv0_f32_fragment_index(str(w32.device))]
    hi = tf32_rna(v)
    return torch.cat([hi, tf32_rna(v - hi)], dim=1).contiguous()


def conv0_f_kernel_weights(x, w32):
    """The weights as kernel C takes them for ``x.dtype``: the f32 body's
    split A fragments, or ``w32`` itself for the bf16 body."""
    return pack_conv0_f32_weights(w32) if x.dtype == torch.float32 else w32


def launch_conv0_f(x, wk, b32):
    """Launch kernel C on operands already in its layout: ``x`` contiguous
    NHWC on the card, ``wk`` from :func:`conv0_f_kernel_weights`, ``b32``
    from :func:`conv0_f_operands`."""
    bsz, h, wd, _ = x.shape
    out = torch.empty((bsz, h // 2, wd // 2, 64), dtype=x.dtype, device=x.device)
    CONV0_F.launch(x.data_ptr(), wk.data_ptr(), b32.data_ptr(), out.data_ptr(),
                   bsz, h, wd, _MODES[x.dtype])
    return out


def conv0_f_bound(x, w, plain):
    """Kernel C's tolerance, per element of its output:
    ``ulp(|plain|) + c * sum_taps |x * w|`` with ``(ulp_bf16, c = 2^-17)``
    for bf16 and ``(ulp_f32, c = 2^-15)`` for f32. The sum of |x * w| is the
    plain version on |x| and |w| in f32 (bias 0): the largest of the four
    pool phases, as the max takes one. With S = sum |x * w| and u = 2^-23:

    - bf16: the tensor cores sum the 27 exact bf16 x bf16 products in f32 in
      another order than ``conv0_f_plain`` (each of ~32 additions within
      about one f32 ulp of a partial sum no larger than S), and both round
      once to bf16.
    - f32 (3xTF32): hi and lo of each operand leave it within 2^-22 of its
      value, so lo_x hi_w + hi_x lo_w + hi_x hi_w misses x w by at most
      about 3 * 2^-22 |x w|: 6u S in all. The kernel adds these exact TF32
      products in 15 MMAs (5 k-steps x 3), each adding 8 products to its
      accumulator; a tensor core that aligns the 9 terms to the largest and
      truncates loses under one unit of 2^-23 times that term (<= S) per
      term: 135u S. The plain version rounds its 27 products and 27 sums to
      nearest: 27u S. 168u S < 2^-15 S = 256u S, the margin for the ~2^-20
      relative slack in those terms. Max and ReLU move no difference up;
      each side's bias add rounds to nearest once: ulp_f32(|plain|).
    """
    wa = w.to(x.device, x.dtype).abs().float()
    sum_abs = conv0_f_plain(x.abs().float(), wa, torch.zeros(wa.shape[-1], device=x.device))
    c = 2.0 ** -17 if x.dtype == torch.bfloat16 else 2.0 ** -15
    return ulp(plain, x.dtype) + sum_abs * c


def ulp(v: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """One unit in the last place of ``dtype`` (bfloat16 or float32) at
    ``|v|``, as float32 (0 where v is 0)."""
    mag = v.float().abs()
    bits = 8 if dtype == torch.bfloat16 else 24
    _, e = torch.frexp(mag)                         # mag = m * 2^e, m in [0.5, 1)
    return torch.where(mag > 0, torch.ldexp(torch.ones_like(mag), e - bits),
                       torch.zeros_like(mag))


def conv0_bn_relu_pool(x, w, b, *, int8: bool = False, s_x=None):
    """Stage-1 VGG block: conv3x3(pad1) + (folded-BN) bias + ReLU + maxpool2x2.

    x [B, H, W, C], w [3, 3, C, O], b [O] -> [B, H/2, W/2, O] in x.dtype.
    ``int8``: quantize exactly as vqa_tpu's ``_xla_reference_i8`` (``s_x``:
    tuple = static per-input-channel, float = static per-tensor, None =
    dynamic per-batch amax) and run kernel A on the card; otherwise kernel
    C's float route.
    """
    if not int8:
        return conv0_f(x, w, b)
    x_q, s_c, s_out = activation_quant(x, s_x)
    w32 = w.float()
    if s_c is not None:
        w32 = w32 * s_c[None, None, :, None]
    w_q, s_w = weight_quant(w32)
    scale = s_w if s_out is None else s_out * s_w
    return conv0_i8(x_q, w_q, scale, b.float(), out_dtype=x.dtype)
