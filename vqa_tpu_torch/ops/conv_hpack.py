"""Pooled VGG stage, conv3x3 + bias + ReLU (+ 2x2 maxpool), int8 and float.

Port of vqa_tpu/ops/conv_hpack.py. The TPU kernel packs H row pairs onto
lanes so its dots contract full 128-lane K; that is a TPU layout trick, and
here the input stays plain NHWC. Two hand-written kernels:

- int8: kernel B (``csrc/conv3x3_i8.cu``, an implicit GEMM on the int8
  tensor cores) is the one int8 conv of the port: it runs this pooled stage
  (conv1 in the calibration pass), the static-path conv1 after the fused
  stem, and conv2-7, which the JAX package leaves to XLA's int8 conv.
  :func:`int8_conv3x3` is its wrapper. Pooling the int32 sums before the
  epilogue equals the JAX order (epilogue, then pool, or quantize, then pool
  on int8): every epilogue step is non-decreasing because the scale is
  positive (vqa_tpu/ops/conv_hpack.py:24-28).
- float (``int8=False``, the JAX function's default route): kernel D
  (``csrc/conv3x3_f.cu``, an implicit GEMM with K = 9 C on ``wgmma``:
  bf16 with f32 sums, f32 as 3xTF32; persistent blocks keep their slice of
  the weights, :func:`pack_conv3x3_f_weights`, in shared memory where it
  fits). :func:`conv3x3_f` is its wrapper,
  :func:`conv3x3_f_plain` its arithmetic, and the kernel is held within
  :func:`conv3x3_f_bound` of it.

Each wrapper calls its registered operator (``ops.library``): a CUDA tensor
launches the kernel (or raises), a CPU tensor runs the plain version.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .._build import CONV3X3_F, CONV3X3_I8
from .conv_stage1 import tf32_rna, ulp
from .quant import activation_quant, const, epilogue, int_conv3x3, weight_quant

_MODES = {torch.float32: 0, torch.bfloat16: 1}


def _pick_r_blk(q: int):
    """The TPU kernel's row blocking (vqa_tpu/ops/conv_hpack.py:169-179),
    kept as a routing predicate for ``conv_stem.stem_supported``."""
    for r in range(min(q, 16), 0, -1):
        if q % r == 0:
            return r
    return None


def int8_conv3x3_plain(x_q, w_q, scale, bias, *, pool: bool, s_next=None,
                       out_dtype=torch.float32):
    """Kernel B's arithmetic in plain PyTorch (exact sums, max on the sums,
    then ``quant.epilogue``)."""
    if x_q.is_cuda:
        CONV3X3_I8.plain_on_cuda += 1
    acc = int_conv3x3(x_q, w_q)
    if pool:
        acc = F.max_pool2d(acc, 2)
    return epilogue(acc, scale, bias, out_dtype, s_next)


def int8_conv3x3(x_q, w_q, scale, bias, *, pool: bool, s_next=None,
                 out_dtype=torch.float32):
    """NHWC int8 conv3x3 (pad 1) -> int32 sums -> [2x2 max] -> epilogue.

    ``x_q`` int8 [B, H, W, C]; ``w_q`` int8 HWIO [3, 3, C, O]; ``scale``
    (activation x weight scale) and ``bias`` float32 [O]. Returns
    [B, H', W', O] (H' = H//2 when ``pool``) in ``out_dtype`` (float32 or
    bfloat16), or int8 ``clip(rint(y / s_next))`` when ``s_next`` (float32
    [O], the next stage's per-channel scales) is given. On the card C must
    be a multiple of 32 and O of 64. Calls the operator
    ``vqa_tpu_torch::int8_conv3x3`` (``ops.library``).
    """
    return torch.ops.vqa_tpu_torch.int8_conv3x3(x_q, w_q, scale, bias, pool, s_next, out_dtype)


def pack_conv3x3_weights(w_q):
    """Kernel B's weight layout: HWIO int8 [3, 3, C, O] -> [C/32, P, 9, 16, 2,
    8, 16], P = ceil(O / 128), O zero-padded to 128 P:
    ``wp[k, p, t, n, h, r, i] = w_q[t // 3, t % 3, 32 k + 16 h + i, 128 p + 8 n + r]``.
    ``wp[k, p]``, the 32-channel chunk k of the block of output channels p,
    is 36,864 contiguous bytes that the kernel fetches with one bulk copy,
    already in the order wgmma reads as its B operand (core matrices of 8
    output channels x 16 bytes of K)."""
    kh, kw, c, o = w_q.shape
    op = -(-o // 128) * 128
    w9 = F.pad(w_q, (0, op - o)).reshape(kh * kw, c // 32, 2, 16, op // 128, 16, 8)
    return w9.permute(1, 4, 0, 5, 2, 6, 3).contiguous()


def launch_int8_conv3x3(x_q, wp, scale, bias, *, pool: bool, s_next=None,
                        out_dtype=torch.float32):
    """Launch kernel B on operands already in its layout: ``x_q`` contiguous
    int8 NHWC on the card, ``wp`` from :func:`pack_conv3x3_weights`, ``scale``
    and ``bias`` [O]."""
    b, h, w, c = x_q.shape
    o = scale.shape[0]
    dev = x_q.device
    scale = scale.to(dev, torch.float32).contiguous()
    bias = bias.to(dev, torch.float32).contiguous()
    ho, wo = (h // 2, w // 2) if pool else (h, w)
    if s_next is not None:
        s_next = s_next.to(dev, torch.float32).contiguous()
        out = torch.empty((b, ho, wo, o), dtype=torch.int8, device=dev)
        mode = 2
    else:
        out = torch.empty((b, ho, wo, o), dtype=out_dtype, device=dev)
        mode = _MODES[out_dtype]
    CONV3X3_I8.launch(x_q.data_ptr(), wp.data_ptr(), scale.data_ptr(),
                      bias.data_ptr(), s_next.data_ptr() if s_next is not None else None,
                      out.data_ptr(), b, h, w, c, o, mode, int(pool))
    return out


def _pooled_conv_sums(x32, w32):
    """The 2x2 max over the f32 sums of a conv3x3 (pad 1) of f32 NHWC ``x32``
    and HWIO ``w32``: one f32 matmul over C per tap, the taps added in
    (kh, kw) order. Odd H/W floor (VALID pool): the last row or column is
    not computed."""
    bsz, h, wd, _ = x32.shape
    ho, wo = h // 2, wd // 2
    xp = F.pad(x32, (0, 0, 1, 1, 1, 1))
    acc = None
    for kh in range(3):
        for kw in range(3):
            t = xp[:, kh:kh + 2 * ho, kw:kw + 2 * wo, :] @ w32[kh, kw]
            acc = t if acc is None else acc + t
    return acc.reshape(bsz, ho, 2, wo, 2, -1).amax(dim=(2, 4))


def conv3x3_f_plain(x, w, b):
    """Kernel D's arithmetic in plain PyTorch, the float route's reference:
    the semantics of vqa_tpu's Pallas ``_kernel`` with ``int8=False``.

    The weights are rounded to x.dtype, every product of x.dtype operands is
    summed in f32 (f32 matmuls, full f32: TF32 off as PyTorch's default),
    the 2x2 pool is a max over the f32 sums, then + b in f32 (b is not
    rounded to x.dtype, as ``_conv_hpack`` widens it), ReLU, one rounding to
    x.dtype. It differs from vqa_tpu's CPU fallback ``_xla_reference``,
    which rounds the conv to x.dtype before the bias.
    """
    if x.is_cuda:
        CONV3X3_F.plain_on_cuda += 1
    w32 = w.to(x.device, x.dtype).float()
    m = _pooled_conv_sums(x.float(), w32)
    return torch.relu(m + b.to(x.device).float()).to(x.dtype)


def conv3x3_f(x, w, b):
    """Float conv3x3 (pad 1) + bias + ReLU + 2x2 maxpool (VALID: odd H/W floor).

    ``x`` NHWC [B, H, W, C] float32 or bfloat16; ``w`` HWIO [3, 3, C, O]
    (rounded to x.dtype) and ``b`` [O] (taken as f32), BN-folded. Returns
    [B, H//2, W//2, O] in x.dtype. On the card C and O must be multiples of
    8. Calls the operator ``vqa_tpu_torch::conv3x3_f`` (``ops.library``).
    """
    return torch.ops.vqa_tpu_torch.conv3x3_f(x, w, b)


# Kernel D's output channels a block owns (its wgmma N; csrc/conv3x3_f.cu BN)
CONV3X3_F_SLICE = 128


def pack_conv3x3_f_weights(w, dtype):
    """Kernel D's weight layout: HWIO [3, 3, C, O] rounded to ``dtype`` ->
    bf16 [P, K, 9, N / 8, 2, 8, 8], or f32 [P, K, 2, 9, N / 8, 2, 8, 4] with
    the TF32 split (index 2: hi = rna_tf32(w), lo = rna_tf32(w - hi)):
    ``wp[p, k, (s,) t, n, h, r, i] = part_s(w[t // 3, t % 3, CK k + E h + i,
    N p + 8 n + r])`` with E = 16 bytes of values (8 bf16, 4 f32), a K
    chunk CK = 2 E channels (32 bytes of a pixel), N = ``CONV3X3_F_SLICE``,
    K = ceil(C / CK) and P = ceil(O / N); channels past C and past O are
    zero. ``wp[p]`` is a block's slice, ``wp[p, k]`` one chunk of it, both
    contiguous (one bulk copy each), already in the order wgmma reads as its
    B operand (core matrices of 8 output channels x 16 bytes of K)."""
    kh, kw, c, o = w.shape
    e = 16 // torch.empty((), dtype=dtype).element_size()
    n = CONV3X3_F_SLICE
    nch, op = -(-c // (2 * e)), -(-o // n) * n
    wk = F.pad(w.to(dtype), (0, op - o, 0, nch * 2 * e - c))
    w9 = wk.reshape(kh * kw, nch, 2, e, op // n, n // 8, 8).permute(4, 1, 0, 5, 2, 6, 3)
    if dtype == torch.bfloat16:
        return w9.contiguous()
    hi = tf32_rna(w9)
    return torch.stack([hi, tf32_rna(w9 - hi)], dim=2).contiguous()


def conv3x3_f_operands(x, w, b):
    """Kernel D's operands: the weights rounded to x.dtype in its layout
    (:func:`pack_conv3x3_f_weights`) and the bias as f32 [O]."""
    return (pack_conv3x3_f_weights(w.to(x.device), x.dtype),
            b.to(x.device, torch.float32).contiguous())


def launch_conv3x3_f(x, wp, b32):
    """Launch kernel D on operands already in its layout: ``x`` contiguous
    NHWC on the card, ``wp``/``b32`` from :func:`conv3x3_f_operands`."""
    bsz, h, wd, c = x.shape
    o = b32.shape[0]
    out = torch.empty((bsz, h // 2, wd // 2, o), dtype=x.dtype, device=x.device)
    CONV3X3_F.launch(x.data_ptr(), wp.data_ptr(), b32.data_ptr(), out.data_ptr(),
                     bsz, h, wd, c, o, _MODES[x.dtype])
    return out


def conv3x3_f_bound(x, w, plain):
    """Kernel D's tolerance, per element of its output:
    ``ulp(|plain|) + c * S``, S = sum_taps |x * w| (the plain sums on |x| and
    |w|, the largest of the four pool phases, as the max takes one), ulp of
    x.dtype and ``c = 2 (E_kernel + E_plain) 2^-23`` for K = 9 C:

    - the plain version: 9 matmuls of C products in f32 and 8 adds, in any
      order, each add rounded to nearest (within 2^-24 of a partial sum no
      larger than S): E_plain = (C + 9) / 2;
    - bf16: the products are exact in f32; the kernel adds them in
      9 ceil(C / 16) ``wgmma`` k16 steps of 16 products each (per 16
      channels, the 9 taps in turn). A tensor core that aligns the 17 terms
      to the largest and truncates loses under one unit of 2^-23 times that
      term (<= S) per term: E_kernel = 17 * 9 ceil(C / 16);
    - f32 (3xTF32): hi and lo of each operand leave a product within 3 *
      2^-22 |x w| (6 units of 2^-23), and the kernel takes 3 ``wgmma`` k8
      steps of 8 exact TF32 products each per 8 channels and tap: E_kernel =
      6 + 27 * 9 ceil(C / 8).

    The factor 2 covers the rounding of each side's bias add and, in bf16,
    a rounding to x.dtype that crosses a binade. At C = 64: c = 1.55e-4
    (bf16) and 4.73e-4 (f32), a tensor core's worst case. In f32, at C = 32,
    other round-to-nearest orders land over 1,000 times inside it and a
    model of the kernel that truncates every add 10 to 45 times
    (tests/test_torch_hpack_float.py).
    """
    c_in = x.shape[-1]
    wa = w.to(x.device, x.dtype).abs().float()
    sum_abs = _pooled_conv_sums(x.abs().float(), wa)
    e_plain = (c_in + 9) / 2
    if x.dtype == torch.bfloat16:
        e_kernel = 17 * 9 * -(-c_in // 16)
    else:
        e_kernel = 6 + 27 * 9 * -(-c_in // 8)
    return ulp(plain, x.dtype) + sum_abs * (2 * (e_kernel + e_plain) * 2.0 ** -23)


def conv_bn_relu_pool(x, w, b, *, int8: bool = False, s_x=None, s_next=None):
    """Pooled VGG stage: conv3x3(pad1) + (folded-BN) bias + ReLU + maxpool2x2.

    x [B, H, W, C], w [3, 3, C, O], b [O] -> [B, H//2, W//2, O] in x.dtype,
    or int8 with ``s_next`` (int8 only; tuple, len O: the next stage's
    scales). ``int8=False`` (the default, as in vqa_tpu): kernel D's float
    route (:func:`conv3x3_f`). ``int8``: quantizes exactly as vqa_tpu's
    ``_xla_reference_i8`` (``s_x``: tuple = static per-input-channel, float
    = static per-tensor, None = dynamic) and runs kernel B.
    """
    assert s_next is None or int8, "s_next is an int8-chain handoff"
    if not int8:
        return conv3x3_f(x, w, b)
    x_q, s_c, s_out = activation_quant(x, s_x)
    w32 = w.float()
    if s_c is not None:
        w32 = w32 * s_c[None, None, :, None]
    w_q, s_w = weight_quant(w32)
    scale = s_w if s_out is None else s_out * s_w
    return int8_conv3x3(x_q, w_q, scale, b.float(), pool=True,
                        s_next=None if s_next is None else const(s_next, x.device),
                        out_dtype=x.dtype)
