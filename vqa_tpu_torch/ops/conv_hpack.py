"""int8 conv3x3 + bias + ReLU (+ 2x2 maxpool) with a fused epilogue.

Port of the int8 part of vqa_tpu/ops/conv_hpack.py. The TPU kernel packs H
row pairs onto lanes so its dots contract full 128-lane K; that is a TPU
layout trick, and here the input stays plain NHWC int8. Kernel B
(``csrc/conv3x3_i8.cu``, an implicit GEMM on the int8 tensor cores) is the
one int8 conv of the port: it runs this pooled stage (conv1 in the
calibration pass), the static-path conv1 after the fused stem, and conv2-7,
which the JAX package leaves to XLA's int8 conv.

:func:`int8_conv3x3` is the kernel's wrapper. It calls the registered
operator ``vqa_tpu_torch::int8_conv3x3`` (``ops.library``): a CUDA tensor
launches kernel B (or raises), a CPU tensor runs :func:`int8_conv3x3_plain`.
Pooling the int32 sums before the epilogue equals the JAX order (epilogue,
then pool, or quantize, then pool on int8): every epilogue step is
non-decreasing because the scale is positive
(vqa_tpu/ops/conv_hpack.py:24-28).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .._build import CONV3X3_I8
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


def conv_bn_relu_pool(x, w, b, *, int8: bool = True, s_x=None, s_next=None):
    """Pooled int8 VGG stage: conv3x3(pad1) + (folded-BN) bias + ReLU + maxpool2x2.

    x [B, H, W, C], w [3, 3, C, O], b [O] -> [B, H/2, W/2, O] in x.dtype, or
    int8 with ``s_next`` (tuple, len O: the next stage's scales). Quantizes
    exactly as vqa_tpu's ``_xla_reference_i8`` (``s_x``: tuple = static
    per-input-channel, float = static per-tensor, None = dynamic). The float
    route of the TPU kernel (``int8=False``) is not ported: the model takes
    this stage only for int8 stages.
    """
    if not int8:
        raise NotImplementedError(
            "the float route of vqa_tpu/ops/conv_hpack.py:_kernel is not ported yet")
    x_q, s_c, s_out = activation_quant(x, s_x)
    w32 = w.float()
    if s_c is not None:
        w32 = w32 * s_c[None, None, :, None]
    w_q, s_w = weight_quant(w32)
    scale = s_w if s_out is None else s_out * s_w
    return int8_conv3x3(x_q, w_q, scale, b.float(), pool=True,
                        s_next=None if s_next is None else const(s_next, x.device),
                        out_dtype=x.dtype)
