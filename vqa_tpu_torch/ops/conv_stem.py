"""Fused VGG stem: conv0 and conv1 joined by an int8 hand-off.

Port of vqa_tpu/ops/conv_stem.py. Kernel A's requant epilogue quantizes
conv0's pooled f32 output with conv1's static per-input-channel scales and
stores int8; kernel B then runs conv1 + pool on it. The JAX package stores
that hand-off H-pair packed ([B, H/4, W/2, 128], a TPU lane trick); here it
is plain NHWC int8 [B, H/2, W/2, 64], and the values are the same.

Numerics are the fused ones (vqa_tpu/ops/conv_stem.py:19-27): conv1's input
is quantized from the f32 epilogue, not from a bf16 store, so the fused and
unfused stems are not bit-equal and the route must match the JAX package's.
The requant divides by the scale, as the JAX package's CPU fallback does.
"""

from __future__ import annotations

from .conv_hpack import _pick_r_blk, int8_conv3x3
from .conv_stage1 import _pick_blocking, conv0_i8
from .quant import const, quantize, weight_quant


def stem_supported(x_shape, w0_shape, w1_shape) -> bool:
    """vqa_tpu's static shape rule for the fused stem, unchanged
    (vqa_tpu/ops/conv_stem.py:317-333), so both packages route alike."""
    _, h, wd, _ = x_shape
    if tuple(w0_shape[:2]) != (3, 3) or tuple(w1_shape[:2]) != (3, 3):
        return False
    if w0_shape[3] != 64 or w1_shape[2] != 64:
        return False
    if h % 4 or wd % 4:
        return False
    blocking = _pick_blocking(h // 2, wd // 2, 1)
    if blocking is None:
        return False
    n_seg, r_blk = blocking
    seg = (h // 2) // n_seg
    if seg % 2 or r_blk % 2:
        return False
    return _pick_r_blk(h // 4) is not None


def fused_stem(x, w0, b0, w1, b1, *, s_x0, s_x1, s_next=None):
    """conv0+BN+ReLU+pool, conv1+BN+ReLU+pool with an int8 hand-off.

    x [B, H, W, C] -> [B, H/4, W/4, 128] in x.dtype, or int8 with ``s_next``
    (tuple, len 128: conv2's scales). ``w*``/``b*`` are the BN-folded f32
    weights; ``s_x0``/``s_x1`` the static per-input-channel scale tuples of
    the two stages (mandatory: the hand-off needs conv1's static scales).
    """
    if not (isinstance(s_x0, tuple) and isinstance(s_x1, tuple)):
        raise ValueError("fused_stem requires static per-channel scales "
                         "for both stages (run calibration first)")
    dev = x.device
    s_c0, s1 = const(s_x0, dev), const(s_x1, dev)
    x_q = quantize(x, s_c0)
    w_q0, s_w0 = weight_quant(w0.float() * s_c0[None, None, :, None])
    h = conv0_i8(x_q, w_q0, s_w0, b0.float(), s1=s1)
    w_q1, s_w1 = weight_quant(w1.float() * s1[None, None, :, None])
    return int8_conv3x3(h, w_q1, s_w1, b1.float(), pool=True,
                        s_next=None if s_next is None else const(s_next, dev),
                        out_dtype=x.dtype)
