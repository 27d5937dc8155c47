"""VGG stage 1 (conv 3 -> 64 + folded BN + ReLU + 2x2 maxpool), int8.

Port of the int8 part of vqa_tpu/ops/conv_stage1.py. The TPU kernel
(``_kernel_i8``) feeds the MXU a space-to-depth K=108 dot; on the H100 the
stage is bound by bytes, not MACs, so kernel A (``csrc/conv0_s2d_i8.cu``)
runs a direct 3x3 conv over the four pool phases with ``__dp4a`` and the
same int32 sums. Quantizing the image stays plain PyTorch, as the JAX
package leaves it to XLA.

:func:`conv0_i8` is the kernel's wrapper: a CUDA tensor launches kernel A
(or raises), a CPU tensor runs :func:`conv0_i8_plain`, the same arithmetic
as separate eager ops. The float route (int8 off) is the TPU kernel
``_kernel`` and has no CUDA kernel yet: on the card it raises.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .._build import CONV0_S2D_I8
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
    """
    if not x_q.is_cuda:
        return conv0_i8_plain(x_q, w_q, scale, bias, out_dtype=out_dtype, s1=s1)
    b, h, w, c = x_q.shape
    if x_q.dtype != torch.int8 or c != 3 or w_q.shape != (3, 3, 3, 64):
        raise ValueError(f"conv0_i8: need int8 x [B,H,W,3] and w [3,3,3,64], "
                         f"got x{tuple(x_q.shape)} {x_q.dtype} w{tuple(w_q.shape)}")
    if h % 2 or w % 2:
        raise ValueError(f"conv0_i8: H and W must be even, got {h}x{w}")
    if s1 is None and out_dtype not in _MODES:
        raise ValueError(f"conv0_i8: out_dtype {out_dtype} not supported")
    dev = x_q.device
    x_q = x_q.contiguous()
    # [3,3,3,64] -> [9][64] char4 words (c0, c1, c2, 0)
    w4 = F.pad(w_q.to(dev).permute(0, 1, 3, 2), (0, 1)).contiguous().view(torch.int32)
    scale = scale.to(dev, torch.float32).contiguous()
    bias = bias.to(dev, torch.float32).contiguous()
    if s1 is not None:
        s1 = s1.to(dev, torch.float32).contiguous()
        out = torch.empty((b, h // 2, w // 2, 64), dtype=torch.int8, device=dev)
        mode = 2
    else:
        out = torch.empty((b, h // 2, w // 2, 64), dtype=out_dtype, device=dev)
        mode = _MODES[out_dtype]
    CONV0_S2D_I8.launch(x_q.data_ptr(), w4.data_ptr(), scale.data_ptr(),
                        bias.data_ptr(), s1.data_ptr() if s1 is not None else None,
                        out.data_ptr(), b, h, w, mode)
    return out


def _reference(x, w, b):
    """conv3x3(pad 1) + bias + ReLU + maxpool2x2 in x.dtype (the float route)."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w.to(x.dtype).permute(3, 2, 0, 1),
                 b.to(x.dtype), padding=1)
    return F.max_pool2d(torch.relu(y), 2).permute(0, 2, 3, 1).contiguous()


def conv0_bn_relu_pool(x, w, b, *, int8: bool = False, s_x=None):
    """Stage-1 VGG block: conv3x3(pad1) + (folded-BN) bias + ReLU + maxpool2x2.

    x [B, H, W, C], w [3, 3, C, O], b [O] -> [B, H/2, W/2, O] in x.dtype.
    ``int8``: quantize exactly as vqa_tpu's ``_xla_reference_i8`` (``s_x``:
    tuple = static per-input-channel, float = static per-tensor, None =
    dynamic per-batch amax) and run kernel A on the card.
    """
    if not int8:
        if x.is_cuda:
            raise NotImplementedError(
                "the float conv0 kernel (vqa_tpu/ops/conv_stage1.py:_kernel) is "
                "not ported to CUDA yet: serve with the int8 backbone "
                "(--opt_lvl >= 1 or --int8_backbone true)")
        return _reference(x, w, b)
    x_q, s_c, s_out = activation_quant(x, s_x)
    w32 = w.float()
    if s_c is not None:
        w32 = w32 * s_c[None, None, :, None]
    w_q, s_w = weight_quant(w32)
    scale = s_w if s_out is None else s_out * s_w
    return conv0_i8(x_q, w_q, scale, b.float(), out_dtype=x.dtype)
