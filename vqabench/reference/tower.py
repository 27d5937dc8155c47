"""The VGG-11-bn tower that both configurations share, in plain PyTorch
float32, with the configurations' int8 post-training quantization.

What the configurations state (``int8_backbone``, ``opt_lvl`` 1, whose
compute dtype is bfloat16; ``dtype`` below, float32 at ``opt_lvl`` 0):

- the image: uint8 -> x / 255, minus the ImageNet mean, over its std,
  rounded to ``dtype``: the tower takes its input in the compute dtype;
- BatchNorm with running statistics (eps 1e-5) folds into each conv:
  ``w * g / sqrt(v + eps)`` and ``(b - m) * g / sqrt(v + eps) + beta``;
- calibration: one pass over the calibration images in which each conv
  quantizes its input with one dynamic scale, ``max|x| / 127``, and its
  weights per output channel, and gives its output in ``dtype``; conv0
  takes its folded weights and bias rounded to ``dtype`` there; each
  conv's input records its per-channel ``max |x|`` (amax);
- inference: each conv's input is quantized with static per-channel scales
  ``s = max(amax, 1e-12) / 127``, folded into the weights; the weights are
  quantized per output channel; rounding is half to even, clipped to
  +-127; the sums are exact integers; ``y = relu(sum * s_w + bias)``; a 2x2
  max-pool follows convs 0, 1, 3, 5 and 7; the next conv quantizes ``y``;
  the last conv gives ``y`` in ``dtype``.

Sums are taken in float64, which holds every integer sum here exactly
(|sum| <= 127^2 * 4608 < 2^53), and rows go through in blocks so that the
largest batch fits beside whatever else is on the device.

``levels`` is 127 for int8; the control passes 7 (int4).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# torchvision's vgg11_bn "A": output channels of each conv, and the convs a
# 2x2 max-pool follows
CHANNELS = (64, 128, 256, 256, 512, 512, 512, 512)
POOLED = (True, True, False, True, False, True, False, True)
# the state-dict index of each conv and of its BatchNorm in vgg11_bn().features
CONV_INDEX = (0, 4, 8, 11, 15, 18, 22, 25)
MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
BN_EPS = 1e-5
BLOCK_ROWS = 16


def rounded(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` rounded to ``dtype`` and read back as float32."""
    return x.to(dtype).float()


def preprocess(images_u8: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """uint8 [B, S, S, 3] -> normalized [B, S, S, 3], float32 values of ``dtype``.
    Normalized in float64 and rounded once."""
    x = images_u8.double() / 255.0
    mean = torch.tensor(MEAN, dtype=torch.float64, device=x.device)
    std = torch.tensor(STD, dtype=torch.float64, device=x.device)
    return rounded((x - mean) / std, dtype)


def folded(weights: dict, prefix: str, i: int):
    """Conv ``i``'s BN-folded weight [O, C, 3, 3] and bias [O], float32."""
    c, b = CONV_INDEX[i], CONV_INDEX[i] + 1
    w = weights[f"{prefix}{c}.weight"].float()
    g = weights[f"{prefix}{b}.weight"].float()
    beta = weights[f"{prefix}{b}.bias"].float()
    mean = weights[f"{prefix}{b}.running_mean"].float()
    var = weights[f"{prefix}{b}.running_var"].float()
    f = g / torch.sqrt(var + BN_EPS)
    return w * f[:, None, None, None], (weights[f"{prefix}{c}.bias"].float() - mean) * f + beta


def over(t: torch.Tensor, levels: int) -> torch.Tensor:
    """``t / levels``, divided (a CUDA division by a host number multiplies by
    its reciprocal, which is not always the quotient)."""
    return t / torch.tensor(float(levels), device=t.device)


def quantize(x: torch.Tensor, s: torch.Tensor, levels: int) -> torch.Tensor:
    return torch.clamp(torch.round(x / s), -levels, levels)


def quantize_weights(w: torch.Tensor, levels: int):
    """Per-output-channel symmetric weights: (integer-valued w [O, C, 3, 3], s_w [O])."""
    s_w = over(torch.clamp_min(w.abs().amax(dim=(1, 2, 3)), 1e-12), levels)
    return quantize(w, s_w[:, None, None, None], levels), s_w


def int_conv(x_q: torch.Tensor, w_q: torch.Tensor, pool: bool) -> torch.Tensor:
    """Exact integer sums of a 3x3 conv (pad 1): NHWC x [O, C, 3, 3] -> NHWC float64,
    2x2 max-pooled on the sums when ``pool``."""
    with torch.backends.cudnn.flags(enabled=False):
        acc = F.conv2d(x_q.permute(0, 3, 1, 2).double(), w_q.double(), padding=1)
    if pool:
        acc = F.max_pool2d(acc, 2)
    return acc.permute(0, 2, 3, 1)


def _stage(x_q, w_q, s_w, bias, pool: bool) -> torch.Tensor:
    return torch.relu(int_conv(x_q, w_q, pool).float() * s_w + bias)


def calibrate(weights: dict, prefix: str, images: torch.Tensor, levels: int = 127,
              dtype: torch.dtype = torch.float32) -> list[torch.Tensor]:
    """Each conv's per-input-channel amax over the normalized ``images``
    (one dynamic scale a conv over the whole calibration batch)."""
    amax, x = [], images.float()
    for i, pool in enumerate(POOLED):
        amax.append(x.abs().amax(dim=(0, 1, 2)))
        s = over(torch.clamp_min(x.abs().amax(), 1e-12), levels)
        w, b = folded(weights, prefix, i)
        if i == 0:
            w, b = rounded(w, dtype), rounded(b, dtype)
        w_q, s_w = quantize_weights(w, levels)
        x = torch.cat([rounded(_stage(quantize(x[r:r + BLOCK_ROWS], s, levels), w_q, s * s_w,
                                      b, pool), dtype)
                       for r in range(0, x.shape[0], BLOCK_ROWS)])
    return amax


def features(weights: dict, prefix: str, images: torch.Tensor, amax: list,
             levels: int = 127, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The tower's output [B, S/32, S/32, 512], float32 values of ``dtype``,
    under static scales."""
    s_x = [over(torch.clamp_min(a, 1e-12), levels) for a in amax]
    packed = []
    for i in range(len(CHANNELS)):
        w, b = folded(weights, prefix, i)
        w_q, s_w = quantize_weights(w * s_x[i][None, :, None, None], levels)
        packed.append((w_q, s_w, b))
    out = []
    for start in range(0, images.shape[0], BLOCK_ROWS):
        x_q = quantize(images[start:start + BLOCK_ROWS].float(), s_x[0], levels)
        for i, pool in enumerate(POOLED):
            y = _stage(x_q, *packed[i], pool)
            x_q = quantize(y, s_x[i + 1], levels) if i + 1 < len(CHANNELS) else None
        out.append(rounded(y, dtype))
    return torch.cat(out)
