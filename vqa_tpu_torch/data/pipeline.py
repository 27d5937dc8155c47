"""Device-side image preprocess (port of ``preprocess_images``,
vqa_tpu/data/pipeline.py:37-58).

uint8 [B, H, W, 3] -> /255 -> ImageNet normalize, on the target device. A
resize runs only when the sizes differ (bilinear, antialiased, as
``jax.image.resize`` is on a downscale); serving decodes straight to the
model's size, so the serving path never resizes.

Arithmetic: the JAX package's jitted preprocess compiles to
``fma(x, f32(1/255), -mean) * f32(1/std)`` (XLA folds both divisions by
constants into multiplies by reciprocals, and the CPU backend contracts the
first pair into an FMA). The port computes the same values: ``x * r - mean``
is exact in float64 (an 8-bit integer times a 24-bit constant, plus a
24-bit constant), so rounding it once to f32 is the FMA. Every op is exactly
rounded, so the CPU and the card give the same bits.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.quant import const

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
_INV_255 = float(np.float32(1.0) / np.float32(255.0))
_INV_STD = tuple(float(np.float32(1.0) / np.float32(s)) for s in IMAGENET_STD)


def preprocess_images(raw_uint8, image_size: int, compute_dtype=torch.float32,
                      device="cpu") -> torch.Tensor:
    """uint8 [B, H, W, 3] (numpy or tensor) -> normalized [B, S, S, 3]."""
    x = torch.as_tensor(np.asarray(raw_uint8) if not isinstance(raw_uint8, torch.Tensor)
                        else raw_uint8).to(device)
    mean = const(IMAGENET_MEAN, x.device)
    b, h, w, c = x.shape
    if (h, w) != (image_size, image_size):
        x = x.float() * const(_INV_255, x.device)
        x = F.interpolate(x.permute(0, 3, 1, 2), size=(image_size, image_size),
                          mode="bilinear", align_corners=False, antialias=True
                          ).permute(0, 2, 3, 1)
        x = x - mean
    else:
        x = (x.double() * const(_INV_255, x.device).double() - mean.double()).float()
    return (x * const(_INV_STD, x.device)).to(compute_dtype)


def make_image_preprocessor(image_size: int, compute_dtype=torch.float32,
                            device="cpu"):
    """Bind the static arguments of :func:`preprocess_images`."""
    def fn(raw_uint8):
        return preprocess_images(raw_uint8, image_size, compute_dtype, device)
    return fn
