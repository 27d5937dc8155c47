"""Probe 6h: conv0 with the int8 hand-off to conv1, on the card.

Port of tools/exp_r5_conv0.py (``v1_planar``, its ``pallas_call`` at
:180): the TPU probe's conv0 kernel stores the quantized hand-off planar
([B, 64, H/2, W/2]) and XLA relayouts and H-pair packs it, to dodge a
lane-moving transpose. Store layouts are TPU matters: here kernel A's
requant epilogue writes the NHWC int8 hand-off [B, H/2, W/2, 64] directly
(the same function as probe 6b's ``conv0_i8_packed``, on this probe's
inputs). Its other variants are not Pallas kernels of row 6: ``v0_pallas``
is the model's conv0 (row 3) and ``v2``/``v3`` are XLA convs.

    python -m vqa_tpu_torch.tools.exp_r5_conv0    [BENCH_BATCH=160]
"""

from __future__ import annotations

import sys

import torch

from . import _probe
from .exp_fuse01 import conv0_i8_packed, conv0_variant

H = 448
S_X = (0.02, 0.025, 0.015)
S1 = (0.03,) * 64


def v1_planar(x, w, b, s_x: tuple = S_X, s1: tuple = S1):
    """x [B, H, W, 3] -> the int8 hand-off [B, H/2, W/2, 64] (NHWC)."""
    return conv0_i8_packed(x, w, b, s_x, s1)


def inputs(dev, batch: int, h: int):
    g = torch.Generator(device=dev).manual_seed(10)
    x = (torch.randn((batch, h, h, 3), generator=g, device=dev) * 0.8).to(torch.bfloat16)
    w = torch.randn((3, 3, 3, 64), generator=g, device=dev) * 0.2
    b = torch.randn(64, generator=g, device=dev) * 0.1
    return x, w, b


def variants(dev, batch: int):
    x, w, b = inputs(dev, batch, H)
    return [conv0_variant("exp_r5_conv0", "6h", "v1_planar", x, w, b, S_X, S1)]


def cpu_demo():
    return {"v1_planar": v1_planar(*inputs("cpu", 2, 32))}


def main(argv=None) -> int:
    return _probe.main(__doc__, variants, cpu_demo, argv)


if __name__ == "__main__":
    sys.exit(main())
