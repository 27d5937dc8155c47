"""Probe 6i: int8 conv1 + pool with the requant for conv2, on the card.

Port of tools/exp_r5_kdepth.py (``run_variant``, its ``pallas_call`` at
:164). The TPU probe deepens its dots' contraction from 12 dots of K 128 to
4 of K 384 (``kdeep``) on the H-pair-packed input; K depth and packing are
TPU matters, and here one kernel B launch (wgmma k32 steps over K = 9 C)
computes the function: x quantized with static per-input-channel scales
folded into the per-output-channel weights, pooled sums, dequant + bias +
ReLU, then int8 clip(round(y / s_next)). Its ``*_nodequant`` variants cast
the raw sums to int8, wrong numbers on purpose (a timing diagnostic of the
TPU): they are not ported.

    python -m vqa_tpu_torch.tools.exp_r5_kdepth    [BENCH_BATCH=160]
"""

from __future__ import annotations

import sys

import torch

from . import _probe
from ..ops.quant import const

H, C, O = 224, 64, 128


def run_variant(x, w, b, s_x: tuple, s_next: tuple):
    """x [B, H, W, C] -> int8 [B, H/2, W/2, O]: the ``kdeep`` function
    (static per-channel ``s_x``, the next stage's scales ``s_next``)."""
    return _probe.conv3x3(x, w, b, s_x=s_x, pool=True, s_next=const(s_next, x.device))


def _inputs(dev, batch: int, h: int, c: int, o: int):
    g = torch.Generator(device=dev).manual_seed(9)
    x = torch.randn((batch, h, h, c), generator=g, device=dev)
    w = torch.randn((3, 3, c, o), generator=g, device=dev) * 0.05
    b = torch.randn(o, generator=g, device=dev) * 0.1
    return x, w, b, (0.02,) * c, (0.03,) * o


def variants(dev, batch: int):
    x, w, b, s_x, s_next = _inputs(dev, batch, H, C, O)
    return [_probe.conv3x3_variant("exp_r5_kdepth", "6i", "kdeep", x, w, b, int8=True,
                                   pool=True, s_x=s_x, s_next=const(s_next, dev))]


def cpu_demo():
    return {"kdeep": run_variant(*_inputs("cpu", 2, 16, 64, 128))}


def main(argv=None) -> int:
    return _probe.main(__doc__, variants, cpu_demo, argv)


if __name__ == "__main__":
    sys.exit(main())
