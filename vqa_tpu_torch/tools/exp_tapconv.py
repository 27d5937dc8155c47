"""Probe 6k: unpooled int8 conv1 + bias + ReLU, bf16 out, on the card.

Port of tools/exp_tapconv.py (``conv_tap_i8``, its ``pallas_call`` at
:91). The TPU probe keeps the input planar ([B, C, H + 2, W + 2]) and
transposes each tap's slab inside the kernel; that is a TPU layout, and
here the input stays NHWC: x quantized at s_x = 4/127, per-output-channel
weights, kernel B unpooled with a bf16 epilogue (the int8 route of probe
6e). Its ``tap_i8_pool_ms`` (the kernel, then an XLA pool) has no
counterpart: the pooled conv is probe 6d.

    python -m vqa_tpu_torch.tools.exp_tapconv    [BENCH_BATCH=160 EXP_H=224 EXP_CIN=64 EXP_COUT=128]
"""

from __future__ import annotations

import sys

from . import _probe

H = _probe.env_int("EXP_H", 224)
CIN = _probe.env_int("EXP_CIN", 64)
COUT = _probe.env_int("EXP_COUT", 128)


def conv_tap_i8(x, w, b, s_x: float = _probe.S_X):
    """x [B, H, W, C] bf16 -> relu(conv3x3(x) + b) [B, H, W, O] bf16 (no pool)."""
    return _probe.conv3x3(x, w, b, s_x=s_x, int8=True, pool=False)


def variants(dev, batch: int):
    x, w, b = _probe.conv_inputs(dev, batch, H, CIN, COUT, seed=7)
    return [_probe.conv3x3_variant("exp_tapconv", "6k", "tap_i8_noflush", x, w, b,
                                   int8=True, pool=False)]


def cpu_demo():
    x, w, b = _probe.conv_inputs("cpu", 2, 16, 16, 32, seed=7)
    return {"tap_i8_noflush": conv_tap_i8(x, w, b)}


def main(argv=None) -> int:
    return _probe.main(__doc__, variants, cpu_demo, argv)


if __name__ == "__main__":
    sys.exit(main())
