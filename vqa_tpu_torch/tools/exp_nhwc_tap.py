"""Probe 6e: unpooled conv1 + bias + ReLU, int8 or bf16, on the card.

Port of tools/exp_nhwc_tap.py (``conv_nhwc_tap``, its ``pallas_call`` at
:101): NHWC tap accumulation, the pool left outside. int8: x quantized at
s_x = 4/127, per-output-channel weights, kernel B unpooled with a bf16
epilogue; bf16: kernel D's unpooled mode. The TPU probe's ``EXP_TAPS < 9``
runs only some taps and computes wrong numbers on purpose (a timing
diagnostic of the TPU): it is not ported. Its ``*_pool_ms`` (the kernel,
then an XLA pool) has no counterpart: the pooled conv is probe 6d.

    python -m vqa_tpu_torch.tools.exp_nhwc_tap    [BENCH_BATCH=160 EXP_H=224 EXP_CIN=64 EXP_COUT=128]
"""

from __future__ import annotations

import sys

from . import _probe

H = _probe.env_int("EXP_H", 224)
CIN = _probe.env_int("EXP_CIN", 64)
COUT = _probe.env_int("EXP_COUT", 128)


def conv_nhwc_tap(x, w, b, s_x: float = _probe.S_X, int8: bool = True):
    """x [B, H, W, C] bf16 -> relu(conv3x3(x) + b) [B, H, W, O] bf16 (no pool)."""
    return _probe.conv3x3(x, w, b, s_x=s_x, int8=int8, pool=False)


def variants(dev, batch: int):
    x, w, b = _probe.conv_inputs(dev, batch, H, CIN, COUT, seed=5)
    return [_probe.conv3x3_variant("exp_nhwc_tap", "6e", f"tap_{tag}_nopool", x, w, b,
                                   int8=flag, pool=False)
            for tag, flag in (("i8", True), ("bf16", False))]


def cpu_demo():
    x, w, b = _probe.conv_inputs("cpu", 2, 16, 16, 32, seed=5)
    return {f"tap_{tag}_nopool": conv_nhwc_tap(x, w, b, int8=flag)
            for tag, flag in (("i8", True), ("bf16", False))}


def main(argv=None) -> int:
    return _probe.main(__doc__, variants, cpu_demo, argv)


if __name__ == "__main__":
    sys.exit(main())
