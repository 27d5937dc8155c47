"""Probe 6f: the pooled conv of VGG conv3/5/7, int8 or bf16, on the card.

Port of tools/exp_ptap.py (``conv_ptap_pool``, its ``pallas_call`` at
:113). The TPU probe splits the input rows into pairs ([B, H/2, 2, W, C], a
free reshape) so that each pool phase's taps are stride-2 row slabs; that
is a TPU layout, and here the input stays NHWC. int8: x quantized at s_x =
4/127, per-output-channel weights, kernel B pooled with a bf16 epilogue;
bf16: kernel D pooled. Default conv3 at 448² (H 112, C 256, O 256); EXP_*
reach conv5 (56, 512, 512) and conv7 (28, 512, 512). The TPU probe's int8
XLA chain (``i8_xla_pool_ms``) becomes the ``torch._int_mm`` yardstick.

    python -m vqa_tpu_torch.tools.exp_ptap    [BENCH_BATCH=160 EXP_H=112 EXP_CIN=256 EXP_COUT=256]
"""

from __future__ import annotations

import sys

from . import _probe

H = _probe.env_int("EXP_H", 112)
CIN = _probe.env_int("EXP_CIN", 256)
COUT = _probe.env_int("EXP_COUT", 256)


def conv_ptap_pool(x, w, b, s_x: float = _probe.S_X, int8: bool = True):
    """x [B, H, W, C] -> maxpool2x2(relu(conv3x3(x) + b)) [B, H/2, W/2, O] in x.dtype."""
    return _probe.conv3x3(x, w, b, s_x=s_x, int8=int8, pool=True)


def variants(dev, batch: int):
    x, w, b = _probe.conv_inputs(dev, batch, H, CIN, COUT, seed=6)
    return [_probe.conv3x3_variant("exp_ptap", "6f", f"ptap_{tag}_pool", x, w, b,
                                   int8=flag, pool=True)
            for tag, flag in (("i8", True), ("bf16", False))]


def cpu_demo():
    x, w, b = _probe.conv_inputs("cpu", 2, 8, 32, 32, seed=6)
    return {f"ptap_{tag}_pool": conv_ptap_pool(x, w, b, int8=flag)
            for tag, flag in (("i8", True), ("bf16", False))}


def main(argv=None) -> int:
    return _probe.main(__doc__, variants, cpu_demo, argv)


if __name__ == "__main__":
    sys.exit(main())
