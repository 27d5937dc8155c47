"""Probe 6d: conv1 + bias + ReLU + 2x2 pool, int8 or bf16, on the card.

Port of tools/exp_hpack_tap.py (``conv1_hpack_pool``, its ``pallas_call``
at :151). The TPU probe packs H row pairs onto the lanes ([B, H/2, W, 2C],
P[q, w, 64r + c] = x[2q + r, w, c]) so that its dots contract a full 128
lanes at C 64, and fuses the pool; that packing is a TPU layout, and here
the input stays NHWC. int8: x quantized at s_x = 4/127, per-output-channel
weights, kernel B pooled with a bf16 epilogue; bf16: kernel D pooled. The
TPU probe's XLA chain (``bf16_xla_pool_ms``) becomes the cuDNN yardstick.

    python -m vqa_tpu_torch.tools.exp_hpack_tap    [BENCH_BATCH=160 EXP_H=224 EXP_CIN=64 EXP_COUT=128]
"""

from __future__ import annotations

import sys

from . import _probe

H = _probe.env_int("EXP_H", 224)
CIN = _probe.env_int("EXP_CIN", 64)
COUT = _probe.env_int("EXP_COUT", 128)


def conv1_hpack_pool(x, w, b, s_x: float = _probe.S_X, int8: bool = True):
    """x [B, H, W, C] bf16 -> maxpool2x2(relu(conv3x3(x) + b)) [B, H/2, W/2, O]."""
    return _probe.conv3x3(x, w, b, s_x=s_x, int8=int8, pool=True)


def variants(dev, batch: int):
    x, w, b = _probe.conv_inputs(dev, batch, H, CIN, COUT, seed=4)
    return [_probe.conv3x3_variant("exp_hpack_tap", "6d", f"hpack_{tag}_pool", x, w, b,
                                   int8=flag, pool=True)
            for tag, flag in (("i8", True), ("bf16", False))]


def cpu_demo():
    x, w, b = _probe.conv_inputs("cpu", 2, 16, 16, 32, seed=4)
    return {f"hpack_{tag}_pool": conv1_hpack_pool(x, w, b, int8=flag)
            for tag, flag in (("i8", True), ("bf16", False))}


def main(argv=None) -> int:
    return _probe.main(__doc__, variants, cpu_demo, argv)


if __name__ == "__main__":
    sys.exit(main())
