"""Probe 6g: int8 conv1 + pool on the int8 hand-off, on the card.

Port of tools/exp_r4_bblk.py (``_hpack_bblk``, its ``pallas_call`` at
:78). The TPU probe sweeps ``b_blk`` samples and ``r_blk`` rows a grid step
to amortize the TPU's per-step cost; those are TPU grid knobs and collapse
into kernel B's one tiling (blocks of 8 x 32 conv pixels x 128 channels).
The function: the int8 hand-off (H-pair packed there, NHWC int8
[B, H/2, W/2, 64] here), weights folded with s1 = linspace(0.5, 2, 64) and
quantized per output channel, pooled sums, dequant + ReLU, bf16 out.

    python -m vqa_tpu_torch.tools.exp_r4_bblk    [BENCH_BATCH=160 EXP_H=448]
"""

from __future__ import annotations

import sys

import torch

from . import _probe
from ..ops import conv_hpack
from ..ops.quant import weight_quant

H = _probe.env_int("EXP_H", 448)


def hpack_bblk(x_q, w_q, scale, b):
    """int8 x [B, H, W, 64], int8 w [3, 3, 64, O], scale and b [O] ->
    bf16 [B, H/2, W/2, O]."""
    return conv_hpack.int8_conv3x3(x_q, w_q, scale, b.float(), pool=True,
                                   out_dtype=torch.bfloat16)


def inputs(dev, batch: int, h: int):
    """The TPU probe's inputs, seeded: x_q uniform int8 in [-127, 127], w
    0.05 normal folded with s1 and quantized, b = 0."""
    g = torch.Generator(device=dev).manual_seed(11)
    x_q = torch.randint(-127, 128, (batch, h // 2, h // 2, 64), generator=g, device=dev,
                        dtype=torch.int8)
    w = torch.randn((3, 3, 64, 128), generator=g, device=dev) * 0.05
    s1 = torch.linspace(0.5, 2.0, 64, device=dev)
    w_q, s_w = weight_quant(w * s1[None, None, :, None])
    return x_q, w_q, s_w, torch.zeros(128, device=dev)


def variants(dev, batch: int):
    x_q, w_q, s_w, b = inputs(dev, batch, H)
    return [_probe.conv3x3_variant("exp_r4_bblk", "6g", "b1_r16", x_q, w_q, b, int8=True,
                                   pool=True, operands=(x_q, w_q, s_w),
                                   wrapper=lambda: hpack_bblk(x_q, w_q, s_w, b))]


def cpu_demo():
    return {"bblk": hpack_bblk(*inputs("cpu", 2, 32))}


def main(argv=None) -> int:
    return _probe.main(__doc__, variants, cpu_demo, argv)


if __name__ == "__main__":
    sys.exit(main())
