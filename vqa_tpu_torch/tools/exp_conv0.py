"""Probe 6a: the bf16 conv0 + bias + ReLU + 2x2 pool, on the card.

Port of tools/exp_conv0.py (``planar_no_tb``, its ``pallas_call`` at :77,
and the ``bdot`` / ``bdot_planar`` variants of
vqa_tpu/ops/conv_stage1.py:_conv0_pallas): the TPU probe compares the
conv0 kernel's output layouts (NHWC, planar [B, O, H/2, W/2] then an XLA
transpose back, planar alone). Store layouts are TPU matters: here one
kernel C launch (bf16 on the tensor cores) writes NHWC. The TPU probe's
XLA reference (``xla_ref``) becomes the cuDNN yardstick; its ``pack_only``
(the TPU's space-to-depth input packing) has no counterpart.

    python -m vqa_tpu_torch.tools.exp_conv0    [BENCH_BATCH=160]
"""

from __future__ import annotations

import sys

import torch

from . import _probe
from .. import _build
from ..ops import conv_stage1

H = 448


def conv0(x, w, b):
    """x [B, H, W, 3] bf16 -> maxpool2x2(relu(conv3x3(x) + b)) [B, H/2, W/2, 64] bf16."""
    return conv_stage1.conv0_f(x, w, b)


def inputs(dev, batch: int, h: int):
    """The TPU probe's inputs, seeded: x normal, w 0.1 normal, b 0, all bf16."""
    g = torch.Generator(device=dev).manual_seed(12)
    x = torch.randn((batch, h, h, 3), generator=g, device=dev).to(torch.bfloat16)
    w = (torch.randn((3, 3, 3, 64), generator=g, device=dev) * 0.1).to(torch.bfloat16)
    return x, w, torch.zeros(64, device=dev, dtype=torch.bfloat16)


def variants(dev, batch: int):
    x, w, b = inputs(dev, batch, H)
    w32, b32 = conv_stage1.conv0_f_operands(x, w, b)
    wk = conv_stage1.conv0_f_kernel_weights(x, w32)

    def reference(span):
        ref = conv_stage1.conv0_f_plain(x[span], w, b)
        return ref, conv_stage1.conv0_f_bound(x[span], w, ref)

    bsz = x.shape[0]
    moved = _probe.nbytes(x, w, b) + bsz * (H // 2) * (H // 2) * 64 * 2
    lib, note = _probe.cudnn_conv(x, w)
    return [_probe.Variant("exp_conv0", "6a", "bdot", _build.CONV0_F, "bf16, NHWC store",
                           f"[{bsz}, {H}, {H}, 3] -> [{bsz}, {H // 2}, {H // 2}, 64]",
                           lambda: conv0(x, w, b),
                           lambda: conv_stage1.launch_conv0_f(x, wk, b32), reference,
                           (moved, 2.0 * bsz * H * H * 27 * 64, _probe.BF16_FLOPS),
                           lib, note)]


def cpu_demo():
    return {"bdot": conv0(*inputs("cpu", 2, 32))}


def main(argv=None) -> int:
    return _probe.main(__doc__, variants, cpu_demo, argv)


if __name__ == "__main__":
    sys.exit(main())
