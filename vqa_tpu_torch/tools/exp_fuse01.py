"""Probes 6b and 6c: conv0 with the int8 hand-off to conv1, and conv1 on
it, on the card.

Port of tools/exp_fuse01.py: ``conv0_i8_packed`` (6b, its ``pallas_call``
at :138) and ``hpack_packed`` (6c, at :181). The TPU probe's conv0 epilogue
quantizes with conv1's per-input-channel scales s1 and stores the hand-off
H-pair packed ([B, H/4, W/2, 128], P[q, w, 64r + c] = q8[2q + r, w, c]),
conv1's TPU input layout. The port's hand-off is plain NHWC int8
[B, H/2, W/2, 64] with the same values (ops/conv_stem.py): 6b is kernel A's
requant epilogue, 6c kernel B pooled with a bf16 epilogue on that hand-off
(its weights folded with s1 and quantized per output channel). The probe's
shipped chain (conv0 to bf16, then conv1 quantizing it) is the model's
path, rows 2-4 of the table.

    python -m vqa_tpu_torch.tools.exp_fuse01    [BENCH_BATCH=160 EXP_H=448]
"""

from __future__ import annotations

import sys

import torch
import torch.nn.functional as F

from . import _probe
from .. import _build
from ..ops import conv_hpack, conv_stage1
from ..ops.quant import const, int8_operands, weight_quant

H = _probe.env_int("EXP_H", 448)    # image side; conv0's output is H/2


def conv0_i8_packed(x, w, b, s_x: tuple, s1: tuple):
    """x [B, H, W, 3] -> conv1's int8 input [B, H/2, W/2, 64] (NHWC; the
    TPU probe's [B, H/4, W/2, 128] is its H-pair packing): x quantized with
    per-channel ``s_x``, folded into per-output-channel weights, kernel A's
    requant epilogue with conv1's scales ``s1``."""
    x_q, w_q, s_w = int8_operands(x, w, s_x)
    return conv_stage1.conv0_i8(x_q, w_q, s_w, b.float(), s1=const(s1, x.device))


def hpack_operands(w, s1: tuple):
    """conv1's weights folded with its input scales s1, per-O int8."""
    return weight_quant(w.float() * const(s1, w.device)[None, None, :, None])


def hpack_packed(x_q, w, b, s1: tuple):
    """conv1 + pool from the int8 hand-off [B, H, W, 64] -> bf16 [B, H/2, W/2, O]."""
    w_q, s_w = hpack_operands(w, s1)
    return conv_hpack.int8_conv3x3(x_q, w_q, s_w, b.float(), pool=True,
                                   out_dtype=torch.bfloat16)


def conv0_variant(probe, row, name, x, w, b, s_x: tuple, s1: tuple):
    """``conv0_i8_packed`` on kernel A's requant epilogue."""
    bsz, h, wd, _ = x.shape
    x_q, w_q, s_w = int8_operands(x, w, s_x)
    wf, b32, s1t = conv_stage1.pack_conv0_i8_weights(w_q), b.float(), const(s1, x.device)

    def reference(span):
        return conv_stage1.conv0_i8_plain(x_q[span].contiguous(), w_q, s_w, b32, s1=s1t), None

    # the yardstick: torch._int_mm on kernel A's im2col (27 taps zero-padded
    # to 32) x [32, 64], column-major, int32 out: 32 + 256 bytes a pixel,
    # over the whole batch (in slices where that passes 8 GB)
    wmat = F.pad(w_q.reshape(27, 64), (0, 0, 0, 5)).t().contiguous().t()

    def make(lo, hi):
        xp = F.pad(x_q[lo:hi], (0, 0, 1, 1, 1, 1))
        cols = torch.cat([xp[:, ky:ky + h, kx:kx + wd] for ky in range(3) for kx in range(3)],
                         -1)
        cols = F.pad(cols, (0, 5)).reshape(-1, 32)
        return lambda: torch._int_mm(cols, wmat)
    lib = _probe.library_call(bsz, bsz * h * wd * (32 + 256), make)
    note = f"torch._int_mm on im2col [{bsz * h * wd}, 32] x [32, 64]"
    if isinstance(lib, _probe.Slices):
        note += f", as {-(-bsz // lib.size)} GEMMs of {lib.size}-sample slices, summed"
    moved = _probe.nbytes(x_q, w_q, s_w, b32, s1t) + bsz * (h // 2) * (wd // 2) * 64
    return _probe.Variant(
        probe, row, name, _build.CONV0_S2D_I8, "int8, requant hand-off",
        f"[{bsz}, {h}, {wd}, 3] -> [{bsz}, {h // 2}, {wd // 2}, 64] int8",
        lambda: conv0_i8_packed(x, w, b, s_x, s1),
        lambda: conv_stage1.launch_conv0_i8(x_q, wf, s_w, b32, s1=s1t), reference,
        (moved, 2.0 * bsz * h * wd * 27 * 64, _probe.INT8_OPS),
        lib, note)


def inputs(dev, batch: int, h: int):
    """The TPU probe's inputs, seeded: x bf16 [B, H, H, 3], conv0's and
    conv1's weights and biases; s_x = per-channel max|x| / 127, s1 = conv0's
    per-channel output max / 127 over (up to) 8 images (the f32 plain conv0)."""
    g = torch.Generator(device=dev).manual_seed(8)
    x = torch.randn((batch, h, h, 3), generator=g, device=dev).to(torch.bfloat16)
    w0 = torch.randn((3, 3, 3, 64), generator=g, device=dev) * 0.2
    b0 = torch.randn(64, generator=g, device=dev) * 0.1
    w1 = torch.randn((3, 3, 64, 128), generator=g, device=dev) * 0.05
    b1 = torch.randn(128, generator=g, device=dev) * 0.1
    s_x = tuple((x.float().abs().amax(dim=(0, 1, 2)).clamp_min(1e-12) / 127).tolist())
    y0 = conv_stage1.conv0_f_plain(x[:8].float(), w0, b0)
    s1 = tuple((y0.amax(dim=(0, 1, 2)).clamp_min(1e-12) / 127).tolist())
    return x, w0, b0, w1, b1, s_x, s1


def variants(dev, batch: int):
    x, w0, b0, w1, b1, s_x, s1 = inputs(dev, batch, H)
    hand_off = conv0_i8_packed(x, w0, b0, s_x, s1)
    w_q, s_w = hpack_operands(w1, s1)
    return [conv0_variant("exp_fuse01", "6b", "conv0_packed", x, w0, b0, s_x, s1),
            _probe.conv3x3_variant("exp_fuse01", "6c", "hpack_from_packed", hand_off, w1, b1,
                                   int8=True, pool=True, operands=(hand_off, w_q, s_w),
                                   wrapper=lambda: hpack_packed(hand_off, w1, b1, s1))]


def cpu_demo():
    x, w0, b0, w1, b1, s_x, s1 = inputs("cpu", 2, 32)
    hand_off = conv0_i8_packed(x, w0, b0, s_x, s1)
    return {"conv0_packed": hand_off, "hpack_from_packed": hpack_packed(hand_off, w1, b1, s1)}


def main(argv=None) -> int:
    return _probe.main(__doc__, variants, cpu_demo, argv)


if __name__ == "__main__":
    sys.exit(main())
