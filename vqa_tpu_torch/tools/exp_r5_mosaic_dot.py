"""Probe 6j: the tensor cores' rate on operands in shared memory (kernel F).

Port of tools/exp_r5_mosaic_dot.py (``rate``, its ``pallas_call`` at :52,
body ``_kernel`` at :37), a roofline probe of the TPU's matrix unit. Per
step of GRID it multiplies a slab x [R, W, K] (M = R W = 3,584 rows, the
hpack kernel's) by ``ndots`` resident weight matrices [K, N = 128], sums
the products and keeps row 0 of R, for K in {128, 256, 512} with 12, 6 and
3 dots (the same operations at each K), s8 -> s32 and bf16 -> f32. Here
kernel F (``csrc/mma_rate.cu``) runs the products on ``wgmma`` with the
weights resident in shared memory and x streamed by TMA; its rate against
the published peaks (1,979 int8 TOP/s, 989 bf16 TFLOP/s at 700 W) is what
a hand-written ``wgmma`` loop on this card sustains. The timed operands are
2s, as on the TPU; a seeded check with small random integers at the full
grid guards the layout and the TMA ring. The yardstick is one GEMM of the
same operations (:func:`stacked_operands`): ``torch._int_mm`` (int32 out) /
``torch.mm`` with f32 out of [GRID M, ndots K] x [ndots K, 128], which
moves ndots times x's bytes; large GEMMs, bound by their operations (M = N
= 8,192, K 4,096 to 16,384), give the library's own rate on this card
(:func:`gemm_ceiling`), the best of them its ceiling.

    python -m vqa_tpu_torch.tools.exp_r5_mosaic_dot
"""

from __future__ import annotations

import sys

import torch

from . import _probe
from .. import _build
from ..ops import mma_rate as F_ops

R, W, N = 16, 224, 128
GRID = 700
CEILING = 8192                                    # the ceiling GEMMs' M and N (gemm_ceiling)
CEILING_KS = (4096, 8192, 16384)                  # and their K
DEPTHS = ((128, 12), (256, 6), (512, 3))          # (K, ndots): K ndots = 1,536
TYPES = {"s8": (torch.int8, _probe.INT8_OPS), "bf16": (torch.bfloat16, _probe.BF16_FLOPS)}


def rate_fn(x, w):
    """x [G, R, W, K], w [ndots, K, N] -> row 0 of sum_i x[g] @ w[i], [G, W, N]."""
    return F_ops.mma_rate(x, w)


def operands(dev, dtype, k: int, nd: int, grid: int, r: int, wd: int):
    """The TPU probe's operands: every value 2."""
    return (torch.full((grid, r, wd, k), 2, dtype=dtype, device=dev),
            torch.full((nd, k, N), 2, dtype=dtype, device=dev))


def stacked_operands(x, w):
    """The yardstick's operands: x [G, R, W, K] as [G R W, ndots K] (each row
    beside itself ndots times) and the w_i stacked along K, [ndots K, N].
    Their product is sum_i x @ w_i for every row, the operations of kernel
    F; row 0 of R is a slice of it."""
    nd, k, n = w.shape
    return x.reshape(-1, k).repeat(1, nd), w.reshape(nd * k, n)


def _variant(dev, label: str, k: int, nd: int):
    dtype, peak = TYPES[label]
    x, w = operands(dev, dtype, k, nd, GRID, R, W)
    wt = F_ops.pack_mma_rate_weights(w)

    def reference(span):
        return F_ops.mma_rate_plain(x[span], w), None

    def random_check():
        # small random integers at the full grid: every block walks many
        # units through the TMA ring (sums exact in f32)
        gen = torch.Generator(device=dev).manual_seed(13)
        xr = torch.randint(-8, 9, (GRID, R, W, k), generator=gen, device=dev,
                           dtype=torch.int8).to(dtype)
        wr = torch.randint(-8, 9, (nd, k, N), generator=gen, device=dev,
                           dtype=torch.int8).to(dtype)
        return _probe.held(f"exp_r5_mosaic_dot {label} K={k} random", rate_fn(xr, wr),
                           F_ops.mma_rate_plain(xr, wr))

    # every row multiplied, as on the TPU; x, w and the output moved once
    ops = 2.0 * GRID * R * W * k * N * nd
    moved = _probe.nbytes(x, w) + GRID * W * N * 4
    xs, ws = stacked_operands(x, w)
    if dtype == torch.int8:
        ws = ws.t().contiguous().t()
    note = "torch._int_mm (int32 out)" if dtype == torch.int8 else "torch.mm (f32 out)"
    return _probe.Variant(
        "exp_r5_mosaic_dot", "6j", f"{label} K={k} ndots={nd}", _build.MMA_RATE,
        f"{label}, K {k}, {nd} dots", f"x [{GRID}, {R}, {W}, {k}], w [{nd}, {k}, {N}]",
        lambda: rate_fn(x, w), lambda: F_ops.launch_mma_rate(x, wt, nd), reference,
        (moved, ops, peak), lambda: product(xs, ws),
        f"{note} [{xs.shape[0]}, {nd * k}] x [{nd * k}, {N}]: x beside itself {nd} times "
        f"by the w_i stacked along K, the same operations",
        plain=lambda: F_ops.mma_rate_plain(x, w), whole=True, more_check=random_check,
        extra={"type": label, "k": k, "ndots": nd, "operations": ops, "peak_tops": peak / 1e12})


def variants(dev, batch: int):
    """Every (type, K), one at a time (a bf16 yardstick's operands take 7.7
    GB): ``batch`` is not used (the TPU probe has none)."""
    return (_variant(dev, label, k, nd) for label in TYPES for k, nd in DEPTHS)


def product(a, b):
    """One library GEMM of F's types: ``torch._int_mm`` (s8 -> s32, ``b``
    column-major) or ``torch.mm`` with f32 out (bf16)."""
    if a.dtype == torch.int8:
        return torch._int_mm(a, b)
    return torch.mm(a, b, out_dtype=torch.float32)


def gemm_ceiling(dev, label: str, k: int) -> tuple[float, float]:
    """(ms, T/s) of one GEMM of M = N = CEILING and K ``k`` on 2s:
    operations bound it (2 M N K of them on (M + N) K + M N values), so its
    rate is what the library sustains on this card at its power limit."""
    dtype = TYPES[label][0]
    a = torch.full((CEILING, k), 2, dtype=dtype, device=dev)
    b = torch.full((CEILING, k), 2, dtype=dtype, device=dev).t()   # column-major [k, N]
    ms = _probe.timed(lambda: product(a, b), 4)[0]
    return ms, 2.0 * CEILING * CEILING * k / (ms * 1e-3) / 1e12


def run_rates(rows):
    """The TPU probe's lines: the rate a pass sustains, against the peak,
    the yardstick GEMM's rate on the same operations, and the library's
    rates on large GEMMs (:func:`gemm_ceiling` at each of CEILING_KS, once
    a type; ``ceiling_tops`` the best)."""
    ceilings = {}
    for r in rows:
        label = r["type"]
        if label not in ceilings:
            ceilings[label] = {k: gemm_ceiling(torch.device("cuda"), label, k)
                               for k in CEILING_KS}
            for k, (ms, tops) in ceilings[label].items():
                print(f"ceiling {label} GEMM M = N = {CEILING}, K {k}: {ms:.4f} ms, {tops:.1f} "
                      f"T/s ({100 * tops / r['peak_tops']:.1f}% of {r['peak_tops']:.0f}) "
                      f"({r['card']})", flush=True)
        tops = r["operations"] / (r["launch_ms"] * 1e-3) / 1e12
        lib = r["operations"] / (r["library_ms"] * 1e-3) / 1e12
        r["rate_tops"], r["share_of_peak"], r["library_tops"] = tops, tops / r["peak_tops"], lib
        r["ceilings"] = {str(k): list(v) for k, v in ceilings[label].items()}
        r["ceiling_tops"] = max(t for _, t in ceilings[label].values())
        print(f"{r['variant']}: {tops:.1f} T/s ({100 * r['share_of_peak']:.1f}% of "
              f"{r['peak_tops']:.0f}), {r['launch_ms']:.4f} ms a pass; the GEMM of its "
              f"operations {lib:.1f} T/s ({100 * lib / r['peak_tops']:.1f}%), "
              f"{r['library_ms']:.4f} ms; the library's best large GEMM {r['ceiling_tops']:.1f} "
              f"T/s ({100 * r['ceiling_tops'] / r['peak_tops']:.1f}%) ({r['card']})", flush=True)
    return rows


def cpu_demo():
    return {f"{label} K={k}": rate_fn(*operands("cpu", TYPES[label][0], k, nd, 2, 2, 64))
            for label in TYPES for k, nd in DEPTHS}


def main(argv=None) -> int:
    return _probe.main(__doc__, variants, cpu_demo, argv, report=run_rates)


if __name__ == "__main__":
    sys.exit(main())
