"""What the port's timing probes share: settings, the int8 quantization of
the TPU probes, checks, CUDA-event timing, the card's peaks, bounds and one
JSON line a variant. ``chip_smoke.py`` takes its peaks, bound rule and
timers from here.

A probe module yields :class:`Variant`\\ s, one for each of its functions
that a kernel computes. On the card, :func:`run` first holds the wrapper's
output at the full shape against the plain version: its first and last 2
samples against the plain version on those samples (kernels D and F, whose
plain versions fit at the full shape, every sample), plus any further check
of the variant (kernel F: random integers at the full grid). Then it times
the variant (:func:`time_variant`): the wrapper as a user calls it (``ms``:
for an int8 probe the quantization of x and the weights, as the TPU probe
does it, included), the launch alone on operands prepared outside the timed
call (``launch_ms``), its bound (the larger of the bytes of the launch's
operands, each read or written once, over 3.35 TB/s and its operations over
the published peak of their type), a PyTorch call that computes the same
product as a yardstick (``library_ms``, over the whole batch; where its
operands would pass 8 GB, the sum of its times on slices of 32 samples,
each slice's operands built in turn, the first slice's time kept as
``library_slice_ms``) and, where it fits, the plain version (``plain_ms``). The
last output of the timed wrapper calls and of the timed launches is held to
the plain version as before timing. The counts of launches are zeroed just
before each variant's timed calls and read just after. ``--device cpu``
runs the probe's functions once at a small size through the plain versions
and prints their shapes: no time.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
from typing import Callable

import torch

from .. import _build
from ..ops import conv_hpack
from ..ops.quant import int8_operands

# H100 SXM peaks (NVIDIA's data sheet, dense, 700 W): HBM bytes/s, int8
# tensor-core ops/s, bf16 tensor-core FLOP/s (f32 sums), f32 CUDA-core FLOP/s
HBM_BPS, INT8_OPS, BF16_FLOPS, F32_FLOPS = 3.35e12, 1979e12, 989e12, 67e12
# TF32 tensor-core FLOP/s: an f32-accurate product costs three TF32 MMAs
# (3xTF32), the card's fastest way to kernel C's f32 function
TF32_FLOPS = 494.7e12
LIBRARY_BYTES_LIMIT = 8e9      # a yardstick's operands above this run in slices
LIBRARY_BATCH = 32             # of this many samples
S_X = 4.0 / 127.0              # the TPU probes' static activation scale


def env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, default))


def card_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[0]


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(bytes_moved: float, ops: float, peak: float):
    """(ms, what sets it): the larger of bytes over the memory rate and
    operations over the peak rate for their type."""
    t_bytes, t_ops = bytes_moved / HBM_BPS, ops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def conv3x3(x, w, b, *, s_x=S_X, int8=True, pool=True, s_next=None):
    """The probes' conv3x3 (pad 1) + bias + ReLU (+ 2x2 pool): int8 through
    kernel B (x_q = clip(round(x / s_x)), per-output-channel weights with
    s_w = max(max|w|, 1e-12) / 127, as the TPU probes quantize; a tuple
    ``s_x`` is per input channel, folded into the weights; bf16 out, or int8
    requantized with ``s_next``), else kernel D in x.dtype."""
    if not int8:
        return conv_hpack.conv3x3_f(x, w, b, pool=pool)
    x_q, w_q, scale = int8_operands(x, w, s_x)
    return conv_hpack.int8_conv3x3(x_q, w_q, scale, b.float(), pool=pool, s_next=s_next,
                                   out_dtype=x.dtype)


def cuda_ms(fn, n: int) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def timed(fn, n: int):
    """(mean ms of ``fn`` over ``n`` calls after one warm-up call, what the
    last timed call returned). Each call's output is dropped before the
    next call, as the caller's would be, so that no call allocates anew."""
    fn()
    torch.cuda.synchronize()
    last = []

    def keep():
        last.clear()
        last.append(fn())
    return cuda_ms(keep, n), last[0]


@dataclasses.dataclass
class Slices:
    """A yardstick whose operands would pass ``LIBRARY_BYTES_LIMIT`` at the
    whole batch: ``make(lo, hi)`` builds its call on samples ``lo:hi``; it
    is timed slice by slice (``size`` samples each) and the times summed."""
    batch: int
    size: int
    make: Callable[[int, int], Callable]


def library_call(batch: int, nbytes_at_batch: float, make: Callable[[int, int], Callable]):
    """A yardstick over the whole batch: ``make(0, batch)`` where its
    operands fit in ``LIBRARY_BYTES_LIMIT``, else :class:`Slices` of
    ``LIBRARY_BATCH`` samples."""
    if nbytes_at_batch <= LIBRARY_BYTES_LIMIT:
        return make(0, batch)
    return Slices(batch, LIBRARY_BATCH, make)


def time_library(library, steps: int):
    """(ms of the whole batch's yardstick, ms of its first slice or None)."""
    if not isinstance(library, Slices):
        return timed(library, steps)[0], None
    times = []
    for lo in range(0, library.batch, library.size):
        fn = library.make(lo, min(lo + library.size, library.batch))
        times.append(timed(fn, steps)[0])
        del fn
    return sum(times), times[0]


@dataclasses.dataclass
class Variant:
    """One function of a probe on one kernel mode.

    ``wrapper`` is the probe's function as a user calls it, ``launch`` the
    kernel's launch on prepared operands (both return the output), and
    ``reference(span)`` the plain version on the samples ``span`` of the
    leading axis: (output, per-element tolerance or None for bit-equality).
    ``whole`` says the plain version fits at the full shape, so every
    sample is held to it; ``more_check`` is a further check (returns the
    largest absolute difference, raises where the kernel disagrees).
    ``work`` is (bytes, operations, peak) of the launch, ``library`` a
    yardstick call over the whole batch (a callable, :class:`Slices`, or
    None) described by ``library_note``, ``plain`` the plain version at the
    full shape (or None where it does not fit: the int8 ones sum in
    float64).
    """
    probe: str
    row: str
    name: str
    kernel: _build.CudaKernel
    mode: str
    shape: str
    wrapper: Callable
    launch: Callable
    reference: Callable[[slice], tuple]
    work: tuple
    library: Callable | Slices | None = None
    library_note: str = "none"
    plain: Callable | None = None
    whole: bool = False
    more_check: Callable[[], float] | None = None
    extra: dict = dataclasses.field(default_factory=dict)


def held(label: str, out, ref, tol=None) -> float:
    """Bit-equal (``tol`` None) or within the per-element bound ``tol``;
    returns the largest absolute difference, raises if not held."""
    torch.cuda.synchronize()
    diff = (out.float() - ref.float()).abs()
    ok = torch.equal(out, ref) if tol is None else bool((diff <= tol).all())
    if not ok:
        raise AssertionError(f"{label}: the kernel differs from its plain version "
                             f"(max |diff| {diff.max().item()})")
    return diff.max().item()


class Checker:
    """Holds a variant's outputs at the full shape against its plain
    version: every sample where it fits (``whole``), else the first and the
    last 2 samples, against the plain version on those samples (computed
    once)."""

    def __init__(self, v: Variant):
        self.v, self.refs = v, {}

    def __call__(self, what: str, out) -> float:
        n = out.shape[0]
        spans = [(0, n)] if self.v.whole else [(0, 2), (n - 2, n)]
        err = 0.0
        for lo, hi in spans:
            if (lo, hi) not in self.refs:
                self.refs[lo, hi] = self.v.reference(slice(lo, hi))
            ref, tol = self.refs[lo, hi]
            err = max(err, held(f"{self.v.probe} {self.v.name} {what} [{lo}:{hi}]",
                                out[lo:hi], ref, tol))
        return err


def time_variant(v: Variant, steps: int, check: Checker) -> dict:
    """The variant's times (wrapper, launch alone, yardstick), bound and the
    kernel's launches in its timed calls (counts zeroed just before); the
    last output of the timed wrapper calls and launches held by ``check``."""
    _build.reset_counts()
    ms, out = timed(v.wrapper, steps)
    lms, lout = timed(v.launch, steps)
    torch.cuda.synchronize()
    launches = v.kernel.launches
    others = {k.symbol: k.launches for k in _build.KERNELS if k is not v.kernel and k.launches}
    plain = {k.symbol: k.plain_on_cuda for k in _build.KERNELS if k.plain_on_cuda}
    if launches != 2 * (steps + 1) or others or plain:
        raise AssertionError(f"{v.probe} {v.name}: {launches} launches of {v.kernel.symbol} "
                             f"for {2 * (steps + 1)} calls, others {others}, plain {plain}")
    err = max(check("timed wrapper", out), check("timed launch", lout))
    del out, lout
    lib, lib_slice = time_library(v.library, steps) if v.library is not None else (None, None)
    pms = timed(v.plain, 2)[0] if v.plain is not None else None
    bms, by = bound(*v.work)
    return {"ms": ms, "launch_ms": lms, "bound_ms": bms, "bound_by": by,
            "share_of_bound": bms / lms, "library_ms": lib, "library_slice_ms": lib_slice,
            "library_slice_batch": v.library.size if isinstance(v.library, Slices) else None,
            "plain_ms": pms, "launches": launches, "timed_err": err}


def run(variants, steps: int, card: str) -> list[dict]:
    """Check, then time, each variant; prints and returns one row each.
    ``variants`` may be a generator, so that one variant's operands are
    freed before the next one's are made."""
    rows = []
    for v in variants:
        check = Checker(v)
        err = check("wrapper", v.wrapper())
        if v.more_check is not None:
            err = max(err, v.more_check())
        t = time_variant(v, steps, check)
        row = {"probe": v.probe, "row": v.row, "variant": v.name, "kernel": v.kernel.symbol,
               "mode": v.mode, "shape": v.shape, "max_abs_err": max(err, t.pop("timed_err")),
               **t, "library": v.library_note, **v.extra,
               "card": card}
        rows.append(row)
        print(json.dumps(row), flush=True)
        del v, check
    return rows


def im2col_int_mm(x_q, w_q):
    """(yardstick, note): ``torch._int_mm`` on the im2col matrix of a pad-1
    conv3x3, [B H W, 9 C] x [9 C, O] with a column-major second operand
    (cuBLASLt's int8 tensor-core GEMM): the product alone, int32 out, no
    im2col, pool or epilogue; over the whole batch, in slices of 32 samples
    where the whole batch's operands pass 8 GB."""
    b, h, wd, c = x_q.shape
    o = w_q.shape[-1]
    wmat = w_q.reshape(9 * c, o).t().contiguous().t()

    def make(lo, hi):
        xp = torch.nn.functional.pad(x_q[lo:hi], (0, 0, 1, 1, 1, 1))
        cols = torch.cat([xp[:, ky:ky + h, kx:kx + wd] for ky in range(3) for kx in range(3)],
                         -1).reshape(-1, 9 * c)
        return lambda: torch._int_mm(cols, wmat)
    lib = library_call(b, b * h * wd * (9 * c + 4 * o), make)
    note = f"torch._int_mm on im2col [{b * h * wd}, {9 * c}] x [{9 * c}, {o}]"
    if isinstance(lib, Slices):
        note += f", as {-(-b // lib.size)} GEMMs of {lib.size}-sample slices, summed"
    return lib, note


def cudnn_conv(x, w):
    """(yardstick, note): ``F.conv2d`` (cuDNN, pad 1) on NHWC x and
    HWIO w read as NCHW / OIHW: the conv alone, no bias, ReLU or pool."""
    x_nchw = x.permute(0, 3, 1, 2)
    w_oihw = w.to(x.dtype).permute(3, 2, 0, 1).contiguous()
    return (lambda: torch.nn.functional.conv2d(x_nchw, w_oihw, padding=1),
            "F.conv2d (cuDNN), the conv alone")


def conv3x3_variant(probe, row, name, x, w, b, *, int8, pool, s_x=S_X, s_next=None,
                    operands=None, wrapper=None):
    """A probe's conv3x3 on kernel B (``int8``: x quantized as the TPU
    probes do, bf16 out or int8 with ``s_next``) or D (x.dtype), pooled or
    not. A probe whose input is already int8 (the conv1 hand-off) gives
    ``operands`` = (x_q, w_q, scale) and its own ``wrapper`` (bf16 out)."""
    bsz, h, wd, c = x.shape
    o = w.shape[-1]
    ho, wo = (h // 2, wd // 2) if pool else (h, wd)
    b32 = b.float().contiguous()
    shape = f"[{bsz}, {h}, {wd}, {c}] -> [{bsz}, {ho}, {wo}, {o}]"
    if int8:
        x_q, w_q, scale = operands or int8_operands(x, w, s_x)
        wp = conv_hpack.pack_conv3x3_weights(w_q)
        out_dtype = torch.bfloat16 if operands else x.dtype
        kw = dict(pool=pool, s_next=s_next, out_dtype=out_dtype)
        if wrapper is None:
            def wrapper():
                return conv3x3(x, w, b, s_x=s_x, pool=pool, s_next=s_next)

        def reference(span):
            return conv_hpack.int8_conv3x3_plain(x_q[span].contiguous(), w_q, scale, b32,
                                                 **kw), None

        out_es = 1 if s_next is not None else 2
        moved = nbytes(x_q, w_q, scale, b32) + bsz * ho * wo * o * out_es \
            + (nbytes(s_next) if s_next is not None else 0)
        lib, note = im2col_int_mm(x_q, w_q)
        mode = f"int8 {'pooled' if pool else 'unpooled'}, " \
               f"{'int8 requant' if s_next is not None else 'bf16'} out"
        return Variant(probe, row, name, _build.CONV3X3_I8, mode, shape, wrapper,
                       lambda: conv_hpack.launch_int8_conv3x3(x_q, wp, scale, b32, **kw),
                       reference,
                       (moved, 2.0 * bsz * h * wd * c * o * 9, INT8_OPS), lib, note)
    wp, bias = conv_hpack.conv3x3_f_operands(x, w, b)

    def reference_f(span):
        ref = conv_hpack.conv3x3_f_plain(x[span], w, b, pool)
        return ref, conv_hpack.conv3x3_f_bound(x[span], w, ref, pool)

    moved = nbytes(x, wp, bias) + bsz * ho * wo * o * x.element_size()
    lib, note = cudnn_conv(x, w)
    return Variant(probe, row, name, _build.CONV3X3_F,
                   f"{str(x.dtype).replace('torch.', '')} {'pooled' if pool else 'unpooled'}",
                   shape, lambda: conv_hpack.conv3x3_f(x, w, b, pool),
                   lambda: conv_hpack.launch_conv3x3_f(x, wp, bias, pool), reference_f,
                   (moved, 2.0 * bsz * h * wd * c * o * 9, BF16_FLOPS), lib, note,
                   plain=lambda: conv_hpack.conv3x3_f_plain(x, w, b, pool), whole=True)


def conv_inputs(dev, batch: int, h: int, c: int, o: int, seed: int):
    """The TPU probes' conv inputs, seeded: x = relu(normal) bf16
    [B, H, H, C], w = 0.05 normal f32 [3, 3, C, O], b = 0.1 normal [O]
    (the TPU probes' b is 0; a bias exercises the epilogue)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.relu(torch.randn((batch, h, h, c), generator=g, device=dev)).to(torch.bfloat16)
    w = torch.randn((3, 3, c, o), generator=g, device=dev) * 0.05
    b = torch.randn(o, generator=g, device=dev) * 0.1
    return x, w, b


def _parser(doc: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=doc.splitlines()[0])
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="cuda: check and time the kernels; cpu: the plain versions at a "
                        "small size, no time")
    return p


def main(doc: str, make_variants: Callable, cpu_demo: Callable, argv=None,
         report: Callable | None = None) -> int:
    """A probe's entry point: on the card the variants at the settings
    (``BENCH_BATCH``, ``BENCH_STEPS``, ``EXP_*``), their rows then passed
    to ``report`` if given, else ``cpu_demo()`` (a dict of named outputs)
    at a small size."""
    args = _parser(doc).parse_args(argv)
    if args.device == "cpu":
        for name, out in cpu_demo().items():
            print(json.dumps({"variant": name, "device": "cpu", "shape": list(out.shape),
                              "dtype": str(out.dtype).replace("torch.", ""),
                              "sum": float(out.double().sum())}), flush=True)
        return 0
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu for the plain versions")
    card = card_line()
    print(card, flush=True)
    rows = run(make_variants(torch.device("cuda"), env_int("BENCH_BATCH", 160)),
               env_int("BENCH_STEPS", 10), card)
    if report is not None:
        report(rows)
    return 0
