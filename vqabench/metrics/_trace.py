"""Reduction of a torch.profiler Chrome trace to per-step device numbers.

A frozen copy of the port's profile arithmetic (``group_of`` of the
headline profile tool, ``busy_us`` of its train profile): the benchmark's
yardstick, which a change to the program does not move. Added here: the
device events and the benchmark's own spans of a trace, and the idle gaps
by span.
"""

from __future__ import annotations

from collections import defaultdict

# the port's kernels by the name of their CUDA function
OUR_KERNELS = (("conv0_s2d_i8", "kernel A (conv0_s2d_i8)"), ("conv3x3_i8", "kernel B (conv3x3_i8)"),
               ("conv0_f", "kernel C (conv0_f)"), ("conv3x3_f", "kernel D (conv3x3_f)"),
               ("coatt_", "kernel E (coattention_fwd)"), ("mma_rate", "kernel F (mma_rate)"))
KERNEL_A, KERNEL_B = OUR_KERNELS[0][1], OUR_KERNELS[1][1]
GEMMS, CONVS, COPIES, ELEMENTWISE = ("cuBLAS GEMMs", "cuDNN convolutions and RNNs", "copies",
                                     "elementwise and reductions")
GEMM_OPS = {"aten::mm": "mm", "aten::addmm": "addmm", "aten::bmm": "bmm",
            "aten::baddbmm": "addmm"}
CONV_OPS = ("aten::cudnn_convolution", "aten::convolution_backward", "aten::_cudnn_rnn",
            "aten::_cudnn_rnn_backward")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SPAN_PREFIX = "vqabench."
OUTSIDE = "outside the benchmark's spans"


def group_of(kernel: str, op: str, cat: str) -> str:
    """The op group of a device event: the kernel's name, then its launching
    operator's."""
    if cat in ("gpu_memcpy", "gpu_memset") or kernel.startswith(("Memcpy", "Memset")):
        return COPIES
    for symbol, label in OUR_KERNELS:
        if symbol in kernel:
            return label
    low = kernel.lower()
    if op in CONV_OPS or any(s in low for s in ("cudnn", "conv", "fprop", "dgrad", "wgrad",
                                                "rnn")):
        return CONVS
    if op in GEMM_OPS or "gemm" in low or "cutlass" in low:
        return GEMMS
    return ELEMENTWISE


def busy_us(spans) -> float:
    """Length of the union of [start, end) intervals (device events')."""
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(spans):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def device_events(events: list) -> list:
    """The trace's kernels, copies and memsets."""
    return [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]


def intervals(device: list) -> list[tuple[float, float]]:
    return [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))) for e in device]


def spans(events: list) -> list[tuple[str, float, float]]:
    """The benchmark's own host spans: (name, start us, end us), by start."""
    out = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
           for e in events if e.get("ph") == "X" and str(e.get("name", "")).startswith(SPAN_PREFIX)
           and e.get("cat") in ("user_annotation", "cpu_op", "python_function")]
    return sorted(out, key=lambda s: s[1])


def idle_gaps(events: list) -> dict[str, float]:
    """Microseconds the device sat idle between its first and last event, by
    the innermost benchmark span the host was in at each gap's middle."""
    merged = []
    for s, e in sorted(intervals(device_events(events))):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    host = spans(events)
    out = defaultdict(float)
    for (_, a), (b, _) in zip(merged, merged[1:]):
        mid = (a + b) / 2
        inside = [s for s in host if s[1] <= mid < s[2]]
        out[min(inside, key=lambda s: s[2] - s[1])[0] if inside else OUTSIDE] += b - a
    return dict(out)
