"""Device profile and roofline of the headline step, from a torch.profiler trace.

Port of tools/profile_headline.py. The headline configuration: attention at
448², b160 (``BENCH_BATCH``), the int8 route with static calibrated scales
(from 8 seeded random images; kernels A and B), seeded weights at full
width (vocabulary 10,000, K = 1001, question length 23). ``BENCH_MODE=eval``
traces the eval step instead of the train step. After 2 warm-up steps,
``PROFILE_STEPS`` (5) steps run without the profiler (the wall time a
step), then as many under ``torch.profiler`` (CPU and CUDA activities,
shapes and FLOPs recorded); the Chrome trace goes to ``PROFILE_OUT``
(``build/vqa_profile``) and is reduced to the JAX tool's two outputs:

- ``profile_table.md``: the step's device time by op group (kernels A and
  B by name, cuBLAS GEMMs, cuDNN convolutions and RNNs, elementwise and
  reductions, copies): ms, GFLOP, MB, TF/s and GB/s a step, and a roofline
  verdict per group against the H100's published peaks (``_probe``): the
  floor is the larger of bytes over 3.35 TB/s and operations over the peak
  of their type; "at floor" within 1.25x of it, else the headroom in ms;
- ``profile_ops.json``: every group and every kernel name, the step's wall
  time, the device's busy time (the union of its kernel and copy
  intervals) and its idle share of the wall time without the profiler.

Operations come from torch.profiler's own FLOP count (``with_flops``) where
it has one: most GEMMs (``aten::mm``, ``addmm``, ``bmm``, ``baddbmm``),
``aten::conv2d`` (which a cuDNN kernel's operator lies under), ``aten::add``
and ``aten::mul``. The trace counts no bytes, and no operations for kernels
A and B, the head's ``conv1d`` phrase convolutions, convolution backwards
or the other operators, so those are counted from shapes: A and B from the
VGG stages' shapes at this batch, as ``_probe.bound`` counts them (per
forward: A once, B for conv1-7); the rest from the launching operator's
recorded input shapes and types (``record_shapes``); copies from the
trace's bytes. ``profile_ops.json`` names the rules of each group.

    python -m vqa_tpu_torch.tools.profile_headline
    BENCH_MODE=eval python -m vqa_tpu_torch.tools.profile_headline
    PROFILE_STEPS=10 PROFILE_OUT=build/prof python -m vqa_tpu_torch.tools.profile_headline
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time
from collections import defaultdict

import torch

from ..profile_train import busy_us
from ._probe import BF16_FLOPS, F32_FLOPS, HBM_BPS, INT8_OPS

# the port's kernels by the name of their CUDA function
OUR_KERNELS = (("conv0_s2d_i8", "kernel A (conv0_s2d_i8)"), ("conv3x3_i8", "kernel B (conv3x3_i8)"),
               ("conv0_f", "kernel C (conv0_f)"), ("conv3x3_f", "kernel D (conv3x3_f)"),
               ("coatt_", "kernel E (coattention_fwd)"), ("mma_rate", "kernel F (mma_rate)"))
GEMMS, CONVS, COPIES, ELEMENTWISE = ("cuBLAS GEMMs", "cuDNN convolutions and RNNs", "copies",
                                     "elementwise and reductions")
GEMM_OPS = {"aten::mm": "mm", "aten::addmm": "addmm", "aten::bmm": "bmm",
            "aten::baddbmm": "addmm"}
CONV_OPS = ("aten::cudnn_convolution", "aten::convolution_backward", "aten::_cudnn_rnn",
            "aten::_cudnn_rnn_backward")
ITEMSIZE = {"float": 4, "c10::BFloat16": 2, "c10::Half": 2, "double": 8, "long int": 8,
            "int": 4, "signed char": 1, "unsigned char": 1, "bool": 1}
AT_FLOOR = 1.25


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


def _numel(dims) -> int:
    return math.prod(dims) if dims else 1


def counted_flops(fn_events) -> dict:
    """Operator id (a trace event's "External id") -> (id, FLOPs) of the
    operator that torch.profiler's ``with_flops`` counted, the operator
    itself or the nearest above it: a kernel of aten::conv2d's
    cudnn_convolution finds conv2d's count."""
    out = {}
    for e in fn_events:
        owner = e
        while owner is not None and not owner.flops:
            owner = owner.cpu_parent
        if owner is not None:
            out[e.id] = (owner.id, float(owner.flops))
    return out


def op_work(op: str, dims: list, types: list) -> tuple[float, float, str]:
    """(operations, bytes, their type) of one operator call from its input
    shapes and types, for the operators that :func:`counted_flops` does not
    count: a GEMM 2 M N K; a convolution 2 x output elements x C_in / groups
    x taps, its backward twice that (input and weight gradients); anything
    else one operation an element of its largest input. Bytes: the inputs
    read once and an output written once (the product's, or shaped as the
    largest input)."""
    # tensor arguments (a list of tensors, e.g. aten::cat's, records a list of shapes)
    shapes = [(d, t) for d, t in zip(dims, types)
              if isinstance(d, list) and d and t not in ("Scalar", "ScalarList")]
    tensors = [(s, t) for d, t in shapes
               for s in ([d] if all(isinstance(x, int) for x in d) else d)
               if isinstance(s, list) and s and all(isinstance(x, int) for x in s)]
    if not tensors:
        return 0.0, 0.0, ""
    sizes = [_numel(d) * ITEMSIZE.get(t, 4) for d, t in tensors]
    kind = GEMM_OPS.get(op)
    if kind and len(tensors) >= 2:
        (a, t_a), (b, _) = tensors[-2], tensors[-1]
        m, k, n = _numel(a[:-1]), a[-1], b[-1]
        return 2.0 * m * n * k, float(sum(sizes) + m * n * ITEMSIZE.get(t_a, 4)), t_a
    if op == "aten::cudnn_convolution" and len(tensors) >= 2:      # (input, weight)
        (x, t_x), (w, _) = tensors[0], tensors[1]
        out = _numel(x) // x[1] * w[0]
        return 2.0 * out * _numel(w[1:]), float(sum(sizes) + out * ITEMSIZE.get(t_x, 4)), t_x
    if op == "aten::convolution_backward" and len(tensors) >= 3:   # (grad_out, input, weight)
        (go, t_go), w = tensors[0], tensors[2][0]
        return 4.0 * _numel(go) * _numel(w[1:]), float(sum(sizes) + sizes[1] + sizes[2]), t_go
    return float(max(_numel(d) for d, _ in tensors)), float(sum(sizes) + max(sizes)), \
        tensors[0][1]


def vgg_int8_work(batch: int, image_size: int) -> dict:
    """Kernel A's and B's (operations, bytes) a forward of the int8 VGG with
    the fused stem and hand-offs, counted as ``_probe.bound`` counts a
    launch: A reads the quantized x and writes conv1's int8 input; B reads
    its int8 input and writes int8 (the hand-off) or, at conv7, bf16."""
    from ..models.vgg import VGG11_CFG

    chans = [v for v in VGG11_CFG if v != "M"]
    pools = [i + 1 < len(VGG11_CFG) and VGG11_CFG[i + 1] == "M"
             for i, v in enumerate(VGG11_CFG) if v != "M"]
    h, c = image_size, 3
    work = {"A": [0.0, 0.0], "B": [0.0, 0.0]}
    for i, (o, pool) in enumerate(zip(chans, pools)):
        ho = h // 2 if pool else h
        ops = 2.0 * batch * h * h * c * o * 9
        out_bytes = batch * ho * ho * o * (2 if i == len(chans) - 1 else 1)
        moved = batch * h * h * c + 9 * c * o + 12 * o + out_bytes  # int8 in, scales
        key = "A" if i == 0 else "B"
        work[key][0] += ops
        work[key][1] += moved
        h, c = ho, o
    return {k: tuple(v) for k, v in work.items()}


def reduce_trace(events: list, steps: int, wall_ms: float, vgg_work: dict | None,
                 flops: dict) -> dict:
    """Chrome-trace events of ``steps`` profiled steps and the profiler's
    FLOP counts (:func:`counted_flops`) -> the groups' rows, the kernel
    names' rows and the device's busy time and idle share."""
    ops = {e["args"]["External id"]: e for e in events
           if e.get("cat") == "cpu_op" and "External id" in e.get("args", {})}
    device = [e for e in events if e.get("ph") == "X" and e.get("cat") in
              ("kernel", "gpu_memcpy", "gpu_memset")]
    groups = defaultdict(lambda: {"us": 0.0, "calls": 0, "ops": 0.0, "bytes": 0.0,
                                  "dtypes": defaultdict(float), "counted": set()})
    kernels = defaultdict(lambda: {"us": 0.0, "calls": 0, "group": ""})
    counted_ops, counted_owners = set(), set()
    for e in device:
        args = e.get("args", {})
        op = ops.get(args.get("External id"), {})
        g_name = group_of(e.get("name", ""), op.get("name", ""), e["cat"])
        g = groups[g_name]
        g["us"] += float(e.get("dur", 0))
        g["calls"] += 1
        k = kernels[e.get("name", "")[:120]]
        k["us"] += float(e.get("dur", 0))
        k["calls"] += 1
        k["group"] = g_name
        if g_name == COPIES:
            g["bytes"] += float(args.get("bytes", 0))
            g["counted"].add("the trace's copy bytes")
        elif g_name.startswith("kernel "):
            continue            # counted from the VGG's shapes below
        elif op and "Input Dims" in op.get("args", {}) \
                and id(op) not in counted_ops:         # an operator's work counted once
            counted_ops.add(id(op))
            n_ops, n_bytes, dtype = op_work(op["name"], op["args"]["Input Dims"],
                                            op["args"].get("Input type", []))
            owner = flops.get(args.get("External id"))
            if owner is None:
                g["counted"].add("operations: the launching operators' recorded shapes")
            elif owner[0] in counted_owners:
                n_ops = 0.0
            else:
                counted_owners.add(owner[0])
                n_ops = owner[1]
                g["counted"].add("operations: torch.profiler's FLOP count")
            g["ops"] += n_ops
            g["bytes"] += n_bytes
            g["dtypes"][dtype] += n_ops
            g["counted"].add("bytes: the launching operators' recorded shapes")
    for key, label in (("A", OUR_KERNELS[0][1]), ("B", OUR_KERNELS[1][1])):
        if vgg_work and label in groups:
            g = groups[label]
            per_forward = 1 if key == "A" else 7
            g["ops"] = vgg_work[key][0] * g["calls"] / per_forward
            g["bytes"] = vgg_work[key][1] * g["calls"] / per_forward
            g["dtypes"]["signed char"] = g["ops"]
            g["counted"].add("the VGG stages' shapes (_probe.bound's rule)")
    rows = []
    for name, g in groups.items():
        ms, n_ops, n_bytes = g["us"] / 1e3 / steps, g["ops"] / steps, g["bytes"] / steps
        dtype = max(g["dtypes"], key=g["dtypes"].get) if g["dtypes"] else ""
        peak = INT8_OPS if ITEMSIZE.get(dtype) == 1 else \
            F32_FLOPS if dtype == "float" else BF16_FLOPS
        floor_ops, floor_bytes = n_ops / peak * 1e3, n_bytes / HBM_BPS * 1e3
        floor = max(floor_ops, floor_bytes)
        rows.append({
            "group": name, "calls": g["calls"] / steps, "ms": ms, "gflop": n_ops / 1e9,
            "mb": n_bytes / 1e6, "tf_s": n_ops / ms / 1e9 if ms else 0.0,
            "gb_s": n_bytes / ms / 1e6 if ms else 0.0, "dtype": dtype,
            "peak": peak, "floor_ms": floor,
            "bound": "operations" if floor_ops >= floor_bytes else "bytes",
            "verdict": ("not counted" if not (n_ops or n_bytes) else
                        "at floor" if ms <= AT_FLOOR * floor else
                        f"headroom {ms - floor:.3f} ms"),
            "counted_from": sorted(g["counted"])})
    rows.sort(key=lambda r: -r["ms"])
    busy = busy_us((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
                   for e in device) / 1e3
    return {"steps": steps, "wall_ms_per_step": wall_ms / steps,
            "device_busy_ms_per_step": busy / steps,
            "device_idle_share": 1.0 - busy / wall_ms if wall_ms else None,
            "groups": rows,
            "kernels": sorted(({"kernel": k, **v, "ms": v["us"] / 1e3 / steps}
                               for k, v in kernels.items()), key=lambda r: -r["ms"])}


def table(report: dict, mode: str, batch: int, card: str) -> str:
    lines = [f"## Headline device profile ({mode} b{batch}@448, {report['steps']} traced "
             f"steps; {card})", "",
             f"- wall time a step {report['wall_ms_per_step']:.3f} ms "
             f"({report['profiled_ms_per_step']:.3f} ms under the profiler), device busy "
             f"{report['device_busy_ms_per_step']:.3f} ms, idle share "
             f"{report['device_idle_share']:.3f}", "",
             "| op group | calls | ms | GFLOP | MB | TF/s | GB/s | bound | floor ms | verdict |",
             "|---|---|---|---|---|---|---|---|---|---|"]
    for r in report["groups"]:
        lines.append(f"| {r['group']} | {r['calls']:.1f} | {r['ms']:.3f} | {r['gflop']:.1f} | "
                     f"{r['mb']:.1f} | {r['tf_s']:.1f} | {r['gb_s']:.0f} | {r['bound']} | "
                     f"{r['floor_ms']:.3f} | {r['verdict']} |")
    return "\n".join(lines)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--image_size", type=int, default=448,
                    help="smaller only to rehearse on the CPU")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) needs a card; cpu rehearses the trace (no device "
                         "events)")
    args = ap.parse_args(argv)
    from .. import _build
    from ._run import device_and_card, full_width_step, sync

    device, card = device_and_card(args.device)
    print(card, flush=True)
    steps = int(os.environ.get("PROFILE_STEPS", 5))
    out_dir = os.environ.get("PROFILE_OUT", os.path.join("build", "vqa_profile"))
    mode = os.environ.get("BENCH_MODE", "train")
    batch = int(os.environ.get("BENCH_BATCH", 160 if device.type == "cuda" else 2))
    model, step = full_width_step("attention", args.image_size, batch, mode, device)
    t0 = time.perf_counter()
    float(step())
    print(f"# first step: {time.perf_counter() - t0:.2f} s", flush=True)
    float(step())
    sync(device)
    t0 = time.perf_counter()            # the wall time without the profiler's cost
    for _ in range(steps):
        loss = step()
    float(loss)
    sync(device)
    wall_ms = 1e3 * (time.perf_counter() - t0)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    _build.reset_counts()
    with torch.profiler.profile(activities=acts, record_shapes=True, with_flops=True) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            loss = step()
        float(loss)
        sync(device)
        profiled_ms = 1e3 * (time.perf_counter() - t0)
    launches = {k.symbol: k.launches / steps for k in _build.KERNELS if k.launches}
    os.makedirs(out_dir, exist_ok=True)
    trace = os.path.join(out_dir, "trace.json")
    prof.export_chrome_trace(trace)
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    work = vgg_int8_work(batch, args.image_size) if model.int8_stages else None
    report = {"mode": mode, "batch": batch, "card": card, "launches_per_step": launches,
              "profiled_ms_per_step": profiled_ms / steps,
              **reduce_trace(events, steps, wall_ms, work, counted_flops(prof.events()))}
    md = table(report, mode, batch, card)
    with open(os.path.join(out_dir, "profile_table.md"), "w") as f:
        f.write(md + "\n")
    with open(os.path.join(out_dir, "profile_ops.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(md)
    print(f"# wrote {out_dir}/profile_table.md and profile_ops.json", flush=True)
    return report


if __name__ == "__main__":
    main()
