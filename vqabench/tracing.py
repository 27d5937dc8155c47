"""The traced part of a run: a few steps under torch.profiler, and what the
per-layer readers and the result's breakdown read from it."""

from __future__ import annotations

import json
import os
import time
from collections import defaultdict
from dataclasses import dataclass, field

import torch

from .metrics import _trace


@dataclass
class TraceContext:
    """What a per-layer reader reads: the trace of ``steps`` steps (or
    batches); from the measured window before it, without the profiler, the
    wall time a step took and the host seconds a step spent in each of the
    benchmark's timed spans (``host_spans``); the cell's configuration,
    batch and kind ("train" or "serve"), and the device memory allocated at
    most in the measured window."""
    events: list
    steps: int
    window_s: float
    wall_s_per_step: float
    config: dict
    batch: int
    kind: str
    window_peak_bytes: int = 0
    host_spans: dict = field(default_factory=dict)


class Phases:
    """Prints the seconds each phase of a set-up took, as it ends."""

    def __init__(self):
        self.t = time.perf_counter()

    def __call__(self, name: str) -> None:
        now = time.perf_counter()
        print(f"# set-up: {name} {now - self.t:.3f} s", flush=True)
        self.t = now


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def profile(step, steps: int, out_dir: str, device):
    """Run ``step(i)`` for i < ``steps`` under torch.profiler (CPU and CUDA
    activities, shapes recorded) and then synchronise.

    Returns (Chrome-trace events, the traced window's seconds); the trace
    is written to ``out_dir/trace.json``."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts, record_shapes=True) as prof:
        t0 = time.perf_counter()
        for i in range(steps):
            step(i)
        sync(device)
        window_s = time.perf_counter() - t0
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return events, window_s


def busy_s(events: list) -> float:
    """Seconds in which a kernel or copy ran on the device."""
    return _trace.busy_us(_trace.intervals(_trace.device_events(events))) / 1e6


def breakdown(events: list, top: int = 10) -> dict:
    """The device operations that took the most time (seconds over the
    traced steps, by kernel name) and the device's idle seconds by the
    benchmark span the host was in."""
    by_kernel = defaultdict(float)
    for e in _trace.device_events(events):
        by_kernel[str(e.get("name", ""))[:120]] += float(e.get("dur", 0)) / 1e6
    gaps = {k: v / 1e6 for k, v in _trace.idle_gaps(events).items()}
    def largest(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
    return {"device_ops": largest(by_kernel), "idle_gaps": largest(gaps)}
