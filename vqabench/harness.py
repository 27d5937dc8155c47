"""One run of one cell: find its files by name, set up, measure, check,
and build the result.

Everything of a cell is found by the names in ``BENCHMARK.json``:

- ``configs/<config>.json``: the model configuration as it is run;
- ``traffic/<traffic>.json``: the traffic mix's parameters, whose
  ``loop`` names ``traffic/<loop>.py``, the general loop of its kind;
- ``limits/<workload>.json``: the limit of each number the check compares;
- ``metrics/<metric>.py``: one reader a per-layer metric.
"""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass

import torch

from . import judge, tracing

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
OUT = os.path.join(ROOT, "build", "vqabench")


def load_json(*parts: str) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """``vqabench/<kind>/<name>.py``, loaded by its path (names may hold dots)."""
    path = os.path.join(BENCH, kind, f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"vqabench.{kind}.{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list


def reports(metric: dict, cell: str) -> bool:
    """Whether ``cell`` reports ``metric``: listed under its ``workloads``; an
    end-to-end metric without that key is reported everywhere, and every
    per-layer metric names its cells."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    if "moves" in metric:
        raise SystemExit(f"per-layer metric {metric['name']!r} lists no workloads")
    return True


def cell(bench: dict, name: str, config: dict | None = None, traffic: dict | None = None,
         limits: dict | None = None) -> Cell:
    """The cell ``name`` of ``bench``; ``config``/``traffic``/``limits`` replace
    its files (a test's small sizes)."""
    w = next((w for w in bench["workloads"] if w["name"] == name), None)
    if w is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    return Cell(name=name, chips=w["chips"],
                config=load_json(BENCH, "configs", f"{w['config']}.json")
                if config is None else config,
                traffic=load_json(BENCH, "traffic", f"{w['traffic']}.json")
                if traffic is None else traffic,
                limits=load_json(BENCH, "limits", f"{name}.json") if limits is None else limits,
                end_to_end=[m for m in bench["end_to_end"] if reports(m, name)],
                per_layer=[m for m in bench["per_layer"] if reports(m, name)])


def load_benchmark() -> dict:
    return load_json(ROOT, "BENCHMARK.json")


def fix_caches() -> None:
    """Kernel caches of the libraries under the checkout, at fixed paths (the
    port's own nvcc builds go to ``build/vqa_tpu_torch`` there)."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"), ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(ROOT, "build", "vqabench", "cache", sub)


def device_kind(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def execute(c: Cell, seed: int, seconds: float, trace: bool, device, t0: float) -> dict:
    """Set up, measure for ``seconds``, trace if asked, check; the result's
    fields, the numbers the cell reads but does not compare
    (``not_compared``), and the compared numbers with their limits last
    (``checks``)."""
    device = torch.device(device)
    loop = load_module("traffic", c.traffic["loop"]).Loop(c, seed, device)
    loop.setup()
    timing = loop.window(seconds)
    e2e = {**timing["metrics"], "setup_s": timing["start"] - t0}
    metrics, extra, dev = {}, {}, {}
    if trace:
        out_dir = os.path.join(OUT, c.name)
        events, window_s = loop.traced(c.traffic["trace_steps"], out_dir)
        ctx = tracing.TraceContext(
            events=events, steps=c.traffic["trace_steps"], window_s=window_s,
            wall_s_per_step=timing["seconds"] / timing["steps"], config=c.config,
            batch=loop.batch, kind=loop.kind, window_peak_bytes=timing["window_peak_bytes"],
            host_spans=timing["host_spans"])
        for m in c.per_layer:
            value = load_module("metrics", m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev = {"busy_s": tracing.busy_s(events), "window_s": window_s}
        extra["breakdown"] = tracing.breakdown(events)
    else:
        for m in c.end_to_end:
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    loop.release()
    numbers = loop.numbers(loop.outputs, loop.reference())
    correct = judge.verdict(numbers, c.limits) and timing["failed"] == 0
    return {"correct": correct, "attempted": timing["attempted"], "failed": timing["failed"],
            "metrics": metrics,
            "device": {"platform": "gpu" if device.type == "cuda" else device.type,
                       "kind": device_kind(device), "count": c.chips,
                       "memory_peak_bytes": peak, **dev},
            **extra,
            "not_compared": {k: v for k, v in numbers.items() if k not in c.limits},
            "checks": {k: {"value": numbers.get(k), "limit": lim["limit"]}
                       for k, lim in c.limits.items()}}
