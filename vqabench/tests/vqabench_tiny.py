"""Small sizes of the benchmark's cells for the CPU tests: the published
widths, with a 64x64 image, batch 4, a vocabulary of 100 words and 11
answer classes."""

from __future__ import annotations

import copy

import torch

from vqabench import harness

SIZES = {"image_size": 64, "vocab_size": 100, "num_classes": 11}


def tiny_cell(name: str, opt_lvl: int | None = None, limits: dict | None = None,
              batch: int = 4) -> harness.Cell:
    bench = harness.load_benchmark()
    w = next(w for w in bench["workloads"] if w["name"] == name)
    cfg = copy.deepcopy(harness.load_json(harness.BENCH, "configs", f"{w['config']}.json"))
    tr = copy.deepcopy(harness.load_json(harness.BENCH, "traffic", f"{w['traffic']}.json"))
    cfg.update(SIZES)
    if opt_lvl is not None:
        cfg["opt_lvl"] = opt_lvl
    tr.update(batch=batch, trace_steps=2)
    return harness.cell(bench, name, config=cfg, traffic=tr, limits=limits)


def cpu_threads() -> None:
    torch.set_num_threads(4)
