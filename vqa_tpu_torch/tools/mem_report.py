"""Device memory of the production configurations at b160, and batch headroom.

Port of tools/mem_report.py. PyTorch has no memory analysis ahead of time,
so each configuration runs one real step: forward, backward and Adam for
``train``, the forward for ``eval``, after a warm-up step, with the peak
counters reset just before (``torch.cuda.reset_peak_memory_stats``). Full
width: vocabulary 10,000, K = 1001, question length 23, seeded weights;
int8 configurations calibrate static scales first on 8 seeded random
images, as the production path bakes them.

Per configuration: ``max_memory_allocated`` (``peak_gib``: what the step's
tensors need, the model and Adam's state included), ``max_memory_reserved``
(what the caching allocator held), the card's total memory
(``torch.cuda.mem_get_info``) and the share of it the peak takes. A second
point at b32 gives the batch headroom, taken as linear in the batch:
bytes a sample = (peak at b160 - peak at b32) / 128, and the largest batch
whose peak fits in the card's total. The kernels' launches in the b160
step are checked: after calibration an int8 forward launches kernel A once
and kernel B 7 times, a float forward kernel C once.

    python -m vqa_tpu_torch.tools.mem_report                 # every configuration
    python -m vqa_tpu_torch.tools.mem_report attention_bf16  # one by name

One JSON line a configuration; the table goes to stderr.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys

import torch

GIB = 1024 ** 3
LOW_BATCH = 32          # the second point of the headroom line

CONFIGS = {
    # name: (model, image_size, batch, int8_backbone, mode)
    "attention_default": ("attention", 448, 160, None, "train"),
    "attention_bf16": ("attention", 448, 160, False, "train"),
    "attention_eval": ("attention", 448, 160, None, "eval"),
    "baseline_default": ("baseline", 224, 160, None, "train"),
}


def headroom(peak_hi: float, peak_lo: float, batch_hi: int, batch_lo: int,
             total: float) -> dict:
    """The line through two (batch, peak bytes) points: bytes a sample, the
    bytes at batch 0 and the largest batch whose peak fits in ``total``."""
    per_sample = (peak_hi - peak_lo) / (batch_hi - batch_lo)
    fixed = peak_hi - per_sample * batch_hi
    max_batch = int((total - fixed) // per_sample) if per_sample > 0 else None
    return {"per_sample_mib": per_sample / 2 ** 20, "fixed_gib": fixed / GIB,
            "max_batch": max_batch}


def step_peak(name: str, batch: int, device: torch.device, image_size: int | None = None):
    """(peak allocated, peak reserved, launches) of one step of ``name`` at
    ``batch``, the model built, calibrated and warmed up first."""
    from .. import _build
    from ._run import full_width_step, sync

    model_name, size, _, int8, mode = CONFIGS[name]
    gc.collect()            # the previous configuration's tensors are gone
    if device.type == "cuda":
        torch.cuda.empty_cache()
    model, step = full_width_step(model_name, image_size or size, batch, mode, device, int8)
    step()                  # warm-up: Adam's moments, cuBLAS/cuDNN workspaces
    sync(device)
    _build.reset_counts()
    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    loss = float(step())
    sync(device)
    launches = {k.symbol: k.launches for k in _build.KERNELS if k.launches}
    peaks = ((torch.cuda.max_memory_allocated(device), torch.cuda.max_memory_reserved(device))
             if on_card else (None, None))
    if loss != loss:
        raise AssertionError(f"{name}: the b{batch} step's loss is not finite")
    expect = ({"conv0_s2d_i8": 1, "conv3x3_i8": 7} if model.int8_stages
              else {"conv0_f": 1})
    if on_card and launches != expect:
        raise AssertionError(f"{name}: the step launched {launches}, expected {expect}")
    return (*peaks, launches)


def analyze(name: str, device: torch.device, image_size: int | None = None) -> dict:
    model_name, _, batch, _, mode = CONFIGS[name]
    peak, reserved, launches = step_peak(name, batch, device, image_size)
    peak_lo, _, _ = step_peak(name, LOW_BATCH, device, image_size)
    rec = {"config": name, "mode": mode, "batch": batch, "model": model_name,
           "launches": launches}
    if device.type == "cuda":
        total = torch.cuda.mem_get_info(device)[1]
        rec.update({"peak_gib": peak / GIB, "reserved_gib": reserved / GIB,
                    "total_gib": total / GIB, "hbm_fraction": peak / total,
                    f"peak_gib_b{LOW_BATCH}": peak_lo / GIB,
                    **headroom(peak, peak_lo, batch, LOW_BATCH, total)})
    print(json.dumps(rec), flush=True)
    return rec


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("names", nargs="*", help=f"configurations of {list(CONFIGS)} "
                                             f"(default: all)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) needs a card; cpu rehearses the steps (no "
                         "memory numbers)")
    ap.add_argument("--image_size", type=int, help="override (CPU rehearsal only)")
    args = ap.parse_args(argv)
    unknown = [n for n in args.names if n not in CONFIGS]
    if unknown:
        ap.error(f"unknown configurations {unknown}; choose from {list(CONFIGS)}")
    from ._run import device_and_card

    device, card = device_and_card(args.device)
    print(card, flush=True)
    rows = [{**analyze(n, device, args.image_size), "card": card}
            for n in (args.names or list(CONFIGS))]
    if device.type != "cuda":
        return rows
    w = max(len(r["config"]) for r in rows)
    print(f"{'config':<{w}}  {'batch':>5}  {'peak GiB':>9}  {'reserved':>9}  "
          f"{'of total':>8}  {'max batch':>9}", file=sys.stderr)
    for r in rows:
        print(f"{r['config']:<{w}}  {r['batch']:>5}  {r['peak_gib']:>9.3f}  "
              f"{r['reserved_gib']:>9.3f}  {r['hbm_fraction']:>8.3f}  {r['max_batch']:>9}",
              file=sys.stderr)
    return rows


if __name__ == "__main__":
    main()
