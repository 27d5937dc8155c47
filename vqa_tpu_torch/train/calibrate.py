"""Static int8 activation calibration (port of vqa_tpu/train/calibrate.py).

One pass over N image batches records each int8 stage's per-input-channel
input amax (``VGGFeatures.forward(x, quant_stats=...)``, the counterpart of
the mutable ``quant_stats`` collection); the per-stage values become the
model's ``int8_amax``. The ``int8_calib.json`` sidecar format is the JAX
package's, so sidecars written by either package load in both. A file keyed
by model name (``tools/bench_calib.json``) reads through
:func:`load_calib_file`.
"""

from __future__ import annotations

import json
import os

import numpy as np

CALIB_FILE = "int8_calib.json"


def image_tower(model_name: str, model):
    """The model's frozen conv stack, whose int8 stages need calibration:
    for baseline and bert the VGG without its classifier head
    (vqa_tpu/train/calibrate.py:63-78). Every family exposes it as
    ``model.vgg``."""
    return model.vgg


def collect_amax(enc, image_batches) -> dict[int, np.ndarray]:
    """Per-stage per-input-channel amax over preprocessed image batches.

    Runs the encoder with its current scale mode (dynamic during a fresh
    calibration); the record is a running max across batches.
    """
    qs: dict = {}
    n = 0
    for x in image_batches:
        enc(x, quant_stats=qs)
        n += 1
    if n == 0:
        raise ValueError("int8 calibration: no batches provided")
    return {k: v.cpu().numpy().astype(np.float32) for k, v in qs.items()}


def amax_tuple(int8_stages: tuple, amax_by_stage: dict) -> tuple:
    """Order the collected amax values along the model's stage tuple."""
    missing = [s for s in int8_stages if s not in amax_by_stage]
    if missing:
        raise ValueError(f"int8 calibration missed stages {missing} "
                         f"(collected {sorted(amax_by_stage)})")
    return tuple(tuple(float(v) for v in np.ravel(amax_by_stage[s]))
                 for s in int8_stages)


def save_calib(log_dir: str, int8_stages: tuple, int8_amax: tuple) -> str:
    path = os.path.join(log_dir, CALIB_FILE)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump({"stages": list(int8_stages),
                   "amax": [list(a) if isinstance(a, tuple) else a
                            for a in int8_amax]}, f)
    os.replace(tmp, path)
    return path


def _amax_from_entry(data: dict) -> tuple:
    return tuple(tuple(float(x) for x in v) if isinstance(v, list)
                 else float(v) for v in data["amax"])


def load_calib(log_dir: str, int8_stages: tuple) -> tuple | None:
    """Stored amax tuple for this stage set, or None (absent / stale set)."""
    path = os.path.join(log_dir, CALIB_FILE)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        data = json.load(f)
    if tuple(data.get("stages", ())) != tuple(int8_stages):
        return None
    return _amax_from_entry(data)


def load_calib_file(path: str, int8_stages: tuple, model_name: str) -> tuple:
    """An explicitly named sidecar: the ``int8_calib.json`` format, or a file
    keyed by model name holding that format (``tools/bench_calib.json``).

    Unlike the checkpoint sidecar, a file that does not match the active
    stage set is an error: wrong static scales are worse than none."""
    with open(path) as f:
        data = json.load(f)
    if "stages" not in data and model_name in data:
        data = data[model_name]
    stages = tuple(data.get("stages", ()))
    if stages != tuple(int8_stages):
        raise ValueError(
            f"--calib_file {path} was calibrated for int8 stages {stages}, but "
            f"the model runs {tuple(int8_stages)}; re-calibrate or pass a "
            f"matching --int8_stages")
    return _amax_from_entry(data)


def calibrate_model(model_name: str, model, preprocess, host_batches,
                    log_dir: str | None = None, log=print):
    """Calibrate ``model``'s int8 stages in place and return it.

    ``host_batches``: iterable of host uint8 image arrays [B, S, S, 3];
    ``preprocess`` maps one to the device-ready float batch. Writes the
    sidecar when ``log_dir`` is given. No-op without int8 stages.
    """
    if not model.int8_stages:
        return model
    enc = image_tower(model_name, model)
    batches = (preprocess(b) for b in host_batches)
    amax = amax_tuple(model.int8_stages, collect_amax(enc, batches))
    log(f"int8 calibration: stages {model.int8_stages} -> per-channel amax "
        f"(max) {tuple(round(max(a), 4) for a in amax)}")
    if log_dir is not None:
        save_calib(log_dir, model.int8_stages, amax)
    model.int8_amax = amax
    return model
