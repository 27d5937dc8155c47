"""Seeded weights in the reference's state-dict layout, made on the device.

Every float entry comes from one normal and one uniform draw of a
``torch.Generator`` on ``device`` (two calls for the whole model), cut into
the entries and scaled. The tower's convs are Kaiming-normal (fan in, so
activations keep their scale through the stack), BatchNorm's affine
parameters and running statistics are drawn around (1, 0), (0, 1), the
variances positive, and ``num_batches_tracked`` is 0.

The scales are chosen so that the check is well conditioned, as a trained
model is: the head's pre-activations about unit size, not saturated, and
the logits moved by both the image and the question. With the default
initializations (embeddings N(0, 1), U(+-1/sqrt(fan_in)) elsewhere) the
co-attention's tanh saturates, so a gradient norm swings by tens of
percent when the tower's output moves by one percent, and the baseline's
logits hardly see the image.
"""

from __future__ import annotations

import importlib

import torch

from .tower import CHANNELS, CONV_INDEX

# the last BatchNorm's affine scale: the tower's output at about 0.4 rms
# instead of 2.6, so that the co-attention's affinities are not saturated
LAST_SCALE = 0.15


def model_module(name: str):
    """``vqabench.reference.<name>``: the reference of one model family."""
    return importlib.import_module(f"{__package__}.{name}")


def tower_layout(prefix: str) -> list[tuple[str, tuple, str, float]]:
    out, c_in = [], 3
    for conv, o in zip(CONV_INDEX, CHANNELS):
        bn = f"{prefix}{conv + 1}."
        last = LAST_SCALE if conv == CONV_INDEX[-1] else 1.0
        out += [(f"{prefix}{conv}.weight", (o, c_in, 3, 3), "normal", (2.0 / (9 * c_in)) ** 0.5),
                (f"{prefix}{conv}.bias", (o,), "uniform", 0.05),
                (bn + "weight", (o,), "uniform", (0.8 * last, 1.2 * last)),
                (bn + "bias", (o,), "uniform", 0.1 * last),
                (bn + "running_mean", (o,), "uniform", 0.1),
                (bn + "running_var", (o,), "uniform", (0.5, 1.5)),
                (bn + "num_batches_tracked", (), "count", 0.0)]
        c_in = o
    return out


def layout(cfg: dict) -> list[tuple[str, tuple, str, float]]:
    m = model_module(cfg["model"])
    return tower_layout(m.TOWER_PREFIX) + m.layout(cfg)


def make(cfg: dict, seed: int, device) -> dict:
    """The state dict of ``cfg``'s model from ``seed``, float32 on ``device``."""
    entries = layout(cfg)
    g = torch.Generator(device=device).manual_seed(seed)
    size = {kind: sum(torch.Size(shape).numel() for _, shape, k, _ in entries if k == kind)
            for kind in ("normal", "uniform")}
    draws = {"normal": torch.randn(size["normal"], generator=g, device=device),
             "uniform": torch.rand(size["uniform"], generator=g, device=device)}
    at = {"normal": 0, "uniform": 0}
    out = {}
    for key, shape, kind, scale in entries:
        n = torch.Size(shape).numel()
        if kind == "count":
            out[key] = torch.zeros(shape, dtype=torch.long, device=device)
            continue
        if kind == "zeros":
            out[key] = torch.zeros(shape, device=device)
            continue
        t = draws[kind][at[kind]:at[kind] + n].view(shape)
        at[kind] += n
        if kind == "normal":
            out[key] = t * scale
        else:
            lo, hi = scale if isinstance(scale, tuple) else (-scale, scale)
            out[key] = lo + (hi - lo) * t
    return out
