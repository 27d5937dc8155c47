"""The reference's runs: serving's log-probabilities and training's first steps.

Everything here is float32 with TF32 off (``strict``), in blocks of rows,
but where the configuration's compute dtype rounds the tower's values
(``tower``).
A ``Control`` puts the step below the configurations' precisions in the
reference's place: int4 for the int8 tower (``levels`` 7) or float8 for the
bfloat16 head (``FP8``).
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from . import tower
from .precision import F32, FP8, Precision
from .weights import model_module

BLOCK_ROWS = 32
BETAS, EPS = (0.9, 0.999), 1e-8


@dataclass(frozen=True)
class Control:
    levels: int = 127
    head: Precision = F32


CONTROLS = {"int4_tower": Control(levels=7), "fp8_head": Control(head=FP8)}
EXACT = Control()


@contextlib.contextmanager
def strict():
    """float32 products as float32: TF32 off for matmuls and convolutions
    while the reference runs, the program's settings restored after."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def compute_dtype(cfg: dict) -> torch.dtype:
    """The configuration's compute dtype: float32 at ``opt_lvl`` 0, else bfloat16."""
    return torch.float32 if cfg["opt_lvl"] == 0 else torch.bfloat16


def calibrate(cfg: dict, w: dict, images_u8: torch.Tensor, device, c: Control = EXACT):
    m, dt = model_module(cfg["model"]), compute_dtype(cfg)
    return tower.calibrate(w, m.TOWER_PREFIX, tower.preprocess(images_u8.to(device), dt),
                           c.levels, dt)


def tower_out(cfg: dict, w: dict, amax, images_u8: torch.Tensor, device,
              c: Control = EXACT) -> torch.Tensor:
    m, dt = model_module(cfg["model"]), compute_dtype(cfg)
    return tower.features(w, m.TOWER_PREFIX, tower.preprocess(images_u8.to(device), dt), amax,
                          c.levels, dt)


@torch.no_grad()
def serve_logp(cfg: dict, w: dict, amax, images_u8, ids, lens, device,
               c: Control = EXACT) -> torch.Tensor:
    """Log-probabilities [B, K] of one batch, on the host."""
    m = model_module(cfg["model"])
    out = []
    for s in range(0, images_u8.shape[0], BLOCK_ROWS):
        feats = tower_out(cfg, w, amax, images_u8[s:s + BLOCK_ROWS], device, c)
        logits = m.logits(w, feats, torch.as_tensor(ids[s:s + BLOCK_ROWS], device=device).long(),
                          torch.as_tensor(lens[s:s + BLOCK_ROWS], device=device).long(), c.head)
        out.append(torch.log_softmax(logits, dim=-1).cpu())
    return torch.cat(out)


def dropout_masks(cfg: dict, batch: int, generator, device) -> list:
    """One training forward's dropout masks, drawn in the model's order
    from ``generator`` (keep probability 1/2)."""
    m = model_module(cfg["model"])
    return [torch.empty(shape, device=device).bernoulli_(0.5, generator=generator).bool()
            for shape in m.dropout_shapes(cfg, batch)]


def train_readings(cfg: dict, w: dict, amax, batches: list, lr: float, dropout_seed: int,
                   device, c: Control = EXACT) -> dict:
    """Adam (torch's defaults, ``lr``) over ``batches`` (each a dict of host
    arrays: image uint8, question, ques_len, label), from ``w``.

    Returns {"loss": each step's mean cross-entropy, "grad": each trained
    leaf's first gradient norm, "change": each trained leaf's change norm
    after the last step, "first": each trained leaf's first gradient, on the
    host, "consumer" and "output": the names of the trained weights that take
    the tower's output and give the logits}."""
    m = model_module(cfg["model"])
    params = {k: v.detach().clone().requires_grad_() for k, v in w.items() if m.trainable(k)}
    frozen = {k: v for k, v in w.items() if not m.trainable(k)}
    start = {k: v.detach().clone() for k, v in params.items()}
    moments = {k: (torch.zeros_like(v), torch.zeros_like(v)) for k, v in params.items()}
    g_drop = torch.Generator(device=device).manual_seed(dropout_seed)
    losses, first_grad = [], None
    for t, batch in enumerate(batches, 1):
        with torch.no_grad():
            feats = torch.cat([tower_out(cfg, w, amax, batch["image"][s:s + BLOCK_ROWS], device, c)
                               for s in range(0, batch["image"].shape[0], BLOCK_ROWS)])
        masks = dropout_masks(cfg, feats.shape[0], g_drop, device)
        ids = torch.as_tensor(batch["question"], device=device).long()
        lens = torch.as_tensor(batch["ques_len"], device=device).long()
        labels = torch.as_tensor(batch["label"], device=device).long()
        logits = m.logits({**frozen, **params}, feats, ids, lens, c.head, masks)
        loss = F.cross_entropy(logits, labels)
        keys = list(params)
        grads = torch.autograd.grad(loss, [params[k] for k in keys], allow_unused=True)
        losses.append(float(loss.detach()))
        if first_grad is None:
            first_grad = {k: g.cpu() for k, g in zip(keys, grads) if g is not None}
        with torch.no_grad():
            for k, g in zip(keys, grads):
                if g is None:
                    continue
                m1, m2 = moments[k]
                m1.mul_(BETAS[0]).add_(g, alpha=1 - BETAS[0])
                m2.mul_(BETAS[1]).addcmul_(g, g, value=1 - BETAS[1])
                denom = (m2 / (1 - BETAS[1] ** t)).sqrt() + EPS
                params[k] -= lr * (m1 / (1 - BETAS[0] ** t)) / denom
    change = {k: float((params[k].detach() - start[k]).norm()) for k in params}
    return {"loss": losses, "grad": {k: float(g.norm()) for k, g in first_grad.items()},
            "change": change, "first": first_grad, "consumer": m.TOWER_CONSUMER,
            "output": m.OUTPUT}
