"""The comparisons that decide ``correct``: each number, and the rule that
turns two sets of outputs into it. Limits live in ``limits/<cell>.json``.

Serving: the softmax probabilities of a sample of the window's batches
against the reference's, as log-probabilities. ``logp_err`` is the widest
gap, over every row and class of the sample, between the program's log
probability and the reference's, over the median (across rows) of the
standard deviation of the reference's log-probabilities over the classes:
the error in units of how far apart the answers lie.

Training: the first steps' losses, the first gradient of each trained leaf
as the optimizer received it, and each leaf's change after the steps.
``loss_gap`` is the largest relative gap of a step's loss; ``grad_gap`` and
``change_gap`` take the worst leaf: the gap between the program's norm and
the reference's, over the larger of the reference's norm of that leaf and
of the median leaf. Leaves whose reference gradient is under a thousandth
of the median leaf's are left out: they move under Adam by round-off alone.
Norms and a batch's mean loss add up rounding errors of either sign, which
cancel, and norms do not see a change of direction; so two first gradients
are also compared whole, as the norm of the difference over the
reference's norm: ``tower_grad_diff`` of the trained weight that takes the
tower's output, which sees the tower where it reaches the loss only
through a normalization (baseline) or averaged over the batch, and
``output_grad_diff`` of the weight that gives the logits, which sees the
forward's error undiluted by the backward's (in attention, sound runs'
bfloat16 LSTM and co-attention move the other leaves' gradients by up to
a quarter, within reach of a float8 head's).

A cell's limits file lists the numbers it compares; the others are read
and printed, not compared.
"""

from __future__ import annotations

import math
import statistics

import numpy as np

SKIP_BELOW = 1e-3


def logp_err(program_probs: np.ndarray, reference_logp: np.ndarray) -> float:
    prog = np.log(np.maximum(program_probs.astype(np.float64), 1e-38))
    ref = reference_logp.astype(np.float64)
    scale = float(np.median(ref.std(axis=1)))
    return float(np.abs(prog - ref).max() / scale)


def leaf_gaps(program: dict, reference: dict, kept: list) -> list:
    med = statistics.median(reference[k] for k in kept)
    return [abs(program.get(k, 0.0) - reference[k]) / max(reference[k], med) for k in kept]


def kept_leaves(reference_grad: dict) -> list:
    med = statistics.median(reference_grad.values())
    return sorted(k for k, v in reference_grad.items() if v >= SKIP_BELOW * med)


def diff(program, reference) -> float:
    """The norm of the difference over the reference's norm (1 where the
    program has no such tensor)."""
    if program is None:
        return 1.0
    ref = reference.double()
    return float((program.double() - ref).norm() / ref.norm())


def train_numbers(program: dict, reference: dict) -> dict:
    """``program`` and ``reference``: {"loss": [per step], "grad": {leaf: norm},
    "change": {leaf: norm}, "first": {leaf: first gradient}}; the
    reference's "consumer" names the weight that takes the tower's output,
    its "output" the weight that gives the logits."""
    kept = kept_leaves(reference["grad"])
    loss = max(abs(a - b) / abs(b) for a, b in zip(program["loss"], reference["loss"]))
    grad = leaf_gaps(program["grad"], reference["grad"], kept)
    change = leaf_gaps(program["change"], reference["change"], kept)
    first, ref_first = program["first"], reference["first"]
    consumer, output = reference["consumer"], reference["output"]
    return {"loss_gap": loss, "grad_gap": max(grad), "change_gap": max(change),
            "tower_grad_diff": diff(first.get(consumer), ref_first[consumer]),
            "output_grad_diff": diff(first.get(output), ref_first[output])}


def verdict(numbers: dict, limits: dict) -> bool:
    """Every number the limits list is there, finite and within its limit."""
    return bool(limits) and all(
        k in numbers and math.isfinite(numbers[k]) and numbers[k] <= lim["limit"]
        for k, lim in limits.items())
