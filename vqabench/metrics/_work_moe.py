"""The held experts' grouped products in a training step: their work,
counted from a configuration's shapes, and their device time, read from
the trace as the kernels launched inside the program's span
``vqa.model.experts`` (the program opens it around the products' forward
and their backward).

Frozen with the benchmark, as ``_work`` is. The rows a layer multiplies
are the pairs routed to its held experts: the step's N positions (at the
full question length) times k, times the share of the pairs that went to
held experts over the run, which the program's counters
``vqa.model.expert_rows.<layer>`` give (the pairs of each held expert,
then those of the experts not held); the configuration's expectation,
``held / routed``, where the program keeps no counter.
"""

from __future__ import annotations

from . import _spans, _trace
from ._work import BF16_FLOPS, HBM_BPS

EXPERTS = "vqa.model.experts"
BF16_BYTES = 2


def held_shares() -> list | None:
    """Each expert layer's share of routed pairs that went to its held
    experts, over the run, from the program's counters; None where the
    program keeps none."""
    counts = _counters()
    if not counts:
        return None
    return [sum(c[:-1]) / sum(c) for c in counts if sum(c) > 0] or None


def expert_work(cfg: dict, batch: int, shares: list | None = None) -> tuple[float, float]:
    """(operations, bytes) of a training step's grouped products: gate, up
    and down at the held rows (each layer's ``shares``, else the expected
    ``held / routed``), forward and twice for the backward; each of the
    three passes reads the held experts' bf16 weights and moves the rows in
    and out of both products."""
    positions = batch * ((cfg["image_size"] // 32) ** 2 + cfg["max_seq_length"])
    layers = cfg["num_hidden_layers"] - cfg["first_k_dense_replace"]
    if shares is None:
        shares = [cfg["experts_held"] / cfg["n_routed_experts"]] * layers
    rows = positions * cfg["num_experts_per_tok"] * sum(shares)     # over the layers
    d, w = cfg["hidden_size"], cfg["moe_intermediate_size"]
    ops = 3 * 2.0 * rows * 3 * d * w
    weights = layers * cfg["experts_held"] * 3 * d * w * BF16_BYTES
    moved = rows * ((d + 2 * w) + (w + d)) * BF16_BYTES
    return ops, 3 * (weights + moved)


def least_seconds(cfg: dict, batch: int, shares: list | None = None) -> float:
    """The larger of the operations at the bf16 peak and the bytes at HBM's."""
    ops, moved = expert_work(cfg, batch, shares)
    return max(ops / BF16_FLOPS, moved / HBM_BPS)


def expert_us(ctx):
    """Device microseconds over the traced steps of the kernels launched
    inside ``vqa.model.experts`` (on any thread: the backward's launch from
    the autograd engine's); None where the trace has no such span or launch."""
    spans = [(a, b) for name, a, b in _spans.program_spans(ctx.events) if name == EXPERTS]
    if not spans:
        return None
    launches = {e["args"]["correlation"]: float(e["ts"]) for e in ctx.events
                if e.get("cat") in _spans.LAUNCH_CATS and "correlation" in e.get("args", {})}
    total, found = 0.0, False
    for e in _trace.device_events(ctx.events):
        t = launches.get(e.get("args", {}).get("correlation"))
        if t is not None and any(a <= t < b for a, b in spans):
            total += float(e.get("dur", 0))
            found = True
    return total if found else None


def expert_ms(ctx):
    us = expert_us(ctx)
    return None if us is None else us / 1e3 / ctx.steps


def expert_roofline(ctx):
    """Percent: the grouped products' least time over their device time."""
    ms = expert_ms(ctx)
    if not ms:
        return None
    return 100.0 * least_seconds(ctx.config, ctx.batch, held_shares()) / (ms / 1e3)


def _counters() -> list:
    """The program's expert-row counters, one list a layer; [] where it
    keeps none."""
    try:
        from vqa_tpu_torch.train import profiling
    except ImportError:
        return []
    names = getattr(profiling, "counter_names", None)
    if names is None:
        return []
    return [profiling.counter(name) for name in names("vqa.model.expert_rows.")]


def route_imbalance(ctx):
    """The busiest held expert's rows over the mean of the held experts',
    in the worst expert layer, from the program's counters
    ``vqa.model.expert_rows.<layer>`` (summed over the run; the last entry,
    the pairs of experts not held, left out); None where the program keeps
    no such counter."""
    worst = None
    for counts in _counters():
        rows = counts[:-1]
        mean = sum(rows) / len(rows)
        if mean > 0:
            worst = max(worst or 0.0, max(rows) / mean)
    return worst
