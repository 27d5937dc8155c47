"""Grouped expert products for a mixture-of-experts layer, and the row
permutation around them.

It replaces no TPU kernel: the JAX package has no expert layer. It exists
because a layer of held experts runs one matrix product per expert, and a
Python loop over 32 experts in 4 layers is about 2,000 launches a training
step; here each product of a layer is one launch, forward and backward.

A layer routes each of its N tokens to k experts; :func:`plan` sorts the
N k (token, expert) pairs by expert and keeps the pairs routed to the
experts this layer holds, one segment an expert, in order. Only those rows
are gathered, multiplied and combined: the pairs routed to experts held
elsewhere have no row here. Their number varies with the routing, so the
plan reads it to the host once a layer.

- :func:`grouped_mm` ``(x [R, K], w [E, N, K], plan) -> [R, N]``: row ``r``
  of segment ``e`` times ``w[e]`` transposed. On the card in bf16 each
  product is one launch of the library's grouped GEMM
  (``torch._grouped_mm``, CUTLASS on the tensor cores, f32 sums) over the
  segments' ends; its backward is two more: ``dx`` the same way, ``dw``
  as one grouped product whose segments split the reduction, both inside
  the span ``vqa.model.experts`` (the model opens it around the forward),
  so the span holds every launch of the products. Elsewhere
  (the CPU, or float32, whose products must stay IEEE) the plain version,
  one ``torch.mm`` a segment.
- :func:`gather_rows`: the held pairs' tokens in segment order; its
  backward sums each token's rows in a fixed order (no atomics).
- :func:`combine`: each token's held rows weighted and summed.

``LAUNCHES`` counts the grouped-GEMM launches in this process.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..train.profiling import span

LAUNCHES = 0


@dataclass
class Plan:
    """The sorted held pairs of one layer's routing.

    ``order`` [R]: the pair index (token k + slot) of each held row;
    ``row`` [N k]: each pair's row (0 for a pair not held); ``held_pair``
    [N k]: whether the pair's expert is held here; ``counts`` [E + 1]: the
    pairs of each held expert, then those of the experts not held;
    ``ends`` [E] (int32): each segment's end row; ``bounds``: the segments'
    first rows and the end, on the host; ``rows``: R."""
    order: torch.Tensor
    row: torch.Tensor
    held_pair: torch.Tensor
    counts: torch.Tensor
    ends: torch.Tensor
    bounds: list
    rows: int
    k: int


def plan(experts: torch.Tensor, first: int, held: int) -> Plan:
    """The plan of a routing ``experts`` [N, k] (expert ids) for a layer that
    holds experts ``first .. first + held - 1``."""
    k = experts.shape[1]
    local = experts.reshape(-1) - first
    held_pair = (local >= 0) & (local < held)
    seg = torch.where(held_pair, local, held)
    counts = torch.bincount(seg, minlength=held + 1)
    ends = torch.cumsum(counts[:held], 0)
    bounds = [0] + ends.tolist()             # the one read to the host
    rows = bounds[-1]
    order = torch.argsort(seg, stable=True)[:rows]
    row = torch.zeros_like(seg)
    row[order] = torch.arange(rows, device=seg.device)
    return Plan(order=order, row=row, held_pair=held_pair, counts=counts,
                ends=ends.to(torch.int32), bounds=bounds, rows=rows, k=k)


def _library(a: torch.Tensor) -> bool:
    return a.is_cuda and a.dtype == torch.bfloat16


def _grouped(a: torch.Tensor, b: torch.Tensor, p: Plan) -> torch.Tensor:
    global LAUNCHES
    LAUNCHES += 1
    return torch._grouped_mm(a, b, offs=p.ends)


def _rows(a: torch.Tensor, w: torch.Tensor, p: Plan, transposed: bool) -> torch.Tensor:
    """``out[r] = a[r] @ (w[e].T if transposed else w[e])`` for row ``r`` of
    segment ``e``. ``w`` [E, N, K] (transposed) or [E, K, N], in ``a``'s dtype."""
    b = w.transpose(1, 2) if transposed else w
    if _library(a):
        return _grouped(a, b, p)
    out = a.new_empty((a.shape[0], b.shape[2]))
    for e in range(len(p.bounds) - 1):
        s, t = p.bounds[e], p.bounds[e + 1]
        out[s:t] = a[s:t] @ b[e]
    return out


def _wgrad(g: torch.Tensor, x: torch.Tensor, p: Plan) -> torch.Tensor:
    """``dw[e] = g[seg e].T @ x[seg e]``: [E, N, K] in ``g``'s dtype."""
    if _library(g):
        return _grouped(g.t(), x, p)
    out = g.new_empty((len(p.bounds) - 1, g.shape[1], x.shape[1]))
    for e in range(len(p.bounds) - 1):
        s, t = p.bounds[e], p.bounds[e + 1]
        out[e] = g[s:t].t() @ x[s:t]
    return out


class _GroupedMM(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, p: Plan):
        wc = w.to(x.dtype)
        ctx.save_for_backward(x, wc)
        ctx.plan, ctx.w_dtype = p, w.dtype
        return _rows(x, wc, p, transposed=True)

    @staticmethod
    def backward(ctx, g):
        x, wc = ctx.saved_tensors
        with span("vqa.model.experts"):
            g = g.contiguous()
            dx = _rows(g, wc, ctx.plan, transposed=False) if ctx.needs_input_grad[0] else None
            dw = _wgrad(g, x, ctx.plan).to(ctx.w_dtype) if ctx.needs_input_grad[1] else None
        return dx, dw, None


def grouped_mm(x: torch.Tensor, w: torch.Tensor, p: Plan) -> torch.Tensor:
    """``x`` [R, K] in segment order, ``w`` [E, N, K] -> [R, N] in ``x``'s
    dtype (``w`` rounded to it)."""
    return _GroupedMM.apply(x.contiguous(), w, p)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, p: Plan):
        ctx.plan, ctx.n = p, x.shape[0]
        return x.index_select(0, p.order // p.k)

    @staticmethod
    def backward(ctx, g):
        p = ctx.plan
        rows = g.index_select(0, p.row).view(ctx.n, p.k, -1)
        return torch.where(p.held_pair.view(ctx.n, p.k, 1), rows, 0).sum(1), None


def gather_rows(x: torch.Tensor, p: Plan) -> torch.Tensor:
    """``x`` [N, D] -> [R, D]: each held row's token."""
    return _Gather.apply(x, p)


def combine(y: torch.Tensor, weights: torch.Tensor, p: Plan) -> torch.Tensor:
    """``y`` [R, D] in segment order, ``weights`` [N, k] -> [N, D]: each
    token's held rows weighted and summed (a pair not held adds nothing)."""
    n = weights.shape[0]
    rows = y.index_select(0, p.row).view(n, p.k, -1)
    kept = torch.where(p.held_pair.view(n, p.k), weights, 0)
    return (rows * kept.unsqueeze(-1).to(y.dtype)).sum(1)
