"""Kernel F: the tensor cores' sustained rate from shared memory.

Port of the Pallas roofline probe tools/exp_r5_mosaic_dot.py, which
computes no model function: per step g of x [G, R, W, K] it multiplies the
slab by each of the ``ndots`` matrices of w [ndots, K, N], sums the products
and keeps only row 0 of R, so that the products stay live. Kernel F
(``csrc/mma_rate.cu``, ``wgmma`` s8 or bf16; K split across a cluster of
:data:`CLUSTER` blocks, each with its K share of the weights resident in
shared memory) does every product of every row, as the probe does;
:func:`mma_rate` is its wrapper and :func:`mma_rate_plain` its plain
version, computed on row 0 alone. The sums are exact in both (integers, and
bf16 integers whose sums stay below 2^24), so the kernel is held to the plain
version bit for bit on such inputs.
"""

from __future__ import annotations

import torch

from .._build import MMA_RATE

# the operand types: (x and w dtype, sum dtype, the launcher's mode)
_MODES = {torch.int8: (torch.int32, 0), torch.bfloat16: (torch.float32, 1)}
N = 128          # the probe's (and the kernel's) output channels
UNIT_ROWS = 128  # rows of a step a kernel unit takes (csrc/mma_rate.cu)
# blocks of a cluster, each with one K share (csrc/mma_rate.cu Traits::CL);
# a share is a multiple of 64 bytes of K
CLUSTER = {torch.int8: 2, torch.bfloat16: 4}
SHARE_ALIGN = 64


def k_chunk(k_bytes: int, cluster: int) -> int:
    """Kernel F's K chunk in bytes for K of ``k_bytes`` split ``cluster``
    ways: 128 (the 128-byte swizzle) where the share is a multiple of 128
    bytes, else 64 (the 64-byte swizzle); 0 where the cluster cannot split
    K."""
    if k_bytes <= 0 or k_bytes % (SHARE_ALIGN * cluster):
        return 0
    return 128 if (k_bytes // cluster) % 128 == 0 else 64


def mma_rate_plain(x, w):
    """Row 0 of sum_i x[g] @ w[i] for every step g: [G, W, N], int32 for
    int8 operands (summed exactly in float64), float32 for bfloat16 (each
    dot in f32, then added in i order, as the TPU probe adds them)."""
    if x.is_cuda:
        MMA_RATE.plain_on_cuda += 1
    out_dtype = _MODES[x.dtype][0]
    x0, w = x[:, 0], w.to(x.device)
    work = torch.float64 if x.dtype == torch.int8 else torch.float32
    acc = None
    for i in range(w.shape[0]):
        d = torch.matmul(x0.to(work), w[i].to(work))
        acc = d if acc is None else acc + d
    return acc.to(out_dtype)


def mma_rate(x, w):
    """The probe's function on the card: x [G, R, W, K] and w [ndots, K, N]
    of one type, int8 or bfloat16 -> row 0 of sum_i x[g] @ w[i], [G, W, N]
    in int32 or float32, every row of x multiplied. On the card K must split
    into :data:`CLUSTER` shares of a multiple of 64 bytes (a multiple of 128
    values in both types), R W must be a multiple of 128 and N = 128, and a
    share of the weights (ndots K N / CLUSTER values) must fit in shared
    memory beside the partial sums' slots and two stages of x.
    Calls the operator ``vqa_tpu_torch::mma_rate`` (``ops.library``)."""
    return torch.ops.vqa_tpu_torch.mma_rate(x, w)


def pack_mma_rate_weights(w):
    """Kernel F's weight layout: [ndots, K, N] -> w^T [ndots N, K] (row
    i N + n is column n of w[i]), the K-major rows its TMA boxes read."""
    nd, k, n = w.shape
    return w.permute(0, 2, 1).reshape(nd * n, k).contiguous()


def launch_mma_rate(x, wt, ndots: int):
    """Launch kernel F on operands already in its layout: ``x`` contiguous
    [G, R, W, K] on the card, ``wt`` from :func:`pack_mma_rate_weights`."""
    g, r, wd, k = x.shape
    out_dtype, mode = _MODES[x.dtype]
    out = torch.empty((g, wd, N), dtype=out_dtype, device=x.device)
    MMA_RATE.launch(x.data_ptr(), wt.data_ptr(), out.data_ptr(), g, r * wd, wd, k, ndots, mode)
    return out
