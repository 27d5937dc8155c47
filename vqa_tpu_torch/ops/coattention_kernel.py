"""Fused parallel co-attention forward (kernel E) and its plain version.

Port of tools/retired/coattention_kernel.py, the Pallas TPU kernel that
fuses the whole ParallelCoAttention block of the three question levels
(PARITY.md N1 names this module as its home). Three functions:

- :func:`coattention_reference`: vqa_tpu's ``coattention_xla`` in PyTorch,
  with the score biases ``c_v``/``c_q``: the autodiff oracle;
- :func:`coattention_plain`: the kernel's arithmetic (W_v V once for the
  three levels, f32 sums of every product, every intermediate after the two
  projections in f32, no ``c_v``/``c_q``: they cancel in the softmax, f32
  softmaxes, the pooled outputs rounded to the input dtype);
- :func:`coattention_fused`: the drop-in for ``coattention_reference``. Its
  forward calls the operator ``vqa_tpu_torch::coattention_fwd``
  (``ops.library``): kernel E (``csrc/coattention_fwd.cu``) on the card,
  :func:`coattention_plain` on the CPU. Its backward recomputes through
  :func:`coattention_reference` under autograd, as the TPU kernel's
  ``_bwd`` does through XLA; there is no backward kernel, because the JAX
  package has none.

Parameters are ``(W_v, b_v, W_q, b_q, w_v, c_v, w_q, c_q)`` with matrices
as [in, out] (``W_v``/``W_q`` [D, D], ``w_v``/``w_q`` [D, 1], biases [D] and
[1]). The kernel rounds ``W_v``/``W_q`` to the input dtype and takes the
biases and score vectors as f32. The attention model does not call this
module: ``use_pallas=True`` raises there, as in vqa_tpu.
"""

from __future__ import annotations

import torch

from .._build import COATTENTION_FWD
from .conv_stage1 import ulp

NUM_LEVELS = 3
# kernel E's phase (ii) block width: the columns of D whose H_v and H_q
# products and partial scores one block takes (csrc/coattention_fwd.cu DS)
SLICE = 64
_MODES = {torch.float32: 0, torch.bfloat16: 1}


def coattention_reference(params, x_img, x_ques_hierarchy):
    """vqa_tpu.models.coattention.coattention_xla in PyTorch (the oracle):
    x_img [B, S, D], each level [B, L, D] -> (3 x [B, D], 3 x [B, D]). The
    products run in the input dtype, the softmaxes in f32."""
    W_v, b_v, W_q, b_q, w_v, c_v, w_q, c_q = params
    V = x_img
    WvV = V @ W_v + b_v                                       # [B, S, D]
    img_feats, ques_feats = [], []
    for Q in x_ques_hierarchy:
        C = torch.tanh(Q @ V.transpose(1, 2))                 # [B, L, S]
        WqQ = Q @ W_q + b_q                                   # [B, L, D]
        H_v = torch.tanh(WvV + C.transpose(1, 2) @ WqQ)
        H_q = torch.tanh(WqQ + C @ WvV)
        a_v = torch.softmax((H_v @ w_v + c_v).float(), dim=1)  # [B, S, 1]
        a_q = torch.softmax((H_q @ w_q + c_q).float(), dim=1)  # [B, L, 1]
        img_feats.append((a_v.to(V.dtype) * V).sum(dim=1))
        ques_feats.append((a_q.to(Q.dtype) * Q).sum(dim=1))
    return img_feats, ques_feats


def coattention_plain(x_img, q_stacked, W_v, b_v, W_q, b_q, w_v, w_q):
    """Kernel E's arithmetic in plain PyTorch (tools/retired/
    coattention_kernel.py:69-117): x_img [B, S, D], q_stacked [B, 3, L, D]
    -> (out_v, out_q), each [B, 3, D] in x_img.dtype. f32 matmuls, full
    f32 (TF32 off, as PyTorch's default)."""
    if x_img.is_cuda:
        COATTENTION_FWD.plain_on_cuda += 1
    dt, dev = x_img.dtype, x_img.device
    V, Q = x_img.float(), q_stacked.to(dev).float()
    Wv, Wq = (w.to(dev, dt).float() for w in (W_v, W_q))
    bv, bq, sv, sq = (t.to(dev, torch.float32).reshape(-1) for t in (b_v, b_q, w_v, w_q))
    vw = V @ Wv + bv                                          # [B, S, D], once for the levels
    qw = Q @ Wq + bq                                          # [B, 3, L, D]
    C = torch.tanh(Q @ V[:, None].transpose(-1, -2))          # [B, 3, L, S]
    H_v = torch.tanh(vw[:, None] + C.transpose(-1, -2) @ qw)  # [B, 3, S, D]
    H_q = torch.tanh(qw + C @ vw[:, None])                    # [B, 3, L, D]
    a_v = torch.softmax(H_v @ sv, dim=-1)                     # [B, 3, S]
    a_q = torch.softmax(H_q @ sq, dim=-1)                     # [B, 3, L]
    out_v = (a_v[..., None, :] @ V[:, None]).squeeze(-2)      # [B, 3, D]
    out_q = (a_q[..., None, :] @ Q).squeeze(-2)
    return out_v.to(dt), out_q.to(dt)


def coattention_kernel_operands(x_img, W_v, b_v, W_q, b_q, w_v, w_q):
    """Kernel E's weights: W_v^T and W_q^T [D_out, D_in] in x_img.dtype
    (each output column's K contiguous: rows that TMA brings as the
    ``wgmma`` B operand), the biases and score vectors as f32 [D]."""
    dt, dev = x_img.dtype, x_img.device

    def vec(t):
        return t.to(dev, torch.float32).reshape(-1).contiguous()

    return (W_v.to(dev, dt).t().contiguous(), vec(b_v), W_q.to(dev, dt).t().contiguous(),
            vec(b_q), vec(w_v), vec(w_q))


def launch_coattention_fwd(v, q, wvt, bv, wqt, bq, wv, wq):
    """Launch kernel E on operands already in its layout: ``v`` [B, S, D]
    and ``q`` [B, 3, L, D] contiguous on the card, the rest from
    :func:`coattention_kernel_operands`. Allocates the f32 scratch of its
    projections (W_v V, W_q Q, tanh(Q V^T)) and of its partial scores, one
    row of S + L a slice of ``SLICE`` columns of D."""
    b, s, d = v.shape
    l = q.shape[2]
    dev = v.device
    vw = torch.empty((b, s, d), dtype=torch.float32, device=dev)
    qw = torch.empty((b, NUM_LEVELS * l, d), dtype=torch.float32, device=dev)
    ct = torch.empty((b, NUM_LEVELS * l, s), dtype=torch.float32, device=dev)
    part = torch.empty((b, NUM_LEVELS, -(-d // SLICE), s + l), dtype=torch.float32, device=dev)
    out_v = torch.empty((b, NUM_LEVELS, d), dtype=v.dtype, device=dev)
    out_q = torch.empty((b, NUM_LEVELS, d), dtype=v.dtype, device=dev)
    COATTENTION_FWD.launch(v.data_ptr(), q.data_ptr(), wvt.data_ptr(), bv.data_ptr(),
                           wqt.data_ptr(), bq.data_ptr(), wv.data_ptr(), wq.data_ptr(),
                           vw.data_ptr(), qw.data_ptr(), ct.data_ptr(), part.data_ptr(),
                           out_v.data_ptr(), out_q.data_ptr(), b, s, l, d, _MODES[v.dtype])
    return out_v, out_q


def coattention_fwd(x_img, q_stacked, W_v, b_v, W_q, b_q, w_v, w_q):
    """Kernel E's wrapper: (out_v, out_q), each [B, 3, D] in x_img.dtype.
    Calls the operator ``vqa_tpu_torch::coattention_fwd`` (``ops.library``).
    On the card D must be a multiple of 32."""
    return torch.ops.vqa_tpu_torch.coattention_fwd(x_img, q_stacked, W_v, b_v, W_q, b_q,
                                                   w_v, w_q)


def coattention_bound(x_img, q_stacked, out_v, out_q):
    """Kernel E's tolerance against :func:`coattention_plain`'s (out_v,
    out_q), per element: ``ulp(|plain|) + 2^-14 * M``, ulp of the input
    dtype, M the largest |V[b, s, d]| over s (for out_v) or |Q[b, level, l,
    d]| over l (for out_q): the pooled sum's scale.

    Both sides sum in f32 in different orders (the kernel's projections and
    its H_v/H_q products on the tensor cores, in f32 through 3xTF32, its
    scores summed per slice of 64 columns of D, then over the slices), and
    tanh/exp round differently: a few f32 ulps of relative
    difference in each intermediate, which reach the scores through the
    D = 512 terms of ``H w`` and the pooled outputs through the softmax: a
    score difference δ moves a pooled value by at most 2 δ M. 2^-14 (6.1e-5)
    allows δ up to 3e-5. At the attention model's shapes (S 196, L 23, D
    512), with its weight init and V, Q scaled up to 10 and 3, the plain
    version in f32 lies 50 to 800 times inside it from the same function in
    float64 (tests/test_torch_coattention_kernel.py checks it at a small
    size, and against a model of the kernel's arithmetic at D 32, 96 and
    512).
    """
    m_v = x_img.float().abs().amax(dim=1, keepdim=True).expand_as(out_v)
    m_q = q_stacked.float().abs().amax(dim=2)
    c = 2.0 ** -14
    return (ulp(out_v, x_img.dtype) + c * m_v, ulp(out_q, x_img.dtype) + c * m_q)


class _CoAttention(torch.autograd.Function):
    """Forward: the operator (kernel E on the card). Backward: autograd
    through :func:`coattention_reference` (with c_v/c_q) on the saved
    inputs, as tools/retired/coattention_kernel.py:_bwd recomputes through
    XLA."""

    @staticmethod
    def forward(ctx, x_img, q_stacked, W_v, b_v, W_q, b_q, w_v, c_v, w_q, c_q):
        ctx.save_for_backward(x_img, q_stacked, W_v, b_v, W_q, b_q, w_v, c_v, w_q, c_q)
        return coattention_fwd(x_img, q_stacked, W_v, b_v, W_q, b_q, w_v, w_q)

    @staticmethod
    def backward(ctx, g_v, g_q):
        needs = ctx.needs_input_grad
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(need) for t, need in zip(ctx.saved_tensors, needs)]
            x_img, q_stacked, params = leaves[0], leaves[1], tuple(leaves[2:])
            img, ques = coattention_reference(
                params, x_img, [q_stacked[:, i] for i in range(NUM_LEVELS)])
            wanted = [t for t, need in zip(leaves, needs) if need]
            grads = iter(torch.autograd.grad(
                (torch.stack(img, 1), torch.stack(ques, 1)), wanted, (g_v, g_q),
                allow_unused=True))
        return tuple(next(grads) if need else None for need in needs)


def coattention_fused(params, x_img, x_ques_hierarchy):
    """Drop-in for :func:`coattention_reference` (vqa_tpu's
    ``coattention_fused``): (list of 3 [B, D], list of 3 [B, D]). The
    forward is kernel E on the card; gradients flow to every parameter and
    input through the reference's autograd."""
    q_stacked = torch.stack(list(x_ques_hierarchy), dim=1)   # [B, 3, L, D]
    out_v, out_q = _CoAttention.apply(x_img, q_stacked, *params)
    return ([out_v[:, i] for i in range(NUM_LEVELS)],
            [out_q[:, i] for i in range(NUM_LEVELS)])
