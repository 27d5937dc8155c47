"""Kernel E's plain version and ``coattention_fused`` vs the JAX package's
retired fused co-attention kernel.

tools/retired/coattention_kernel.py is loaded from its file under a name of
its own (it lives outside the package); its Pallas kernel runs in interpret
mode on the CPU, as tools/retired/test_coattention_kernel.py runs it. The
same numpy-seeded inputs go through it and through the port's
``coattention_fused``, whose forward on the CPU is ``coattention_plain``
and whose backward is autograd through ``coattention_reference``.
Tolerances: forward 1e-5 (absolute and relative) in f32, the retired test's
own, and one bf16 ulp of the JAX value in bf16; gradients of every
parameter and input within 1e-5 of the largest JAX gradient of that tensor
(both differentiate vqa_tpu's ``coattention_xla`` math), except the score
biases', which are zero up to f32 noise on both sides (softmax shift
invariance).

B = 6 is not a multiple of the TPU kernel's batch block of 4. On the card,
kernel E is held to ``coattention_plain`` within ``coattention_bound``
(tests/test_torch_kernels.py, chip_smoke.py); that bound is checked here
against the same function in float64, with its projections split as the
kernel's 3xTF32 takes them, and as the kernel computes it (3xTF32 in both
phases, partial scores per slice of D summed in slice order).
"""

import importlib.util
import math
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vqa_tpu_torch.config import build_model
from vqa_tpu_torch.ops import coattention_kernel as ck

B, S, D, L = 6, 16, 32, 5
SHAPES = [(D, D), (D,), (D, D), (D,), (D, 1), (1,), (D, 1), (1,)]


@pytest.fixture(scope="module")
def retired():
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "tools", "retired", "coattention_kernel.py")
    spec = importlib.util.spec_from_file_location("vqa_tpu_retired_coattention_kernel", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(0)
    params = [(rng.standard_normal(s) * 0.1).astype(np.float32) for s in SHAPES]
    v = rng.standard_normal((B, S, D)).astype(np.float32)
    qs = [rng.standard_normal((B, L, D)).astype(np.float32) for _ in range(3)]
    return params, v, qs


def _loss_jax(fn, params, v, qs):
    ov, oq = fn(params, v, qs)
    return sum(jnp.sum(x ** 2) for x in ov + oq)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_jax_interpret_kernel(retired, problem, dtype):
    params, v, qs = problem
    jd = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    td = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    ref_v, ref_q = retired.coattention_fused(tuple(jnp.asarray(p, jd) for p in params),
                                             jnp.asarray(v, jd), [jnp.asarray(q, jd) for q in qs])
    out_v, out_q = ck.coattention_fused([torch.from_numpy(p).to(td) for p in params],
                                        torch.from_numpy(v).to(td),
                                        [torch.from_numpy(q).to(td) for q in qs])
    for r, o in zip(ref_v + ref_q, out_v + out_q):
        assert o.dtype == td and tuple(o.shape) == (B, D)
        r, o = np.asarray(r.astype(jnp.float32)), o.float().numpy()
        if dtype == "float32":
            np.testing.assert_allclose(o, r, rtol=1e-5, atol=1e-5)
        else:
            ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(r), 1e-38))) - 7)
            assert np.all(np.abs(o - r) <= ulp)


def test_gradients_match_jax_grad(retired, problem):
    """Every parameter's gradient, V's and each level's, in f32; the score
    biases' near zero on both sides (retired test_score_bias_grads_near_zero)."""
    params, v, qs = problem
    jp = tuple(jnp.asarray(p) for p in params)
    jv, jq = jnp.asarray(v), [jnp.asarray(q) for q in qs]
    gp, gv, gq = jax.grad(lambda p, a, b: _loss_jax(retired.coattention_fused, p, a, b),
                          argnums=(0, 1, 2))(jp, jv, jq)
    tp = [torch.from_numpy(p).requires_grad_() for p in params]
    tv = torch.from_numpy(v).requires_grad_()
    tq = [torch.from_numpy(q).requires_grad_() for q in qs]
    ov, oq = ck.coattention_fused(tp, tv, tq)
    sum((x ** 2).sum() for x in ov + oq).backward()
    for i, (j, t) in enumerate(zip(list(gp) + [gv] + list(gq), tp + [tv] + tq)):
        j, g = np.asarray(j), t.grad.numpy()
        if i in (5, 7):                                   # c_v, c_q
            assert float(np.abs(j).max()) < 1e-4 and float(np.abs(g).max()) < 1e-4
        else:
            np.testing.assert_allclose(g, j, rtol=0, atol=1e-5 * float(np.abs(j).max()))


def test_use_pallas_refusal_points_at_the_port():
    with pytest.raises(NotImplementedError, match="coattention_kernel.coattention_fused"):
        build_model("attention", 40, 5, use_pallas=True, device="cpu")


def _tf32_rna(v):
    bits = v.float().contiguous().view(torch.int32)
    return ((bits + (1 << 12)) & ~((1 << 13) - 1)).view(torch.float32)


def _mm_3xtf32(a, b):
    """a @ b with each f32 operand split into rna_tf32 hi and lo and the
    products taken as lo hi + hi lo + hi hi (kernel E's f32 projections)."""
    ah, bh = _tf32_rna(a), _tf32_rna(b)
    al, bl = _tf32_rna(a - ah), _tf32_rna(b - bh)
    return (al.double() @ bh.double() + ah.double() @ bl.double()
            + ah.double() @ bh.double()).float()


def _plain_variant(x, q, wv_, bv, wq_, bq, sv, sq, how):
    """``coattention_plain``'s function in float64, or with its projections
    and Q V^T through the 3xTF32 split."""
    if how == "float64":
        x, q = x.double(), q.double()
        mm = torch.matmul
        wv_, bv, wq_, bq, sv, sq = (t.double() for t in (wv_, bv, wq_, bq, sv, sq))
    else:
        mm = _mm_3xtf32
    vw = mm(x, wv_) + bv
    qw = mm(q, wq_) + bq
    c = torch.tanh(mm(q, x[:, None].transpose(-1, -2)))
    hv = torch.tanh(vw[:, None] + c.transpose(-1, -2) @ qw)
    hq = torch.tanh(qw + c @ vw[:, None])
    av = torch.softmax(hv @ sv.reshape(-1), -1)
    aq = torch.softmax(hq @ sq.reshape(-1), -1)
    return (av[..., None, :] @ x[:, None]).squeeze(-2), (aq[..., None, :] @ q).squeeze(-2)


def _as_kernel_e(x, q, wv_, bv, wq_, bq, sv, sq):
    """Kernel E's f32 arithmetic (csrc/coattention_fwd.cu): the projections
    and Q V^T in 3xTF32; then per slice of ``ck.SLICE`` columns of D (the
    last one ragged) C^T (W_q Q) and C (W_v V) in 3xTF32, + W_v V or W_q Q,
    tanh, the dot with the slice of w_v or w_q in f32; the slices' partial
    scores summed in slice order in f32; f32 softmaxes and pooled sums."""
    vw = _mm_3xtf32(x, wv_) + bv
    qw = _mm_3xtf32(q, wq_) + bq
    c = torch.tanh(_mm_3xtf32(q, x[:, None].transpose(-1, -2)))      # [B, 3, L, S]
    d = x.shape[-1]
    score_v = score_q = None
    for d0 in range(0, d, ck.SLICE):
        sl = slice(d0, min(d0 + ck.SLICE, d))
        hv = torch.tanh(vw[:, None, :, sl] + _mm_3xtf32(c.transpose(-1, -2), qw[..., sl]))
        hq = torch.tanh(qw[..., sl] + _mm_3xtf32(c, vw[:, None, :, sl]))
        pv = (hv * sv.reshape(-1)[sl]).sum(-1)
        pq = (hq * sq.reshape(-1)[sl]).sum(-1)
        score_v = pv if score_v is None else score_v + pv
        score_q = pq if score_q is None else score_q + pq
    av, aq = torch.softmax(score_v, -1), torch.softmax(score_q, -1)
    return (av[..., None, :] @ x[:, None]).squeeze(-2), (aq[..., None, :] @ q).squeeze(-2)


# the plain version's function in float64 and with 3xTF32 projections at D
# 128; a model of kernel E's f32 arithmetic (3xTF32 in both phases, partial
# scores per slice of 64 columns summed in slice order) at D 32 (one ragged
# slice), 96 (a ragged second slice) and 512 (the model's width)
KERNEL_E_BOUND_CASES = {"float64": ("float64", 128), "3xtf32": ("3xtf32", 128),
                        "kernel_e-d32": ("kernel_e", 32), "kernel_e-d96": ("kernel_e", 96),
                        "kernel_e-d512": ("kernel_e", 512)}


@pytest.mark.parametrize("how", list(KERNEL_E_BOUND_CASES))
def test_kernel_e_bound_covers_other_arithmetic(how):
    """``coattention_bound`` holds the plain version's function computed in
    float64, with 3xTF32 projections and as kernel E computes it, with the
    attention model's weight init (uniform, 1 / sqrt(D)) and V, Q at the
    scales of its features, and is not vacuous."""
    arith, d = KERNEL_E_BOUND_CASES[how]
    g = torch.Generator().manual_seed(3)
    b, s, l = 2, 49, 7
    lim = 1 / math.sqrt(d)
    wv_, bv, wq_, bq, sv, sq = ((torch.rand(sh, generator=g) * 2 - 1) * lim
                                for sh in ((d, d), (d,), (d, d), (d,), (d, 1), (d, 1)))
    x = torch.relu(torch.randn((b, s, d), generator=g)) * 5
    q = torch.randn((b, 3, l, d), generator=g) * 2
    out_v, out_q = ck.coattention_plain(x, q, wv_, bv, wq_, bq, sv, sq)
    if arith == "kernel_e":
        other = _as_kernel_e(x, q, wv_, bv, wq_, bq, sv, sq)
    else:
        other = _plain_variant(x, q, wv_, bv, wq_, bq, sv, sq, arith)
    for out, o, bound in zip((out_v, out_q), other, ck.coattention_bound(x, q, out_v, out_q)):
        diff = (o.double() - out.double()).abs()
        assert bool((diff <= bound).all()), float((diff - bound).max())
        assert float(bound.max()) < 1e-3 * float(out.abs().max())
        assert float(diff.max()) > 0
