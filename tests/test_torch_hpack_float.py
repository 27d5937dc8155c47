"""The float route of the pooled conv stage (kernel D's plain version) vs
the JAX package's.

The same numpy-seeded inputs go through vqa_tpu's ``conv_bn_relu_pool``
with its Pallas kernel in interpret mode (``force="pallas"``, as
tests/test_conv_hpack.py runs it) and through the port's
``conv_bn_relu_pool`` with its default ``int8=False`` on the CPU, which runs
``conv3x3_f_plain``. Tolerances: 1e-5 (absolute and relative) in f32, the
JAX test's own (tests/test_conv_hpack.py:42-43); one bf16 ulp of the JAX
value in bf16 (both sum the f32 products in their own order and round once
to bf16). The JAX kernel takes even H and W only; an odd shape is held to
the JAX fallback, in f32, where that fallback computes the kernel's
function (in bf16 it rounds the conv to bf16 before the bias).

On the card, kernel D is held to ``conv3x3_f_plain`` within
``conv3x3_f_bound`` (tests/test_torch_kernels.py, chip_smoke.py); the bound's
soundness for other summation orders, and for a model of the kernel's
arithmetic, is checked here.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from vqa_tpu.ops import conv_hpack as j_hpack
from vqa_tpu_torch.ops import conv_hpack as t_hpack

TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JAX_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _inputs(shape, cin, cout, seed):
    rng = np.random.default_rng(seed)
    x = np.maximum(rng.standard_normal((*shape, cin)), 0).astype(np.float32)
    w = (rng.standard_normal((3, 3, cin, cout)) * 0.1).astype(np.float32)
    b = (rng.standard_normal(cout) * 0.1).astype(np.float32)
    return x, w, b


def _port(x, w, b, dtype):
    return t_hpack.conv_bn_relu_pool(torch.from_numpy(x).to(TORCH_DT[dtype]),
                                     torch.from_numpy(w).to(TORCH_DT[dtype]),
                                     torch.from_numpy(b).to(TORCH_DT[dtype]))


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a.astype(jnp.float32))


# (shape (B, H, W), C_in, C_out): tests/test_conv_hpack.py's first two shapes
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", [((2, 16, 16), 8, 16), ((1, 8, 24), 16, 8)],
                         ids=["square", "rectangular"])
def test_float_route_matches_jax_interpret_kernel(case, dtype):
    shape, cin, cout = case
    x, w, b = _inputs(shape, cin, cout, seed=cin)
    jd = JAX_DT[dtype]
    ref = j_hpack.conv_bn_relu_pool(jnp.asarray(x, jd), jnp.asarray(w, jd), jnp.asarray(b, jd),
                                    force="pallas")
    out = _port(x, w, b, dtype)
    assert out.dtype == TORCH_DT[dtype]
    assert tuple(out.shape) == (shape[0], shape[1] // 2, shape[2] // 2, cout)
    ref, got = _f32(ref), _f32(out)
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)
    else:
        ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(ref), 1e-38))) - 7)
        assert np.all(np.abs(got - ref) <= ulp)


def test_odd_shape_matches_jax_fallback():
    """Odd H and W floor (VALID pool) as vqa_tpu's fallback does."""
    x, w, b = _inputs((2, 15, 13), 8, 16, seed=3)
    ref = j_hpack.conv_bn_relu_pool(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    out = _port(x, w, b, "float32")
    assert tuple(out.shape) == (2, 7, 6, 16)
    np.testing.assert_allclose(_f32(out), _f32(ref), atol=1e-5, rtol=1e-5)


def test_default_route_is_float_and_s_next_needs_int8():
    x, w, b = (torch.from_numpy(a) for a in _inputs((1, 6, 8), 8, 8, seed=4))
    assert torch.equal(t_hpack.conv_bn_relu_pool(x, w, b), t_hpack.conv3x3_f_plain(x, w, b))
    with pytest.raises(AssertionError, match="s_next"):
        t_hpack.conv_bn_relu_pool(x, w, b, s_next=(1.0,) * 8)


def _tf32_rna(v):
    bits = v.float().contiguous().view(torch.int32)
    return ((bits + (1 << 12)) & ~((1 << 13) - 1)).view(torch.float32)


def _add_rz(a, b):
    """a + b in f32, rounded toward zero (from the exact sum in float64)."""
    s = a.double() + b.double()
    r = s.float()
    return torch.where(r.double().abs() > s.abs(), torch.nextafter(r, torch.zeros_like(r)), r)


def _as_kernel_d(x, w, b, truncate):
    """Kernel D's arithmetic (csrc/conv3x3_f.cu) in PyTorch, in its add
    grouping: K in chunks of 16 bf16 or 8 f32 channels (32 bytes, one wgmma
    k-step), the nine taps of a chunk in turn, one wgmma k16 a tap in bf16
    and three k8 in f32 (3xTF32: lo_x hi_w, hi_x lo_w, hi_x hi_w, each
    operand split into rna_tf32 hi and lo). An MMA adds its exact products
    to the f32 accumulator rounded once to nearest, or (``truncate``) one
    at a time, each add rounded toward zero. Then the 2x2 max, + b, ReLU,
    the rounding to x.dtype."""
    bsz, h, wd, c = x.shape
    ho, wo = h // 2, wd // 2
    bf16 = x.dtype == torch.bfloat16
    step = 16 if bf16 else 8
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))
    wk = w.to(x.dtype).float()
    acc = torch.zeros((bsz, 2 * ho, 2 * wo, w.shape[-1]))
    for c0 in range(0, c, step):
        for tap in range(9):
            ky, kx = divmod(tap, 3)
            xs = xp[:, ky:ky + 2 * ho, kx:kx + 2 * wo, c0:c0 + step]
            ws = wk[ky, kx, c0:c0 + step]
            if bf16:
                terms = [(xs, ws)]
            else:
                xh, wh = _tf32_rna(xs), _tf32_rna(ws)
                xl, wl = _tf32_rna(xs - xh), _tf32_rna(ws - wh)
                terms = [(xl, wh), (xh, wl), (xh, wh)]
            for a, bm in terms:
                prods = a[..., :, None] * bm                  # exact in f32
                if truncate:
                    for i in range(prods.shape[-2]):
                        acc = _add_rz(acc, prods[..., i, :])
                else:
                    acc = (acc.double() + prods.double().sum(-2)).float()
    m = acc.reshape(bsz, ho, 2, wo, 2, -1).amax(dim=(2, 4))
    return torch.relu(m + b.float()).to(x.dtype)


def _in_order(x, w, b, order):
    """``conv3x3_f_plain`` with its exact f32 products summed one at a time,
    in reversed (tap, channel) order, or as a pairwise tree."""
    bsz, h, wd, c = x.shape
    ho, wo = h // 2, wd // 2
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))
    wk = w.to(x.dtype).float()
    prods = [xp[:, ky:ky + 2 * ho, kx:kx + 2 * wo, ci:ci + 1] * wk[ky, kx, ci]
             for ky in range(3) for kx in range(3) for ci in range(c)]
    if order == "reversed":
        acc = torch.zeros_like(prods[0])
        for p in reversed(prods):
            acc = acc + p
    else:
        while len(prods) > 1:
            prods = [prods[i] + prods[i + 1] if i + 1 < len(prods) else prods[i]
                     for i in range(0, len(prods), 2)]
        acc = prods[0]
    m = acc.reshape(bsz, ho, 2, wo, 2, -1).amax(dim=(2, 4))
    return torch.relu(m + b.float()).to(x.dtype)


# (dtype, summation, inputs): the plain version's products in other orders,
# and the model of kernel D, rounding each MMA once or truncating each add,
# on random inputs and on inputs with cancellation (mixed signs, magnitudes
# 1e-3 to 1e3)
BOUND_CASES = {
    "bfloat16-reversed": ("bfloat16", "reversed", "random"),
    "bfloat16-pairwise": ("bfloat16", "pairwise", "random"),
    "bfloat16-kernel_d_truncating": ("bfloat16", "kernel_d_truncating", "random"),
    "bfloat16-kernel_d_truncating-cancellation": ("bfloat16", "kernel_d_truncating",
                                                  "cancellation"),
    "float32-pairwise": ("float32", "pairwise", "random"),
    "float32-kernel_d": ("float32", "kernel_d", "random"),
    "float32-kernel_d_truncating": ("float32", "kernel_d_truncating", "random"),
    "float32-kernel_d_truncating-cancellation": ("float32", "kernel_d_truncating",
                                                 "cancellation"),
}


@pytest.mark.parametrize("case", list(BOUND_CASES))
def test_kernel_d_bound_covers_other_summation_orders(case):
    """``conv3x3_f_bound`` holds the plain version summed in other orders
    and the model of kernel D's tensor-core arithmetic, at C_in 32 (K =
    288) and an odd shape, and is not vacuous."""
    dtype, order, values = BOUND_CASES[case]
    g = torch.Generator().manual_seed(5)
    shape = (2, 11, 13, 32)
    if values == "random":
        x = torch.randn(shape, generator=g)
        w = torch.randn((3, 3, 32, 16), generator=g) * 0.1
    else:
        def spread(*s):
            sign = torch.randint(0, 2, s, generator=g) * 2.0 - 1
            return sign * 10.0 ** (torch.rand(s, generator=g) * 6 - 3)
        x, w = spread(*shape), spread(3, 3, 32, 16) * 1e-3
    b = torch.randn(16, generator=g) * 0.1
    x = x.to(TORCH_DT[dtype])
    ref = t_hpack.conv3x3_f_plain(x, w, b)
    if order.startswith("kernel_d"):
        other = _as_kernel_d(x, w, b, truncate=order.endswith("truncating"))
    else:
        other = _in_order(x, w, b, order)
    diff = (other.float() - ref.float()).abs()
    bound = t_hpack.conv3x3_f_bound(x, w, ref)
    assert bool((diff <= bound).all()), float((diff - bound).max())
    limit = 0.05 if dtype == "bfloat16" else 3e-3
    assert float(bound.max()) < limit * float(ref.float().abs().max())
    if order.startswith("kernel_d") and dtype == "float32":
        assert float(diff.max()) > 0                      # the split is not exact
