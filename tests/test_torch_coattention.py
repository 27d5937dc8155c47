"""Port attention model (vqa_tpu_torch.models.coattention) vs vqa_tpu's.

Full ``HierarchicalCoAttentionNet`` logits on the same weights, JAX applied
eagerly (see tests/test_torch_vgg.py for why, and for the BatchNorm stats),
at 64² with a small vocab and the full widths (512 / 1024).

Tolerances:
- fp32 (``opt_lvl=0``), int8 backbone on or off: rtol = atol = 1e-5 (the
  features are bit-equal; the rest differs only in summation order);
- bf16 (``opt_lvl=1``): atol 2e-2 + rtol 2e-2 on logits of size ~0.3. Both
  packages compute the question tower, co-attention and head in bf16 but
  round at different places (XLA keeps bf16 sums in f32 inside fusions,
  PyTorch's autocast rounds every op's output).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_vgg import WIDTHS, parity_safe_variables
from vqa_tpu.config import build_model as jax_build
from vqa_tpu.models.layers import LSTM as JaxLSTM
from vqa_tpu_torch.config import build_model
from vqa_tpu_torch.models.convert import from_jax
from vqa_tpu_torch.models.coattention import PhraseConvPool
from vqa_tpu_torch.models.layers import LSTM

V, K, S, L = 40, 7, 64, 6


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    img = rng.standard_normal((2, S, S, 3)).astype(np.float32)
    q = rng.integers(1, V, (2, L)).astype(np.int32)
    q[1, 3:] = 0
    return img, q, np.array([L, 3], np.int32)


def _amax(seed=7):
    rng = np.random.default_rng(seed)
    return tuple(tuple(float(v) for v in rng.random(c) * 2 + 0.5) for c in WIDTHS)


@pytest.fixture(scope="module")
def weights():
    jm, _ = jax_build("attention", V, K, opt_lvl=0)
    return parity_safe_variables(jm, seed=21, seq=L)


def _pair(weights, opt_lvl, int8, amax=()):
    params, stats = weights
    jm, _ = jax_build("attention", V, K, opt_lvl=opt_lvl, int8_backbone=int8)
    if amax:
        jm = jm.clone(int8_amax=amax)
    tm, _ = build_model("attention", V, K, opt_lvl=opt_lvl, int8_backbone=int8,
                        device="cpu")
    tm.load_state_dict(from_jax("attention", params, stats), strict=True)
    if amax:
        tm.int8_amax = amax
    return jm, {"params": params, "batch_stats": stats}, tm


def _logits(jm, jv, tm, seed=0):
    img, q, ql = _inputs(seed)
    # eager when int8 stages run (see the module note); jit otherwise, where
    # FMA contraction moves values by an ulp at most
    apply = jax.jit(jm.apply) if not jm.int8_stages else jm.apply
    ref = np.asarray(apply(jv, jnp.asarray(img), jnp.asarray(q), jnp.asarray(ql))
                     .astype(jnp.float32))
    with torch.no_grad():
        out = tm(torch.from_numpy(img), torch.from_numpy(q).long(),
                 torch.from_numpy(ql).long()).float().numpy()
    assert out.shape == ref.shape == (2, K)
    return ref, out


@pytest.mark.parametrize("int8", [False, True])
def test_fp32_logits(weights, int8):
    jm, jv, tm = _pair(weights, 0, int8, _amax() if int8 else ())
    ref, out = _logits(jm, jv, tm)
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


def test_bf16_logits(weights):
    jm, jv, tm = _pair(weights, 1, True, _amax())
    ref, out = _logits(jm, jv, tm, seed=2)
    np.testing.assert_allclose(out, ref, rtol=2e-2, atol=2e-2)


def test_lstm_masked_outputs():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 5, 8)).astype(np.float32)
    lens = np.array([5, 2, 1], np.int32)
    jl = JaxLSTM(16)
    v = jl.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(lens))
    ref = np.asarray(jl.apply(v, jnp.asarray(x), jnp.asarray(lens)))
    p = v["params"]
    tl = LSTM(8, 16)
    tl.load_state_dict({"weight_ih_l0": torch.from_numpy(np.array(p["w_ih"]).T.copy()),
                        "weight_hh_l0": torch.from_numpy(np.array(p["w_hh"]).T.copy()),
                        "bias_ih_l0": torch.from_numpy(np.array(p["b_ih"])),
                        "bias_hh_l0": torch.from_numpy(np.array(p["b_hh"]))})
    with torch.no_grad():
        out = tl(torch.from_numpy(x), torch.from_numpy(lens).long()).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)
    assert np.all(out[1, 2:] == 0.0) and np.all(out[2, 1:] == 0.0)


@pytest.mark.parametrize("lens", [[7, 7, 7, 7, 7], [7, 0, 3, 1, 7]], ids=["full", "ragged"])
def test_lstm_fused_equals_loop(lens):
    """The fused call against the masked loop in fp32, forward and
    backward: outputs within 1e-6 and exactly 0 past each length, the
    input's and the four weights' gradients within 1e-5 of their norm (the
    two sum in another order); one ``fused_calls`` a call, no loop call."""
    torch.manual_seed(5)
    lstm = LSTM(12, 16, torch.Generator().manual_seed(6))
    x = torch.randn(len(lens), 7, 12, requires_grad=True)
    lengths = torch.tensor(lens)
    g = torch.randn(len(lens), 7, 16)
    grads = []
    for run in (lstm, lstm._loop):
        before = (LSTM.fused_calls, LSTM.loop_calls)
        out = run(x, lengths)
        calls = (LSTM.fused_calls - before[0], LSTM.loop_calls - before[1])
        x.grad = None
        lstm.zero_grad()
        (out * g).sum().backward()
        grads.append((out.detach(), calls, x.grad, *(w.grad for w in lstm._weights())))
    (fused, fused_calls, *fused_grads), (loop, loop_calls, *loop_grads) = grads
    assert fused_calls == (1, 0) and loop_calls == (0, 0)
    torch.testing.assert_close(fused, loop, rtol=0, atol=1e-6)
    assert torch.all(fused[torch.arange(7)[None, :] >= lengths[:, None]] == 0)
    for a, b in zip(fused_grads, loop_grads):
        assert float((a - b).norm()) <= 1e-5 * float(b.norm())


def test_phrase_pool_groups_adjacent_channels():
    """Quirk 1: output e = max(cat[3e], cat[3e+1], cat[3e+2])."""
    pcp = PhraseConvPool(4)
    x = torch.randn(1, 3, 4, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        xc = x.transpose(1, 2)
        cat = torch.cat([pcp.conv_unigram(xc), pcp.conv_bigram(xc),
                         pcp.conv_trigram(xc)], dim=1).transpose(1, 2)   # [1, 3, 12]
        out = pcp(x)
    for e in range(4):
        assert torch.equal(out[..., e], cat[..., 3 * e:3 * e + 3].amax(dim=-1))


def test_use_pallas_raises():
    with pytest.raises(NotImplementedError, match="retired"):
        build_model("attention", V, K, use_pallas=True, device="cpu")
