"""Port VGG-11 stack (vqa_tpu_torch.models.vgg) vs vqa_tpu's, at 64².

The same weights (numpy, from a seed) go through vqa_tpu's encoder, applied
eagerly, and the port's. Eager, because under ``jax.jit`` XLA contracts
``acc * scale + bias`` into an FMA across the whole stack, and the JAX
package's own jitted and eager outputs then differ by moved requant ties.
BatchNorm variances are drawn where XLA-CPU's approximate ``rsqrt`` equals
the exactly rounded ``1 / sqrt`` the port folds with (ROADMAP.md, faults),
and running means equal the conv biases (so no FMA can enter the fold).

Tolerance: exact. The calibration amax and the static int8 features are
bit-equal at these sizes; on the card the same plain versions are bit-equal
to the kernels (tests/test_torch_ops.py, chip_smoke.py).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vqa_tpu.config import build_model as jax_build
from vqa_tpu.models.coattention import ImageCoAttentionEncoder as JaxImageEncoder
from vqa_tpu_torch.config import build_model
from vqa_tpu_torch.models.convert import from_jax
from vqa_tpu_torch.models.vgg import VGG11Encoder

S = 64
WIDTHS = (3, 64, 128, 256, 256, 512, 512, 512)


def parity_safe_variables(model, seed: int, size: int = S, seq: int = 6):
    """Init ``model`` (a vqa_tpu attention net) and give its VGG BatchNorm
    stats whose fold is exactly rounded in both packages."""
    rng = np.random.default_rng(seed)
    vs = jax.jit(model.init)({"params": jax.random.PRNGKey(seed)},
                             jnp.zeros((1, size, size, 3)),
                             jnp.ones((1, seq), jnp.int32), jnp.ones((1,), jnp.int32))
    params = jax.tree_util.tree_map(np.array, vs["params"])
    stats = jax.tree_util.tree_map(np.array, vs["batch_stats"])
    # eager, as the encoders below are applied (under jit XLA fuses the add
    # into the rsqrt and rounds differently again)
    rsqrt = lambda v: jax.lax.rsqrt(jnp.asarray(v) + 1e-5)  # noqa: E731
    feats = params["image_encoder"]["vgg11_encoder"]["features"]
    bn_stats = stats["image_encoder"]["vgg11_encoder"]["features"]
    for n in range(8):
        c = feats[f"conv{n}"]["bias"].shape[0]
        cand = (rng.random(8 * c) + 0.5).astype(np.float32)
        root = np.sqrt(cand + np.float32(1e-5))
        ok = np.asarray(rsqrt(cand)) == (np.float32(1.0) / root)
        var = cand[ok][:c]
        assert var.size == c
        feats[f"conv{n}"]["bias"] = (rng.standard_normal(c) * 0.1).astype(np.float32)
        feats[f"bn{n}"]["scale"] = (rng.random(c) + 0.5).astype(np.float32)
        feats[f"bn{n}"]["bias"] = (rng.standard_normal(c) * 0.1).astype(np.float32)
        bn_stats[f"bn{n}"]["mean"] = feats[f"conv{n}"]["bias"].copy()
        bn_stats[f"bn{n}"]["var"] = var
    return params, stats


@pytest.fixture(scope="module")
def weights():
    model, _ = jax_build("attention", 20, 4, opt_lvl=0)
    return parity_safe_variables(model, seed=11)


def _jax_encoder(params, stats, dtype, amax=()):
    enc = JaxImageEncoder(conv0_pallas=True, int8_stages=tuple(range(8)),
                          int8_amax=amax, hpack_pool=True, fused_stem=True,
                          int8_handoff=True, dtype=dtype)
    return enc, {"params": params["image_encoder"],
                 "batch_stats": stats["image_encoder"]}


def _port_encoder(params, stats, dtype):
    model, _ = build_model("attention", 20, 4, opt_lvl=0 if dtype == torch.float32 else 1,
                           int8_backbone=True, device="cpu")
    model.load_state_dict(from_jax("attention", params, stats), strict=True)
    return model


def _images(seed=0, b=2):
    return np.random.default_rng(seed).standard_normal((b, S, S, 3)).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_calibration_amax_bit_equal(weights, dtype):
    params, stats = weights
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    x = _images(1)
    enc, v = _jax_encoder(params, stats, jdt)
    _, upd = enc.apply(v, jnp.asarray(x), mutable=["quant_stats"])
    ref = {int(k[len("amax"):]): np.asarray(a)
           for k, a in upd["quant_stats"]["vgg11_encoder"]["features"].items()}
    model = _port_encoder(params, stats, tdt)
    qs = {}
    model.image_encoder(torch.from_numpy(x), quant_stats=qs)
    assert sorted(qs) == sorted(ref) == list(range(8))
    for s in range(8):
        assert qs[s].shape == (WIDTHS[s],)
        np.testing.assert_array_equal(qs[s].numpy(), ref[s], err_msg=f"stage {s}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_static_features_bit_equal(weights, dtype):
    params, stats = weights
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    rng = np.random.default_rng(2)
    amax = tuple(tuple(float(v) for v in rng.random(c) * 2 + 0.5) for c in WIDTHS)
    x = _images(3)
    enc, v = _jax_encoder(params, stats, jdt, amax)
    ref = np.asarray(enc.apply(v, jnp.asarray(x)).astype(jnp.float32))
    model = _port_encoder(params, stats, tdt)
    model.int8_amax = amax
    assert model.vgg._take_fused_stem(torch.zeros(2, S, S, 3, dtype=tdt), False)
    out = model.image_encoder(torch.from_numpy(x))
    assert out.dtype == tdt and tuple(out.shape) == (2, 4, 512)
    np.testing.assert_array_equal(out.float().numpy(), ref)


def test_dynamic_features_bit_equal(weights):
    """No calibration: dynamic per-batch scales, unfused stem, no hand-off."""
    params, stats = weights
    x = _images(4)
    enc, v = _jax_encoder(params, stats, jnp.float32)
    ref = np.asarray(enc.apply(v, jnp.asarray(x)))
    model = _port_encoder(params, stats, torch.float32)
    np.testing.assert_array_equal(model.image_encoder(torch.from_numpy(x)).numpy(), ref)


def test_float_backbone_matches(weights):
    """int8 off (the CPU default at every opt level): plain float convs."""
    params, stats = weights
    x = _images(5)
    enc = JaxImageEncoder(conv0_pallas=True)
    ref = np.asarray(enc.apply({"params": params["image_encoder"],
                                "batch_stats": stats["image_encoder"]}, jnp.asarray(x)))
    model, _ = build_model("attention", 20, 4, opt_lvl=0, device="cpu")
    assert model.int8_stages == ()
    model.load_state_dict(from_jax("attention", params, stats), strict=True)
    out = model.image_encoder(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4 * np.abs(ref).max())


ROUTING_CASES = [
    dict(opt_lvl=1, int8_backbone=True),
    dict(opt_lvl=0, int8_backbone=True),
    dict(opt_lvl=1, int8_backbone=False),
    dict(opt_lvl=1, int8_backbone=True, hpack_pool=False),
    dict(opt_lvl=1, int8_backbone=True, fused_stem=False),
    dict(opt_lvl=1, int8_backbone=True, int8_handoff=False),
    dict(opt_lvl=1, int8_backbone=True, conv0_pallas=False),
    dict(opt_lvl=1, int8_backbone=True, int8_stages_override=(0, 2, 3)),
    dict(opt_lvl=1, int8_backbone=None),
]


@pytest.mark.parametrize("kw", ROUTING_CASES, ids=lambda kw: ",".join(
    f"{k}={v}" for k, v in kw.items()))
def test_build_model_routes_like_vqa_tpu(kw):
    jm, jcfg = jax_build("attention", 12, 3, **kw)
    tm, tcfg = build_model("attention", 12, 3, device="cpu", **kw)
    assert tcfg == jcfg or tcfg.__dict__ == jcfg.__dict__
    vgg = tm.vgg
    for field in ("int8_stages", "conv0_pallas", "hpack_pool", "fused_stem",
                  "int8_handoff"):
        assert getattr(vgg, field) == getattr(jm, field), field
    assert vgg.dtype == (torch.float32 if kw["opt_lvl"] == 0 else torch.bfloat16)


@pytest.mark.parametrize("name", ["baseline", "bert"])
@pytest.mark.parametrize("kw", [ROUTING_CASES[i] for i in (0, 2, 7)], ids=lambda kw: ",".join(
    f"{k}={v}" for k, v in kw.items()))
def test_build_model_routes_baseline_and_bert_like_vqa_tpu(name, kw):
    """Every family routes through the same code; three cases each (the
    default int8 set, int8 off, a stage override) show it reaches them."""
    jm, jcfg = jax_build(name, 12, 3, max_seq_length=23, **kw)
    tm, tcfg = build_model(name, 12, 3, device="cpu", max_seq_length=23, **kw)
    assert tcfg.__dict__ == jcfg.__dict__ and tcfg.image_size == 224
    for field in ("int8_stages", "conv0_pallas", "hpack_pool", "fused_stem",
                  "int8_handoff"):
        assert getattr(tm.vgg, field) == getattr(jm, field), field
    assert tm.vgg is tm.image_encoder.vgg11_encoder.conv_layers
    if name == "bert":
        assert tm.question_encoder.max_len == jm.max_len == 64


def test_auto_int8_follows_the_device():
    # the auto-enable asks for the card; on the CPU it stays off, as in JAX
    tm, _ = build_model("attention", 12, 3, opt_lvl=1, device="cpu")
    assert tm.int8_stages == ()


def test_classifier_head_and_batch_stats_not_ported():
    """The classifier head is ported now (the baseline and bert towers):
    ``VGG11Encoder(include_head=True)`` has the reference's ``conv_layers`` /
    ``fc_layers.{1,4}`` keys and maps [B, S, S, 3] to [B, 4096], at 224²
    and at sizes whose adaptive pool is not the identity. Batch-stats
    BatchNorm (a trainable VGG) and ``s2d_first`` stay unported and raise."""
    head = VGG11Encoder(include_head=True).eval()
    keys = {k for k in head.state_dict() if k.startswith("fc_layers.")}
    assert keys == {f"fc_layers.{i}.{p}" for i in (1, 4) for p in ("weight", "bias")}
    assert head.fc_layers[1].in_features == 7 * 7 * 512
    for size in (32, 224):
        assert tuple(head(torch.zeros((1, size, size, 3))).shape) == (1, 4096)
    assert not isinstance(VGG11Encoder(include_head=False), type(head))
    for name in ("attention", "baseline", "bert"):
        with pytest.raises(NotImplementedError):
            build_model(name, 12, 3, vgg_trainable=True, device="cpu")
    s2d, _ = build_model("baseline", 12, 3, s2d_first=True, device="cpu")
    with pytest.raises(NotImplementedError, match="s2d_first"):
        s2d.frozen_features(torch.zeros((1, 32, 32, 3)))
