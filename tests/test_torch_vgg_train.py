"""A trainable VGG, batch-stats BatchNorm, remat, ``s2d_first``, grad_accum,
profile_steps and loss scaling in the port vs vqa_tpu, on the CPU.

The same numpy inputs (from a seed) go through vqa_tpu's modules and steps
(JAX on the CPU) and the port's; one flax init goes to both
(``models.convert.from_jax``). Sizes: image 64, batch 2, vocab 30, K 4,
question length 6, at full width.

Tolerances:

- batch-stats ``VGGFeatures`` in fp32 (``s2d_first`` false and true): every
  BatchNorm divides each channel by its batch standard deviation, which
  amplifies the last-digit differences of two fp32 conv sums, so the two
  packages cannot agree to 1e-5. Each is measured against a float64
  evaluation of the same function (:func:`_batch_stats_f64`, written here
  from vgg.py:397-424): over 12 draws of weights and inputs the port's
  output lies 0.61-0.82e-5 * max|out| from it (the CPU's oneDNN conv is most
  of that; with a float64 conv 0.12e-5) and vqa_tpu's 0.36-0.51e-5. So the
  port is held within 1e-5 * max|out| of the float64 evaluation and within
  2e-5, the two packages' bounds added, of vqa_tpu; the updated running
  means and variances within 1e-6 and 2e-6 of each layer's largest
  (measured: at most 0.63e-6 and 1.09e-6);
- running-stats ``s2d_first`` in fp32: within 1e-5;
- bf16 batch-stats forward: see :func:`test_batch_stats_bf16_matches`;
- remat on vs off: bit-equal (the running stats are updated once);
- train steps: step-0 loss within 1e-5, the 10-step trajectory within
  rtol = atol = 2e-3 (the bound of tests/test_train_parity.py: fp32 drift
  compounds through Adam). A trainable VGG trains at the reference's default
  learning rate, 1e-4 (``LR_VGG``): at 1e-3 Adam moves every conv weight by
  ~2% a step, the loss reaches 16 by step 2, and the two packages' 2e-5
  relative difference after one step grows to 19% by step 10 in either
  direction (chaos, not a bias: at 1e-4 the same run stays within 4e-3).
  Frozen running stats after the batch-stats run
  within 1e-5 relative; grad_accum = 2 vs the port's own single step within
  1e-6 (loss and every gradient);
- ``DynamicLossScale``: scale, skip decisions and unscaled gradients equal.
"""

import os
import shutil

import flax.linen
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from test_torch_train import _cli, cli_data  # noqa: F401  (the CLI fixture)
from vqa_tpu.config import build_model as jax_build
from vqa_tpu.models.convert import from_torch as j_from_torch
from vqa_tpu.models.convert import load_torch_state_dict
from vqa_tpu.models.vgg import VGGFeatures as JaxVGGFeatures
from vqa_tpu.train import steps as j_steps
from vqa_tpu.train.scaling import DynamicLossScale as JaxLossScale
from vqa_tpu.train.state import create_train_state as j_create_train_state
from vqa_tpu.train.state import make_optimizer as j_make_optimizer
from vqa_tpu_torch.config import build_model
from vqa_tpu_torch.main import main
from vqa_tpu_torch.models.convert import VGG11_TORCH_CONV_IDX, _vgg, from_jax
from vqa_tpu_torch.models.vgg import VGG11_CFG, VGGFeatures
from vqa_tpu_torch.train import checkpoint as t_ckpt
from vqa_tpu_torch.train import steps as t_steps
from vqa_tpu_torch.train.scaling import DynamicLossScale
from vqa_tpu_torch.train.state import create_train_state

V, K, L, S, B = 30, 4, 6, 64, 2
LR = 1e-3
LR_VGG = 1e-4          # the reference's --learning_rate default
N_STEPS = 10


def _batches(n=3, seed=0, b=B):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        q = rng.integers(2, V, (b, L)).astype(np.int32)
        lens = rng.integers(2, L + 1, (b,)).astype(np.int32)
        for i, k in enumerate(lens):
            q[i, k:] = 0
        out.append({"image": rng.standard_normal((b, S, S, 3)).astype(np.float32),
                    "question": q, "ques_len": lens,
                    "label": rng.integers(0, K, (b,)).astype(np.int32)})
    return out


def _t(b):
    return {"image": torch.from_numpy(b["image"]),
            **{k: torch.from_numpy(b[k]).long() for k in ("question", "ques_len", "label")}}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ------------------------------------------------------------------ VGGFeatures


def _vgg_weights(s2d_first: bool, dtype=jnp.float32, seed=3):
    """A vqa_tpu ``VGGFeatures`` with conv biases, BN affines and running
    stats drawn from a seed, and the port's copy of it."""
    jm = JaxVGGFeatures(s2d_first=s2d_first, dtype=dtype)
    vs = jax.jit(jm.init)(jax.random.PRNGKey(1), jnp.zeros((1, S, S, 3)))
    params, stats = jax.tree_util.tree_map(np.array, (vs["params"], vs["batch_stats"]))
    rng = np.random.default_rng(seed)
    for n in range(8):
        c = params[f"conv{n}"]["bias"].shape[0]
        params[f"conv{n}"]["bias"] = (rng.standard_normal(c) * 0.1).astype(np.float32)
        params[f"bn{n}"]["scale"] = (rng.random(c) + 0.5).astype(np.float32)
        params[f"bn{n}"]["bias"] = (rng.standard_normal(c) * 0.1).astype(np.float32)
        stats[f"bn{n}"]["mean"] = (rng.standard_normal(c) * 0.1).astype(np.float32)
        stats[f"bn{n}"]["var"] = (rng.random(c) + 0.5).astype(np.float32)
    sd = {}
    _vgg(params, stats, "f", sd)
    port = VGGFeatures(s2d_first=s2d_first, dtype=torch.float32 if dtype == jnp.float32
                       else torch.bfloat16)
    port.load_state_dict({k[2:]: torch.from_numpy(np.asarray(v)) for k, v in sd.items()})
    return jm, {"params": params, "batch_stats": stats}, port


def _batch_stats_f64(port: VGGFeatures, x: np.ndarray):
    """vgg.py:397-424 in float64 (plain ops, the port's weights; s2d_first
    is the same function as conv + pool): -> (output, [(mean, var)])."""
    h = torch.from_numpy(x).double().permute(0, 3, 1, 2)
    convs = iter(port._conv_bn)
    stats = []
    for v in VGG11_CFG:
        if v == "M":
            h = F.max_pool2d(h, 2)
            continue
        conv, bn = next(convs)
        y = F.conv2d(h, conv.weight.double(), conv.bias.double(), padding=1)
        mean, var = y.mean((0, 2, 3)), y.var((0, 2, 3), correction=0)
        stats.append((mean, var))
        y = (y - mean[:, None, None]) / torch.sqrt(var[:, None, None] + 1e-5)
        h = torch.relu(y * bn.weight.double()[:, None, None] + bn.bias.double()[:, None, None])
    return h.permute(0, 2, 3, 1).detach().numpy(), stats


@pytest.mark.parametrize("s2d_first", [False, True])
def test_batch_stats_features_match(s2d_first):
    jm, variables, port = _vgg_weights(s2d_first)
    x = np.random.default_rng(0).standard_normal((B, S, S, 3)).astype(np.float32)
    before = {k: v.clone() for k, v in port.state_dict().items()}
    ref64, stats64 = _batch_stats_f64(port, x)
    j_out, upd = jm.apply(variables, jnp.asarray(x), False, mutable=["batch_stats"])
    port.train()
    out = port.train_forward(torch.from_numpy(x), batch_stats=True).detach().numpy()
    scale = np.abs(ref64).max()
    assert np.abs(out - ref64).max() <= 1e-5 * scale
    assert np.abs(out - np.asarray(j_out)).max() <= 2e-5 * scale
    for n, i in enumerate(VGG11_TORCH_CONV_IDX):
        bn = port[i + 1]
        for name, j, f64, buf in (("mean", 0, 0, "running_mean"), ("var", 1, 1, "running_var")):
            ref = 0.9 * before[f"{i + 1}.{buf}"].double().numpy() \
                + 0.1 * stats64[n][f64].detach().numpy()
            got = getattr(bn, buf).numpy()
            jax_got = np.asarray(upd["batch_stats"][f"bn{n}"][name])
            top = np.abs(ref).max()
            assert np.abs(got - ref).max() <= 1e-6 * top, (n, name)
            assert np.abs(got - jax_got).max() <= 2e-6 * top, (n, name)
        assert int(bn.num_batches_tracked) == 0
    trained = {k: v.clone() for k, v in port.state_dict().items()}
    port.eval()       # eval mode: no update
    port.train_forward(torch.from_numpy(x), batch_stats=True)
    assert all(torch.equal(v, trained[k]) for k, v in port.state_dict().items())


def test_running_stats_s2d_first_matches():
    jm, variables, port = _vgg_weights(True)
    x = np.random.default_rng(1).standard_normal((B, S, S, 3)).astype(np.float32)
    ref = np.asarray(jm.apply(variables, jnp.asarray(x), True))
    with torch.no_grad():
        out = port.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
    # the phase rewrite is exactly conv -> pool on the plain stack
    plain = VGGFeatures()
    plain.load_state_dict(port.state_dict())
    with torch.no_grad():
        np.testing.assert_allclose(out, plain.eval()(torch.from_numpy(x)).numpy(),
                                   rtol=1e-5, atol=1e-5)


def test_batch_stats_bf16_matches():
    """bf16 (``--opt_lvl 1``) batch-stats forward within 8 * ulp_bf16(max|out|).

    Each of the 8 stages ends in bf16 roundings (the conv result, the bias
    add, the normalized value) of values no larger than the stage's output,
    and the two packages' conv sums, taken in another order, can move such a
    rounding by one ulp; BatchNorm rescales each channel to unit variance, so
    a difference a stage takes in leaves it at about its size. After 8
    stages that is at most 8 ulps of the largest output, ulp_bf16(v) =
    2^(floor(log2 v) - 7). (At this input ~70% of elements differ and the
    largest difference is ~4 ulps.)"""
    jm, variables, port = _vgg_weights(False, dtype=jnp.bfloat16)
    x = np.random.default_rng(0).standard_normal((B, S, S, 3)).astype(np.float32)
    ref = np.asarray(jm.apply(variables, jnp.asarray(x), False,
                              mutable=["batch_stats"])[0]).astype(np.float32)
    port.train()
    out = port.train_forward(torch.from_numpy(x), batch_stats=True)
    assert out.dtype == torch.bfloat16
    ulp = 2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 7)
    assert np.abs(out.detach().float().numpy() - ref).max() <= 8 * ulp


@pytest.mark.parametrize("name", ["attention", "baseline", "bert"])
def test_remat_bit_equal_and_stats_updated_once(name):
    """A trainable VGG recomputes its conv stack in backward (attention and
    baseline, as vqa_tpu; bert has no remat): loss, every gradient and the
    running stats are bit-equal with remat off, and the stats moved once."""
    batch = _t(_batches(1, seed=4)[0])
    runs = []
    for remat in (True, False):
        model, _ = build_model(name, V, K, opt_lvl=0, device="cpu", vgg_trainable=True)
        if remat:
            assert model.remat == (name != "bert")
            with torch.no_grad():      # pure: the batch statistics, no update
                _, stats = model.vgg._batch_stats_forward(batch["image"])
        model.remat = remat
        for m in model.modules():
            if isinstance(m, torch.nn.Dropout):
                m.p = 0.0
        model.train()
        loss = t_steps.cross_entropy_loss(
            model(batch["image"], batch["question"], batch["ques_len"],
                  use_running_stats=False), batch["label"])
        loss.backward()
        runs.append((loss, model))
    (l1, m1), (l2, m2) = runs
    assert torch.equal(l1, l2)
    for (n1, p1), (_, p2) in zip(m1.named_parameters(), m2.named_parameters()):
        if p1.grad is None:          # co_attention.W_b: created, never applied
            assert p2.grad is None and "W_b" in n1, n1
        else:
            assert torch.equal(p1.grad, p2.grad), n1
    assert all(p.grad is not None for p in m1.vgg.parameters())
    for (n1, b1), (_, b2) in zip(m1.named_buffers(), m2.named_buffers()):
        assert torch.equal(b1, b2), n1
    bn0 = m1.vgg[1]
    torch.testing.assert_close(bn0.running_mean, 0.1 * stats[0][0], rtol=0, atol=0)
    torch.testing.assert_close(bn0.running_var, 0.9 * torch.ones(64) + 0.1 * stats[0][1],
                               rtol=0, atol=0)


# ------------------------------------------------------------------ train steps


def _no_jax_dropout(monkeypatch):
    """vqa_tpu's train step with its dropouts as the identity, to compare
    with a port whose dropouts are set to p = 0."""
    monkeypatch.setattr(flax.linen.Dropout, "__call__",
                        lambda self, x, deterministic=None, rng=None: x)


def _trajectories(name, *, vgg_trainable=False, bn_batch_stats=None, grad_accum=1,
                  b=B, n_steps=N_STEPS):
    lr = LR_VGG if vgg_trainable else LR
    batches = _batches(seed=7, b=b)
    jm, _ = jax_build(name, V, K, opt_lvl=0, vgg_trainable=vgg_trainable)
    init = {k: jnp.asarray(v[:1]) for k, v in batches[0].items() if k != "label"}
    state = j_create_train_state(jm, jax.random.PRNGKey(0), init, lr,
                                 vgg_trainable=vgg_trainable)
    sd = from_jax(name, _np(state.params), _np(state.batch_stats))
    tx = j_make_optimizer(lr, state.params, vgg_trainable)
    j_step = j_steps.make_train_step(jm, tx, vgg_trainable=vgg_trainable, donate=False,
                                     bn_batch_stats=bn_batch_stats, grad_accum=grad_accum)
    j_losses = []
    for i in range(n_steps):
        state, m = j_step(state, {k: jnp.asarray(v) for k, v in batches[i % 3].items()})
        j_losses.append(float(m["loss"]))
    j_after = from_jax(name, _np(state.params), _np(state.batch_stats))

    model, _ = build_model(name, V, K, opt_lvl=0, device="cpu", vgg_trainable=vgg_trainable)
    model.load_state_dict(sd, strict=True)
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    t_state = create_train_state(model, lr)
    step = t_steps.make_train_step(vgg_trainable=vgg_trainable, bn_batch_stats=bn_batch_stats,
                                   grad_accum=grad_accum)
    t_losses = [float(step(t_state, _t(batches[i % 3]))["loss"]) for i in range(n_steps)]
    before = {k: torch.as_tensor(np.asarray(v)) for k, v in sd.items()}
    return j_losses, t_losses, before, j_after, model


def _vgg_keys(model):
    return [k for k in model.state_dict() if k.startswith("image_encoder.vgg11_encoder.")]


@pytest.mark.parametrize("name", ["attention", "baseline"])
def test_vgg_train_matches_vqa_tpu(name, monkeypatch):
    """``--vgg_train``: vqa_tpu's ``make_train_step(vgg_trainable=True)``
    with ``make_optimizer(..., vgg_trainable=True)`` (batch-stats BN, remat)
    vs the port's step; the VGG and its head train."""
    _no_jax_dropout(monkeypatch)
    j_losses, t_losses, before, _, model = _trajectories(name, vgg_trainable=True)
    np.testing.assert_allclose(t_losses[0], j_losses[0], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(t_losses, j_losses, rtol=2e-3, atol=2e-3,
                               err_msg=f"jax={j_losses}\ntorch={t_losses}")
    after = model.state_dict()
    moved = [k for k in _vgg_keys(model) if not torch.equal(after[k], before[k])]
    assert "image_encoder.vgg11_encoder.0.weight" in moved or \
        "image_encoder.vgg11_encoder.conv_layers.0.weight" in moved
    assert any(k.endswith("running_var") for k in moved)
    if name == "baseline":
        assert "image_encoder.vgg11_encoder.fc_layers.1.weight" in moved
    assert all(p.requires_grad for p in model.parameters())


def test_vgg_train_running_bn_matches_vqa_tpu():
    """``--vgg_train true --bn_mode running``: the running-stats tower (BN
    folded into the convs) under autograd; the running stats stay."""
    j_losses, t_losses, before, _, model = _trajectories("attention", vgg_trainable=True,
                                                         bn_batch_stats=False)
    np.testing.assert_allclose(t_losses[0], j_losses[0], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(t_losses, j_losses, rtol=2e-3, atol=2e-3)
    after = model.state_dict()
    for k in _vgg_keys(model):
        stat = k.endswith(("running_mean", "running_var", "num_batches_tracked"))
        assert torch.equal(after[k], before[k]) == stat, k


def test_frozen_batch_stats_matches_vqa_tpu():
    """``--bn_mode batch`` on a frozen VGG (tests/test_train_integration.py:697):
    the running stats move, the VGG's parameters do not."""
    j_losses, t_losses, before, j_after, model = _trajectories("attention",
                                                               bn_batch_stats=True)
    np.testing.assert_allclose(t_losses[0], j_losses[0], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(t_losses, j_losses, rtol=2e-3, atol=2e-3)
    after = model.state_dict()
    for k in _vgg_keys(model):
        if k.endswith(("running_mean", "running_var")):
            assert not torch.equal(after[k], before[k]), k
            ref = np.asarray(j_after[k])
            np.testing.assert_allclose(after[k].numpy(), ref, rtol=1e-5,
                                       atol=1e-5 * np.abs(ref).max(), err_msg=k)
        else:
            assert torch.equal(after[k], before[k]), k


def test_grad_accum_matches_vqa_tpu():
    j_losses, t_losses, *_ = _trajectories("attention", grad_accum=2, b=4)
    np.testing.assert_allclose(t_losses[0], j_losses[0], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(t_losses, j_losses, rtol=2e-3, atol=2e-3)


def test_grad_accum_equals_one_step():
    """Two microbatches of 2 vs one batch of 4 from the same state: loss,
    accuracy and every gradient within 1e-6."""
    batch = _t(_batches(1, seed=9, b=4)[0])
    out = []
    for accum in (1, 2):
        model, _ = build_model("attention", V, K, opt_lvl=0, device="cpu")
        state = create_train_state(model, LR)
        m = t_steps.make_train_step(grad_accum=accum)(state, batch)
        out.append((m, {n: p.grad for n, p in model.named_parameters() if p.grad is not None}))
    (m1, g1), (m2, g2) = out
    torch.testing.assert_close(m2["loss"], m1["loss"], rtol=0, atol=1e-6)
    torch.testing.assert_close(m2["accuracy"], m1["accuracy"], rtol=0, atol=1e-6)
    assert g1.keys() == g2.keys() and g1
    for k in g1:
        torch.testing.assert_close(g2[k], g1[k], rtol=0, atol=1e-6, msg=k)


def test_grad_accum_raises_with_batch_stats_and_odd_batches():
    for kw in ({"vgg_trainable": True}, {"bn_batch_stats": True}):
        with pytest.raises(ValueError, match="running-stats"):
            t_steps.make_train_step(grad_accum=2, **kw)
    model, _ = build_model("attention", V, K, opt_lvl=0, device="cpu")
    step = t_steps.make_train_step(grad_accum=3)
    with pytest.raises(ValueError, match="must divide"):
        step(create_train_state(model, LR), _t(_batches(1, b=4)[0]))


def test_dynamic_loss_scale_matches_vqa_tpu():
    """A scripted run: finite, finite, overflow, NaN at the floor, then
    finite steps through a growth; every state, skip and gradient equal."""
    script = [1.0, 2.0, np.inf, np.nan, 0.5, 0.25, 0.125, 4.0]
    j = JaxLossScale.create(init_scale=4.0, growth_interval=3, min_scale=2.0)
    t = DynamicLossScale.create(init_scale=4.0, growth_interval=3, min_scale=2.0)
    skips, scales = [], []
    for i, v in enumerate(script):
        g = np.array([v, -1.5, 3.0], np.float32) * float(np.asarray(j.scale_value))
        assert float(t.scale(torch.tensor(1.5))) == float(j.scale(jnp.float32(1.5)))
        jg, jf, j = j.unscale_and_check({"w": jnp.asarray(g)})
        tg, tf, t = t.unscale_and_check({"w": torch.from_numpy(g)})
        assert bool(tf) == bool(jf), i
        np.testing.assert_array_equal(tg["w"].numpy(), np.asarray(jg["w"]), err_msg=str(i))
        assert float(t.scale_value) == float(j.scale_value), i
        assert int(t.good_steps) == int(j.good_steps), i
        kept = DynamicLossScale.select(tf, {"w": torch.zeros(1)}, {"w": torch.ones(1)})
        skips.append(float(kept["w"]) == 1.0)
        scales.append(float(t.scale_value))
    assert skips == [False, False, True, True, False, False, False, False]
    assert scales == [4.0, 4.0, 2.0, 2.0, 2.0, 2.0, 4.0, 4.0]


# ------------------------------------------------------------------ CLI


@pytest.mark.parametrize("model", ["attention", "baseline", "bert"])
def test_cli_vgg_train_resume_and_test(cli_data, model):  # noqa: F811
    """``--vgg_train true``: train, resume bit-equal from the step-1
    checkpoint, then ``--mode test``. baseline and bert at 2 steps of 8 (their
    checkpoints hold the 0.4 GB VGG head and its Adam moments)."""
    val = ["--val_img", str(cli_data), "--val_file", str(cli_data / "val.txt")]
    bs = ["--batch_size", "4"] if model == "attention" else ["--batch_size", "8"]
    run = f"vt_{model}"
    full = main(["--mode", "train", *_cli(cli_data, run, "--vgg_train", "true", *bs,
                                          "--save_interval", "1", model=model)])
    n = full["steps"]
    assert n == (4 if model == "attention" else 2) and np.isfinite(full["losses"]).all()
    resumed = main(["--mode", "train", *_cli(cli_data, f"{run}_r", "--vgg_train", "true", *bs,
                                              "--save_interval", "100", "--model_ckpt",
                                              os.path.join(full["log_dir"], "model_1.ckpt"),
                                              model=model)])
    assert resumed["first_step"] == 1 and resumed["losses"] == full["losses"][1:]
    os.remove(os.path.join(full["log_dir"], "model_1.ckpt"))
    res = main(["--mode", "test", *_cli(cli_data, run, "--vgg_train", "true", "--model_ckpt",
                                         f"model_{n}.ckpt", *val, model=model)])
    assert res["samples"] == 6 and np.isfinite(res["loss"])
    trained = t_ckpt.load_params_only(os.path.join(full["log_dir"], f"model_{n}.ckpt"))
    init, _ = build_model(model, V, K, opt_lvl=0, device="cpu", vgg_trainable=True,
                          generator=torch.Generator().manual_seed(0))
    first = _vgg_keys(init)[0]
    assert not torch.equal(trained[first], init.state_dict()[first])
    shutil.rmtree(full["log_dir"])
    shutil.rmtree(resumed["log_dir"])


def test_cli_vgg_train_pth_loads_into_vqa_tpu(cli_data, tmp_path):  # noqa: F811
    """A ``--vgg_train`` run's ``.pth`` loads into vqa_tpu (``from_torch``)
    with the trained VGG parameters and running stats equal."""
    out = main(["--mode", "train", *_cli(cli_data, "vt_pth", "--vgg_train", "true",
                                         "--save_interval", "4")])
    model, _ = build_model("attention", V, K, opt_lvl=0, device="cpu", vgg_trainable=True)
    model.load_state_dict(t_ckpt.load_params_only(os.path.join(out["log_dir"],
                                                                "model_4.ckpt")))
    path = t_ckpt.export_pth(model, str(tmp_path / "vt.pth"))
    params, stats = j_from_torch("attention", load_torch_state_dict(path))
    back = from_jax("attention", _np(params), _np(stats))
    sd = model.state_dict()
    for k in _vgg_keys(model):
        np.testing.assert_array_equal(np.asarray(back[k]), sd[k].numpy(), err_msg=k)
    shutil.rmtree(out["log_dir"])


def test_cli_bn_mode_batch_moves_only_running_stats(cli_data):  # noqa: F811
    out = main(["--mode", "train", *_cli(cli_data, "bn_batch", "--bn_mode", "batch",
                                         "--save_interval", "4")])
    assert out["steps"] == 4 and np.isfinite(out["losses"]).all()
    trained = t_ckpt.load_params_only(os.path.join(out["log_dir"], "model_4.ckpt"))
    init, _ = build_model("attention", V, K, opt_lvl=0, device="cpu",
                          generator=torch.Generator().manual_seed(0))
    for k in _vgg_keys(init):
        stat = k.endswith(("running_mean", "running_var"))
        assert torch.equal(trained[k], init.state_dict()[k]) != stat, k
    shutil.rmtree(out["log_dir"])


def test_cli_grad_accum(cli_data):  # noqa: F811
    out = main(["--mode", "train", *_cli(cli_data, "accum", "--grad_accum", "2")])
    assert out["steps"] == 4 and np.isfinite(out["losses"]).all()
    with pytest.raises(SystemExit, match="must divide"):
        main(["--mode", "train", *_cli(cli_data, "accum3", "--grad_accum", "3")])
    shutil.rmtree(out["log_dir"])


def test_cli_profile_steps_writes_trace(cli_data, capsys):  # noqa: F811
    out = main(["--mode", "train", *_cli(cli_data, "prof", "--profile_steps", "2")])
    traces = [f for f in os.listdir(out["log_dir"]) if f.endswith(".pt.trace.json")]
    assert traces == ["profile_steps_4-5.pt.trace.json"]
    assert os.path.getsize(os.path.join(out["log_dir"], traces[0])) > 0
    assert f"profiler trace written to {out['log_dir']}" in capsys.readouterr().out
    shutil.rmtree(out["log_dir"])


def test_cli_vgg_train_with_int8_fails(cli_data):  # noqa: F811
    with pytest.raises(ValueError, match="frozen VGG"):
        main(["--mode", "train", *_cli(cli_data, "x", "--vgg_train", "true",
                                       "--int8_backbone", "true")])
    with pytest.raises(ValueError, match="frozen VGG"):
        jax_build("attention", V, K, vgg_trainable=True, int8_backbone=True)
