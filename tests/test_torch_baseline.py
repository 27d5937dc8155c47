"""Port baseline model (vqa_tpu_torch.models.baseline) vs vqa_tpu's, on the CPU.

One flax init goes to both packages (``models.convert.from_jax``, or a
``.pth`` from vqa_tpu's ``save_pth``), with BatchNorm stats whose fold is
exactly rounded in both (``test_torch_vgg.parity_safe_variables``). Images,
questions and labels come from a numpy seed. The baseline runs at full
width (word_emb 300, GRU 1024, the VGG head 25,088 -> 4,096 -> 4,096) with a
small vocabulary and answer set.

Tolerances: eval logits within 1e-5 at fp32, at 64² (the adaptive pool
spreads a 2x2 map over 7x7) and at 224² (the pool is the identity; fc0 reads
the map in the reference's CHW order); the GRU within 1e-5; the 10-step loss
trajectory within 2e-3 (the bound of tests/test_train_parity.py), against a
step written here: ``jax.grad`` over ``apply(train=False)`` and vqa_tpu's
own optimizer, with the port's dropouts set to p = 0 (vqa_tpu's train=False
has none). The weight bridge is exact.
"""

import os
import subprocess
import sys

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_vgg import parity_safe_variables
from vqa_tpu.config import build_model as jax_build
from vqa_tpu.models.convert import from_torch as j_from_torch
from vqa_tpu.models.convert import load_torch_state_dict, save_pth, to_torch
from vqa_tpu.models.layers import GRU as JaxGRU
from vqa_tpu.train.state import make_optimizer as j_make_optimizer
from vqa_tpu_torch.config import build_model
from vqa_tpu_torch.models import layers
from vqa_tpu_torch.models.convert import from_jax, load_pth
from vqa_tpu_torch.train import checkpoint as t_ckpt
from vqa_tpu_torch.train import steps as t_steps
from vqa_tpu_torch.train.state import create_train_state

V, K, L, B = 30, 5, 6, 2
LR = 1e-3
N_STEPS = 10


def _inputs(size, seed=0, b=B):
    rng = np.random.default_rng(seed)
    q = rng.integers(1, V, (b, L)).astype(np.int32)
    lens = rng.integers(1, L + 1, (b,)).astype(np.int32)
    lens[0] = L
    for i, k in enumerate(lens):
        q[i, k:] = 0
    return {"image": rng.standard_normal((b, size, size, 3)).astype(np.float32),
            "question": q, "ques_len": lens,
            "label": rng.integers(0, K, (b,)).astype(np.int32)}


def _t(batch):
    return {"image": torch.from_numpy(batch["image"]),
            **{k: torch.from_numpy(batch[k]).long() for k in ("question", "ques_len", "label")}}


@pytest.fixture(scope="module")
def jax_baseline():
    model, _ = jax_build("baseline", V, K, opt_lvl=0)
    params, stats = parity_safe_variables(model, seed=7, size=64, seq=L)
    return model, params, stats


def _port(params, stats, **kw):
    model, _ = build_model("baseline", V, K, opt_lvl=0, device="cpu", **kw)
    model.load_state_dict(from_jax("baseline", params, stats), strict=True)
    return model.eval()


def _jax_logits(model, params, stats, batch):
    return np.asarray(model.apply({"params": params, "batch_stats": stats},
                                  jnp.asarray(batch["image"]), jnp.asarray(batch["question"]),
                                  jnp.asarray(batch["ques_len"]), train=False))


@pytest.mark.parametrize("size", [64, 224])
def test_eval_logits_match(jax_baseline, size):
    model, params, stats = jax_baseline
    batch = _inputs(size, seed=size)
    ref = _jax_logits(model, params, stats, batch)
    port = _port(params, stats)
    b = _t(batch)
    with torch.no_grad():
        out = port(b["image"], b["question"], b["ques_len"]).numpy()
        feats = port.frozen_features(b["image"])
    assert out.shape == (B, K) and tuple(feats.shape) == (B, 4096)
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


def test_adaptive_pool_windows_match():
    from vqa_tpu.models.vgg import adaptive_avg_pool as j_pool
    from vqa_tpu_torch.models.vgg import adaptive_avg_pool

    x = np.random.default_rng(3).standard_normal((2, 3, 5, 4)).astype(np.float32)
    ref = np.asarray(j_pool(jnp.asarray(x), (7, 7)))
    np.testing.assert_allclose(adaptive_avg_pool(torch.from_numpy(x), (7, 7)).numpy(), ref,
                               rtol=1e-6, atol=1e-6)
    same = torch.from_numpy(x[:, :3, :3])
    assert adaptive_avg_pool(same, (3, 3)) is same


@pytest.mark.parametrize("lengths", [[1, 1, 1], [L, L, L], [1, 3, L]],
                         ids=["all_1", "all_max", "mixed"])
def test_gru_last_valid_hidden_matches(lengths):
    rng = np.random.default_rng(len(lengths) + sum(lengths))
    x = rng.standard_normal((3, L, 12)).astype(np.float32)
    lens = np.asarray(lengths, np.int32)
    jm = JaxGRU(16)
    p = jm.init(jax.random.PRNGKey(1), jnp.asarray(x), jnp.asarray(lens))["params"]
    ref = np.asarray(jm.apply({"params": p}, jnp.asarray(x), jnp.asarray(lens)))
    gru = layers.GRU(12, 16)
    with torch.no_grad():
        gru.weight_ih_l0.copy_(torch.from_numpy(np.asarray(p["w_ih"]).T.copy()))
        gru.weight_hh_l0.copy_(torch.from_numpy(np.asarray(p["w_hh"]).T.copy()))
        gru.bias_ih_l0.copy_(torch.from_numpy(np.array(p["b_ih"])))
        gru.bias_hh_l0.copy_(torch.from_numpy(np.array(p["b_hh"])))
        out = gru(torch.from_numpy(x), torch.from_numpy(lens).long()).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
    # what follows the last valid step does not matter
    x2 = x.copy()
    for i, k in enumerate(lens):
        x2[i, k:] = 9.0
    with torch.no_grad():
        out2 = gru(torch.from_numpy(x2), torch.from_numpy(lens).long()).numpy()
    np.testing.assert_array_equal(out2, out)


def test_from_jax_equals_vqa_tpu_export(jax_baseline):
    _, params, stats = jax_baseline
    ref = to_torch("baseline", params, stats)
    sd = from_jax("baseline", params, stats)
    assert set(sd) == set(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(sd[k].numpy(), np.asarray(v), err_msg=k)
    # the baseline's embedding is not masked: row 0 is exported as it is
    emb = params["question_encoder"]["word_embedding"]["embedding"]
    np.testing.assert_array_equal(sd["question_encoder.word_embedding.0.weight"][0].numpy(),
                                  emb[0])
    assert np.abs(emb[0]).max() > 0


def test_pth_both_ways(jax_baseline, tmp_path):
    """vqa_tpu's save_pth loads into the port with strict=True, and the
    port's export loads back into vqa_tpu's from_torch to the same trees."""
    _, params, stats = jax_baseline
    path = str(tmp_path / "jax.pth")
    save_pth(path, "baseline", params, stats)
    port, _ = build_model("baseline", V, K, opt_lvl=0, device="cpu",
                          generator=torch.Generator().manual_seed(5))
    port.load_state_dict(load_pth(path), strict=True)
    out = str(tmp_path / "port.pth")
    t_ckpt.export_pth(port, out)
    p2, s2 = j_from_torch("baseline", load_torch_state_dict(out))
    flat = jax.tree_util.tree_leaves_with_path
    a, b = dict(flat(params)), dict(flat(p2))
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(np.asarray(b[k]), np.asarray(a[k]), err_msg=str(k))
    for (ka, va), (kb, vb) in zip(flat(stats), flat(s2)):
        assert ka == kb
        np.testing.assert_array_equal(np.asarray(vb), np.asarray(va))
    for f in (path, out):           # 0.5 GB each (the VGG head)
        os.remove(f)


def _jax_trajectory(model, params, stats, batches):
    tx = j_make_optimizer(LR, params, False)
    opt = tx.init(params)

    def loss_fn(p, b):
        logits = model.apply({"params": p, "batch_stats": stats}, b["image"], b["question"],
                             b["ques_len"], train=False)
        return optax.softmax_cross_entropy_with_integer_labels(logits, b["label"]).mean()

    @jax.jit
    def step(p, o, b):
        loss, g = jax.value_and_grad(loss_fn)(p, b)
        updates, o = tx.update(g, o, p)
        return optax.apply_updates(p, updates), o, loss

    losses = []
    for i in range(N_STEPS):
        params, opt, loss = step(params, opt, {k: jnp.asarray(v)
                                               for k, v in batches[i % 3].items()})
        losses.append(float(loss))
    return losses


def _no_dropout(model):
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0


def test_ten_step_trajectory_matches(jax_baseline):
    model, params, stats = jax_baseline
    batches = [_inputs(32, seed=100 + i) for i in range(3)]
    j_losses = _jax_trajectory(model, params, stats, batches)
    port = _port(params, stats)
    _no_dropout(port)
    state = create_train_state(port, LR)
    step = t_steps.make_train_step()
    t_losses = [float(step(state, _t(batches[i % 3]))["loss"]) for i in range(N_STEPS)]
    np.testing.assert_allclose(t_losses, j_losses, rtol=2e-3, atol=2e-3,
                               err_msg=f"jax={j_losses}\ntorch={t_losses}")
    assert t_losses[0] != t_losses[-1]
    trained = {id(p) for g in state.optimizer.param_groups for p in g["params"]}
    for name, p in port.named_parameters():
        frozen = name.startswith("image_encoder.vgg11_encoder.")
        assert p.requires_grad != frozen and (id(p) in trained) != frozen, name


def test_dropout_live_in_train_mode_and_seeded(jax_baseline):
    """The VGG head's two dropouts and the fusion's are live in train mode
    (zeros, kept values doubled), off in eval mode; the same generator seed
    draws the same masks."""
    _, params, stats = jax_baseline
    port = _port(params, stats)
    drops = [m for m in port.modules() if isinstance(m, layers.Dropout)]
    assert len(drops) == 3
    seen = {}
    for i, m in enumerate(drops):
        m.register_forward_hook(lambda mod, inp, out, i=i: seen.__setitem__(i, (inp[0], out)))
    b = _t(_inputs(32, seed=3))

    def run(seed):
        layers.set_dropout_generator(port, torch.Generator().manual_seed(seed))
        with torch.no_grad():
            return port(b["image"], b["question"], b["ques_len"])

    port.eval()
    ref = run(0)
    assert all(torch.equal(x, y) for x, y in seen.values())
    port.train()
    a, a2, c = run(0), run(0), run(1)
    for x, y in seen.values():
        live = x != 0
        assert 0.3 < float(((y == 0) & live).sum() / live.sum()) < 0.7
        kept = y != 0
        torch.testing.assert_close(y[kept], 2 * x[kept], rtol=1e-6, atol=0)
    assert torch.equal(a, a2) and not torch.equal(a, c) and not torch.equal(a, ref)


def test_entry_points_default_to_cuda_and_fail_without_card():
    """``main`` for both new families and ``profile_train --model`` take
    the card by default; without one they exit non-zero, never on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    runs = [["vqa_tpu_torch.main", "--mode", "train", "--model", m, "--expt_dir", "x",
             "--expt_name", "e", "--run_name", "r"] for m in ("baseline", "bert")]
    runs.append(["vqa_tpu_torch.profile_train", "--model", "baseline"])
    for args in runs:
        proc = subprocess.run([sys.executable, "-m", *args], cwd=repo, capture_output=True,
                              text=True, timeout=120)
        assert proc.returncode != 0, args
        assert "no CUDA device" in proc.stderr, args
