"""Port bert model (vqa_tpu_torch.models.bert) vs vqa_tpu's, on the CPU.

A narrow bert (2 blocks, hidden 64, 4 heads, max_len 64) over the full VGG
tower and fusion head. One flax init goes to both packages: bert has no
reference format, so the bridge is vqa_tpu's flat ``params.*`` /
``batch_stats.*`` dict (``bert_to_torch``), which the port maps onto its
module and back (``models.convert.bert_flat_to_port`` / ``bert_port_to_flat``).
BatchNorm stats are drawn where both packages' folds round alike
(``test_torch_vgg.parity_safe_variables``); inputs come from a numpy seed.

Tolerances as for the baseline (tests/test_torch_baseline.py): eval logits
within 1e-5 at fp32, the 10-step trajectory within 2e-3 with dropout off on
both sides; the padding's content changes nothing, bit for bit; the weight
bridge and the HF graft are exact.
"""

import os

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_vgg import parity_safe_variables
from vqa_tpu.models.bert import VQABertNet as JaxBertNet
from vqa_tpu.models.bert import bert_from_hf_state_dict as j_from_hf
from vqa_tpu.models.convert import from_torch as j_from_torch
from vqa_tpu.models.convert import load_torch_state_dict, save_pth, to_torch
from vqa_tpu.train.state import make_optimizer as j_make_optimizer
from vqa_tpu_torch.models import layers
from vqa_tpu_torch.models.bert import VQABertNet, bert_from_hf_state_dict
from vqa_tpu_torch.models.convert import bert_flat_to_port, from_jax, load_pth
from vqa_tpu_torch.train import checkpoint as t_ckpt
from vqa_tpu_torch.train import steps as t_steps
from vqa_tpu_torch.train.state import create_train_state

V, K, L, B = 30, 5, 6, 3
HIDDEN, BLOCKS, HEADS = 64, 2, 4
LR = 1e-3
N_STEPS = 10


def _inputs(size, seed=0, b=B):
    rng = np.random.default_rng(seed)
    q = rng.integers(1, V, (b, L)).astype(np.int32)
    lens = rng.integers(1, L + 1, (b,)).astype(np.int32)
    lens[0], lens[1] = L, 1
    for i, k in enumerate(lens):
        q[i, k:] = 0
    return {"image": rng.standard_normal((b, size, size, 3)).astype(np.float32),
            "question": q, "ques_len": lens,
            "label": rng.integers(0, K, (b,)).astype(np.int32)}


def _t(batch):
    return {"image": torch.from_numpy(batch["image"]),
            **{k: torch.from_numpy(batch[k]).long() for k in ("question", "ques_len", "label")}}


@pytest.fixture(scope="module")
def jax_bert():
    model = JaxBertNet(vocab_size=V, K=K, hidden_dim=HIDDEN, num_layers=BLOCKS,
                       num_heads=HEADS, max_len=64, conv0_pallas=True)
    params, stats = parity_safe_variables(model, seed=9, size=32, seq=L)
    return model, params, stats


def _port(params=None, stats=None):
    model = VQABertNet(V, K, hidden_dim=HIDDEN, num_layers=BLOCKS, num_heads=HEADS,
                       max_len=64, conv0_pallas=True)
    if params is not None:
        model.load_state_dict(load_flat(from_jax("bert", params, stats)), strict=True)
    return model.eval()


def load_flat(sd):
    return {k: torch.from_numpy(v) for k, v in bert_flat_to_port(sd).items()}


def _jax_logits(model, params, stats, batch):
    return np.asarray(model.apply({"params": params, "batch_stats": stats},
                                  jnp.asarray(batch["image"]), jnp.asarray(batch["question"]),
                                  jnp.asarray(batch["ques_len"]), train=False))


def _logits(port, batch):
    b = _t(batch)
    with torch.no_grad():
        return port(b["image"], b["question"], b["ques_len"]).numpy()


def test_eval_logits_match(jax_bert):
    model, params, stats = jax_bert
    batch = _inputs(64, seed=1)
    np.testing.assert_allclose(_logits(_port(params, stats), batch),
                               _jax_logits(model, params, stats, batch), rtol=1e-5, atol=1e-5)


def test_padding_content_changes_nothing(jax_bert):
    """Ids past each length (and a length-1 question's whole tail) are
    masked out of attention and pooling: the logits stay bit-equal in the
    port and within 1e-5 of vqa_tpu's on the same garbage."""
    model, params, stats = jax_bert
    port = _port(params, stats)
    batch = _inputs(32, seed=2)
    garbage = dict(batch, question=batch["question"].copy())
    rng = np.random.default_rng(3)
    for i, k in enumerate(batch["ques_len"]):
        garbage["question"][i, k:] = rng.integers(1, V, L - k)
    assert (garbage["question"] != batch["question"]).any()
    out = _logits(port, batch)
    np.testing.assert_array_equal(_logits(port, garbage), out)
    np.testing.assert_allclose(out, _jax_logits(model, params, stats, garbage),
                               rtol=1e-5, atol=1e-5)


def test_flat_format_equals_vqa_tpu_export(jax_bert):
    _, params, stats = jax_bert
    ref = to_torch("bert", params, stats)
    sd = from_jax("bert", params, stats)
    assert set(sd) == set(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(sd[k].numpy(), np.asarray(v), err_msg=k)


def test_pth_both_ways(jax_bert, tmp_path):
    """vqa_tpu's save_pth file loads into the port (strict); the port's
    export is vqa_tpu's flat format and its from_torch reads the same trees."""
    model, params, stats = jax_bert
    path = str(tmp_path / "jax.pth")
    save_pth(path, "bert", params, stats)
    port = _port()
    port.load_state_dict(load_pth(path), strict=True)
    batch = _inputs(32, seed=4)
    np.testing.assert_allclose(_logits(port, batch), _jax_logits(model, params, stats, batch),
                               rtol=1e-5, atol=1e-5)
    out = str(tmp_path / "port.pth")
    t_ckpt.export_pth(port, out)
    exported = load_torch_state_dict(out)
    assert set(exported) == set(to_torch("bert", params, stats))
    p2, s2 = j_from_torch("bert", exported)
    for tree, back in ((params, p2), (stats, s2)):
        a = dict(jax.tree_util.tree_leaves_with_path(tree))
        b = dict(jax.tree_util.tree_leaves_with_path(back))
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(np.asarray(b[k]), np.asarray(a[k]), err_msg=str(k))
    for f in (path, out):           # 0.5 GB each (the VGG head)
        os.remove(f)


def _hf_state_dict(rng, vocab=40, positions=70):
    sd = {"bert.embeddings.word_embeddings.weight": rng.standard_normal((vocab, HIDDEN)),
          "bert.embeddings.position_embeddings.weight": rng.standard_normal((positions, HIDDEN)),
          "bert.embeddings.LayerNorm.weight": rng.standard_normal(HIDDEN),
          "bert.embeddings.LayerNorm.bias": rng.standard_normal(HIDDEN)}
    shapes = {"attention.self.query": (HIDDEN, HIDDEN), "attention.self.key": (HIDDEN, HIDDEN),
              "attention.self.value": (HIDDEN, HIDDEN),
              "attention.output.dense": (HIDDEN, HIDDEN),
              "attention.output.LayerNorm": (HIDDEN,),
              "intermediate.dense": (4 * HIDDEN, HIDDEN), "output.dense": (HIDDEN, 4 * HIDDEN),
              "output.LayerNorm": (HIDDEN,)}
    for i in range(BLOCKS):
        for name, shape in shapes.items():
            sd[f"bert.encoder.layer.{i}.{name}.weight"] = rng.standard_normal(shape)
            sd[f"bert.encoder.layer.{i}.{name}.bias"] = rng.standard_normal(shape[0])
    return {k: v.astype(np.float32) for k, v in sd.items()}


def test_hf_graft_matches_vqa_tpu(jax_bert):
    """The same synthetic HF dict (HF's key names) through both grafts: the
    port's state dict is vqa_tpu's subtree carried over by the weight bridge."""
    _, params, stats = jax_bert
    rng = np.random.default_rng(5)
    hf = _hf_state_dict(rng)
    vocab_map = rng.integers(0, 40, V)
    j_q = j_from_hf(hf, BLOCKS, vocab_map=vocab_map, num_heads=HEADS)
    t_q = bert_from_hf_state_dict(hf, BLOCKS, vocab_map=vocab_map, num_heads=HEADS)
    j_q["position_embedding"] = j_q["position_embedding"][:64]    # the module's table
    t_q["position_embedding"] = t_q["position_embedding"][:64]
    grafted = dict(params, question_encoder={**params["question_encoder"], **j_q})
    ref = load_flat(from_jax("bert", grafted, stats))
    qe = {k[len("question_encoder."):]: v for k, v in ref.items()
          if k.startswith("question_encoder.") and ".embedding_fc." not in k}
    assert set(t_q) == set(qe)
    for k, v in qe.items():
        assert torch.equal(t_q[k], v), k
    port = _port()
    missing = port.question_encoder.load_state_dict(t_q, strict=False).missing_keys
    assert sorted(missing) == ["embedding_fc.bias", "embedding_fc.weight"]
    with pytest.raises(ValueError, match="divisible"):
        bert_from_hf_state_dict(hf, BLOCKS, num_heads=5)


def test_ten_step_trajectory_matches(jax_bert):
    model, params, stats = jax_bert
    batches = [_inputs(32, seed=100 + i) for i in range(3)]
    tx = j_make_optimizer(LR, params, False)

    def loss_fn(p, b):
        logits = model.apply({"params": p, "batch_stats": stats}, b["image"], b["question"],
                             b["ques_len"], train=False)
        return optax.softmax_cross_entropy_with_integer_labels(logits, b["label"]).mean()

    @jax.jit
    def step(p, o, b):
        loss, g = jax.value_and_grad(loss_fn)(p, b)
        updates, o = tx.update(g, o, p)
        return optax.apply_updates(p, updates), o, loss

    p, o, j_losses = params, tx.init(params), []
    for i in range(N_STEPS):
        p, o, loss = step(p, o, {k: jnp.asarray(v) for k, v in batches[i % 3].items()})
        j_losses.append(float(loss))
    port = _port(params, stats)
    for m in port.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    state = create_train_state(port, LR)
    t_step = t_steps.make_train_step()
    t_losses = [float(t_step(state, _t(batches[i % 3]))["loss"]) for i in range(N_STEPS)]
    np.testing.assert_allclose(t_losses, j_losses, rtol=2e-3, atol=2e-3,
                               err_msg=f"jax={j_losses}\ntorch={t_losses}")
    assert t_losses[0] != t_losses[-1]


def test_dropout_live_and_seeded(jax_bert):
    _, params, stats = jax_bert
    port = _port(params, stats)
    assert len([m for m in port.modules() if isinstance(m, layers.Dropout)]) == 3
    batch = _inputs(32, seed=6)

    def run(seed):
        layers.set_dropout_generator(port, torch.Generator().manual_seed(seed))
        return _logits(port, batch)

    port.eval()
    ref = run(0)
    np.testing.assert_array_equal(run(1), ref)
    port.train()
    a = run(0)
    np.testing.assert_array_equal(run(0), a)
    assert not np.array_equal(a, ref) and not np.array_equal(run(1), a)


def test_question_longer_than_position_table_raises():
    port = _port()
    with pytest.raises(ValueError, match="max_len"):
        port.question_encoder(torch.ones((1, 65), dtype=torch.long), torch.tensor([65]))
