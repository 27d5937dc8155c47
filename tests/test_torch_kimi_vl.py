"""The ``kimi_vl`` head (``vqa_tpu_torch/models/kimi_vl.py``) against the
benchmark's plain reference (``vqabench/reference/kimi_vl.py``) at a tiny
size on the CPU, in float32, on seeded weights in the reference's layout.

The tiny decoder keeps the published hyperparameters that are no widths
(6 of the routed experts a token, the scaling 2.446, RoPE's theta, the
norms' eps) and shrinks every width. Tolerances: both sides compute in
IEEE float32 in another order (SDPA against an explicit softmax, the
grouped products against a loop over experts), so values agree to about
1e-6 of their scale; 1e-4 leaves room and is far below the effect of any
term left out (the balance loss moves the router's gradient by more).

The grouped products run as the library's grouped GEMM only on the card
in bf16: their test there is marked ``cuda`` (``python -m pytest
--noconftest -p no:cacheprovider tests/test_torch_kimi_vl.py -m cuda``).
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode

from vqa_tpu_torch import config
from vqa_tpu_torch.config import build_model
from vqa_tpu_torch.models import kimi_vl
from vqa_tpu_torch.ops import moe_gmm
from vqa_tpu_torch.train.state import create_train_state
from vqa_tpu_torch.train.steps import cross_entropy_loss, make_train_step
from vqabench.reference import kimi_vl as ref
from vqabench.reference import weights

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "vqabench", "configs", "kimi-vl-a3b-448.json")
TINY = dict(hidden_size=32, num_hidden_layers=3, first_k_dense_replace=1, intermediate_size=48,
            moe_intermediate_size=16, num_attention_heads=2, qk_nope_head_dim=8,
            qk_rope_head_dim=4, v_head_dim=8, kv_lora_rank=16, n_routed_experts=16,
            experts_held=8, n_shared_experts=2)
VOCAB, K, IMAGE, B, L = 40, 9, 64, 5, 6
TOL = 1e-4


def _cfg(**over):
    return {"model": "kimi_vl", "image_size": IMAGE, "vocab_size": VOCAB, "num_classes": K,
            "max_seq_length": L, "opt_lvl": 0, "num_experts_per_tok": 6, **TINY, **over}


def _inputs(seed=3):
    g = torch.Generator().manual_seed(seed)
    lens = torch.tensor([1, 6, 3, 2, 5])
    ids = torch.randint(1, VOCAB, (B, L), generator=g) * (torch.arange(L)[None] < lens[:, None])
    feats = 0.4 * torch.randn(B, (IMAGE // 32) ** 2, 512, generator=g)
    labels = torch.randint(0, K, (B,), generator=g)
    return feats, ids, lens, labels


@pytest.fixture
def tiny(monkeypatch):
    """The registry's ``kimi_vl`` at TINY's sizes and a 64² image."""
    monkeypatch.setitem(config.MODEL_CONFIGS, "kimi_vl", dataclasses.replace(
        config.MODEL_CONFIGS["kimi_vl"], image_size=IMAGE,
        question_params={**config.MODEL_CONFIGS["kimi_vl"].question_params, **TINY}))


def _model(w):
    m, _ = build_model("kimi_vl", VOCAB, K, device="cpu", opt_lvl=0, int8_backbone=False)
    m.load_state_dict(w, strict=True)
    return m


def _rel(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm())


def test_registry_defaults_are_the_configuration():
    """``build_model("kimi_vl")``'s sizes, and the reference's constants,
    are those of ``vqabench/configs/kimi-vl-a3b-448.json``."""
    with open(CONFIG) as f:
        cfg = json.load(f)
    reg = config.MODEL_CONFIGS["kimi_vl"]
    assert reg.image_size == cfg["image_size"]
    for key, value in reg.question_params.items():
        assert value == cfg[key], key
    assert (ref.TOP_K, ref.ROUTED_SCALE, ref.ROPE_THETA, ref.RMS_EPS) == (
        cfg["num_experts_per_tok"], cfg["routed_scaling_factor"], cfg["rope_theta"],
        cfg["rms_norm_eps"])
    assert (cfg["n_routed_experts"], cfg["experts_held"], cfg["q_lora_rank"]) == (64, 32, None)
    assert (kimi_vl.KV_NORM_EPS, kimi_vl.BALANCE_ALPHA, kimi_vl.BIAS_GAMMA) == (
        ref.KV_NORM_EPS, ref.BALANCE_ALPHA, ref.BIAS_GAMMA)
    assert (cfg["scoring_func"], cfg["topk_method"], cfg["n_group"]) == ("sigmoid", "noaux_tc", 1)


def test_training_step_matches_the_reference(monkeypatch, tiny):
    """One step of the shared train step (on cached features) against the
    reference's training forward in blocks of 2 samples: the logits, the
    loss with the balance loss, every trained leaf's gradient, and each
    router's selection bias after the step."""
    monkeypatch.setattr(ref, "BLOCK", 2)
    cfg = _cfg()
    w = weights.make(cfg, 17, "cpu")
    model = _model(w)
    feats, ids, lens, labels = _inputs()
    with torch.no_grad():
        got = model.head(feats, ids, lens)
        want = ref.logits(w, feats.view(B, 2, 2, 512), ids, lens)
    assert _rel(got, want) < TOL
    state = create_train_state(model, 1e-3)
    out = make_train_step(image_is_features=True)(
        state, {"image": feats, "question": ids, "ques_len": lens, "label": labels})
    params = {k: v.clone().requires_grad_() for k, v in w.items() if ref.trainable(k)}
    frozen = {k: v for k, v in w.items() if not ref.trainable(k)}
    balance = ref.balance_loss({**frozen, **params}, feats.view(B, 2, 2, 512), ids, lens)
    logits = ref.logits({**frozen, **params}, feats.view(B, 2, 2, 512), ids, lens)
    loss = F.cross_entropy(logits, labels)
    assert abs(float(out["loss"]) - float(loss.detach())) < TOL * float(loss.detach())
    got_balance = float(model.balance_loss())      # the step's forward's
    assert abs(got_balance - float(balance.detach())) < TOL * float(balance.detach())
    assert float(balance.detach()) > 1e-5
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    named = dict(model.named_parameters())
    assert set(grads) == {n for n, p in named.items() if p.requires_grad}
    for name, g in grads.items():
        if g.norm() > 0:
            assert _rel(named[name].grad, g) < TOL, name
    biases = [k for k in w if k.endswith(ref.SELECTION_BIAS)]
    assert len(biases) == 2
    sd = model.state_dict()
    for k in biases:
        assert torch.equal(sd[k], w[k]), k
        assert w[k].abs().max() == ref.BIAS_GAMMA


def test_balance_loss_gradient_matches_the_reference(tiny):
    """The balance loss alone, and its gradient in each router's weight
    (the only leaf it reaches: the choice of experts has none), against the
    reference's. At alpha 1e-4 the term moves the routers' whole gradient
    by less than 1e-4, so it gets its own comparison."""
    cfg = _cfg()
    w = weights.make(cfg, 17, "cpu")
    model = _model(w)
    feats, ids, lens, _ = _inputs()
    model.head(feats, ids, lens)
    aux = model.balance_loss()
    routers = [m.router.weight for m in model.moe_layers()]
    got = torch.autograd.grad(aux, routers)
    params = {k: v.clone().requires_grad_() for k, v in w.items() if ref.trainable(k)}
    frozen = {k: v for k, v in w.items() if not ref.trainable(k)}
    want_aux = ref.balance_loss({**frozen, **params}, feats.view(B, 2, 2, 512), ids, lens)
    keys = [k for k in params if k.endswith("router.weight")]
    want = torch.autograd.grad(want_aux, [params[k] for k in keys])
    assert abs(float(aux.detach()) - float(want_aux.detach())) < TOL * float(want_aux.detach())
    for a, b in zip(got, want):
        assert b.norm() > 0 and _rel(a, b) < TOL


def test_expert_shares_add_up_to_the_whole_layer():
    """Two layers holding experts 0-7 and 8-15 of 16: their outputs less the
    shared experts counted twice equal the reference's uncut layer."""
    d, wd, e = TINY["hidden_size"], TINY["moe_intermediate_size"], TINY["n_routed_experts"]
    g = torch.Generator().manual_seed(5)
    whole = {"router.weight": torch.randn(e, d, generator=g) / d ** 0.5,
             "router.e_score_correction_bias": 0.1 * torch.randn(e, generator=g),
             "experts.gate_up": torch.randn(e, 2 * wd, d, generator=g) / d ** 0.5,
             "experts.down": torch.randn(e, d, wd, generator=g) / wd ** 0.5,
             "shared.gate_up.weight": torch.randn(4 * wd, d, generator=g) / d ** 0.5,
             "shared.down.weight": torch.randn(d, 2 * wd, generator=g) / wd ** 0.5}
    x = torch.randn(B, L, d, generator=g)
    valid = torch.ones(B, L, dtype=torch.bool)
    want = ref.moe({f"m.{k}": v for k, v in whole.items()}, "m.", x, valid,
                   whole["router.e_score_correction_bias"], ref.F32)[0]
    total = -ref.swiglu(whole, "shared.", x, ref.F32)
    for first in (0, e // 2):
        layer = kimi_vl.MoE(1, d, wd, e, e // 2, first, 2, 6, ref.ROUTED_SCALE)
        part = {k: v[first:first + e // 2] if k.startswith("experts.") else v
                for k, v in whole.items()}
        layer.load_state_dict(part, strict=True)
        with torch.no_grad():
            total = total + layer(x, valid, torch.float32)
    assert _rel(total, want) < TOL


def test_plan_covers_every_row_once():
    """A plan's rows are the pairs routed to held experts, each once, in
    one segment an expert and in pair order within it; ``row`` inverts
    ``order``; the pairs of experts not held have no row and are counted
    last."""
    g = torch.Generator().manual_seed(2)
    for n, first, held in ((700, 0, 8), (331, 8, 8), (5, 0, 4)):
        experts = torch.stack([torch.randperm(16, generator=g)[:6] for _ in range(n)])
        p = moe_gmm.plan(experts, first, held)
        local = experts.reshape(-1) - first
        mine = (local >= 0) & (local < held)
        assert torch.equal(p.held_pair, mine)
        assert p.rows == int(mine.sum()) == p.bounds[-1] == int(p.ends[-1])
        assert p.ends.dtype == torch.int32 and p.ends.tolist() == p.bounds[1:]
        assert p.counts.tolist() == [int((local == e).sum()) for e in range(held)] + [
            int((~mine).sum())]
        assert sorted(p.order.tolist()) == torch.nonzero(mine).flatten().tolist()
        for e in range(held):
            seg = p.order[p.bounds[e]:p.bounds[e + 1]]
            assert torch.all(local[seg] == e) and torch.all(seg[1:] > seg[:-1])
        assert torch.equal(p.row[p.order], torch.arange(p.rows))


def test_a_layer_with_no_held_pair_returns_its_shared_experts():
    """Where no token routes to an expert the layer holds, its output is
    the shared experts' alone (the plan has no rows)."""
    d, wd = TINY["hidden_size"], TINY["moe_intermediate_size"]
    layer = kimi_vl.MoE(1, d, wd, 16, 8, 8, 2, 6, ref.ROUTED_SCALE)
    g = torch.Generator().manual_seed(4)
    for name, t in layer.state_dict().items():
        t.copy_(torch.randn(t.shape, generator=g) / d ** 0.5)
    with torch.no_grad():
        layer.router.e_score_correction_bias.copy_(torch.tensor([9.0] * 8 + [0.0] * 8))
    x = torch.randn(2, 3, d, generator=g)
    out = layer(x, torch.ones(2, 3, dtype=torch.bool), torch.float32)
    assert torch.equal(out, layer.shared(x.reshape(6, d)).view(2, 3, d))


def test_predictor_end_to_end(tiny, tmp_path):
    """``VQAPredictor("kimi_vl")`` through a checkpoint: its probabilities
    are the model's softmax, and a reloaded predictor gives the same."""
    from vqa_tpu_torch.serve import VQAPredictor
    from vqa_tpu_torch.vocab import Vocab

    words = ["<PAD>", "<UNKNOWN>", "is", "the", "cat", "red"]
    vocab = Vocab(word2idx={w: i for i, w in enumerate(words)}, idx2word=dict(enumerate(words)),
                  label2idx={"UNKNOWN": 0, "yes": 1, "no": 2},
                  idx2label={0: "UNKNOWN", 1: "yes", 2: "no"}, max_seq_length=L)
    kw = dict(batch_size=2, synthetic_images=True, opt_lvl=0, device="cpu")
    pred = VQAPredictor("kimi_vl", vocab, **kw)
    qs = ["is,the,cat,red", "is,cat", "the,cat,is,the,red,cat"]
    paths = [str(tmp_path / f"{i}.jpg") for i in range(3)]
    probs = pred.predict_probs(paths, qs)
    assert probs.shape == (3, 3)
    np.testing.assert_allclose(probs.sum(1), 1.0, rtol=1e-5)
    ckpt = str(tmp_path / "kimi.pth")
    torch.save(pred.model.state_dict(), ckpt)
    again = VQAPredictor("kimi_vl", vocab, ckpt, **kw)
    np.testing.assert_array_equal(again.predict_probs(paths, qs), probs)
    out = pred.predict(paths, qs, top_k=2)
    assert [r["answer"] for r in out] == [vocab.idx2label[int(i)] for i in probs.argmax(1)]


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("name", ["baseline", "attention", "bert"])
def test_other_models_launch_nothing_new_in_the_step(name):
    """The shared step runs, for a model without routed experts, exactly
    the operators of forward, cross-entropy, backward and Adam."""
    model, _ = build_model(name, 30, 5, device="cpu", opt_lvl=0, int8_backbone=False,
                           max_seq_length=4)
    state = create_train_state(model, 1e-4)
    g = torch.Generator().manual_seed(0)
    batch = {"image": torch.randn(2, 32, 32, 3, generator=g),
             "question": torch.tensor([[2, 3, 0, 0], [4, 5, 6, 0]]),
             "ques_len": torch.tensor([2, 3]), "label": torch.tensor([1, 4])}
    step = make_train_step()
    step(state, batch)

    def by_hand():
        model.train()
        state.optimizer.zero_grad(set_to_none=True)
        logits = model(batch["image"], batch["question"], batch["ques_len"])
        loss = cross_entropy_loss(logits, batch["label"])
        loss.backward()
        (logits.detach().argmax(dim=-1) == batch["label"]).float().mean()
        loss.detach()
        state.optimizer.step()

    with _Ops() as want:
        by_hand()
    with _Ops() as got:
        out = step(state, batch)
    assert got.names == want.names
    assert set(out) == {"loss", "accuracy"}


def _worst_row(a, b):
    """The largest relative distance of a row of ``a`` from ``b``'s."""
    a, b = a.detach().double().flatten(0, -2), b.double().flatten(0, -2)
    return float(((a - b).norm(dim=-1) / b.norm(dim=-1).clamp_min(1e-30)).max())


@pytest.mark.cuda
def test_grouped_products_on_the_card():
    """At the training cell's expert shapes (a quarter of its rows), bf16:
    the library's grouped GEMM, one launch each for the forward and both
    gradients, against the plain version in float32 on the same operands,
    row by row within bf16's rounding (a wrong tile of 128 columns moves
    its rows by a fifth). In float32 the plain version runs (no launch)
    and stays IEEE: within 1e-6 of float64."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the grouped products run as a CUDA library kernel)")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    n, d, w, held = 8760, 2048, 1408, 32
    experts = torch.rand(n, 64, generator=g, device=dev).topk(6).indices
    p = moe_gmm.plan(experts, 0, held)
    x = torch.randn(p.rows, d, generator=g, device=dev).bfloat16().requires_grad_()
    wt = (torch.randn(held, 2 * w, d, generator=g, device=dev) / d ** 0.5).requires_grad_()
    before = moe_gmm.LAUNCHES
    y = moe_gmm.grouped_mm(x, wt, p)
    gy = torch.randn_like(y)
    y.backward(gy)
    assert moe_gmm.LAUNCHES - before == 3
    xf, wf, gf = x.detach().float(), wt.detach().bfloat16().float(), gy.float()
    assert _worst_row(y, moe_gmm._rows(xf, wf, p, transposed=True)) < 1e-2
    assert _worst_row(x.grad, moe_gmm._rows(gf, wf, p, transposed=False)) < 1e-2
    assert _worst_row(wt.grad, moe_gmm._wgrad(gf, xf, p)) < 1e-2
    sub = moe_gmm.plan(experts[:600], 0, held)
    x32 = torch.randn(sub.rows, d, generator=g, device=dev)
    before = moe_gmm.LAUNCHES
    y32 = moe_gmm.grouped_mm(x32, wf, sub)
    assert moe_gmm.LAUNCHES == before
    assert _worst_row(y32, moe_gmm._rows(x32.double(), wf.double(), sub, transposed=True)) < 1e-6


def _event(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": 1}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def test_expert_readers_on_a_hand_made_trace(monkeypatch):
    """``expert_ms`` sums the kernels launched inside ``vqa.model.experts``
    (the forward's span and the backward's, on another thread), and no
    other, whatever its name, a step; ``expert_roofline`` divides the least
    time, at the held rows the counters give, by it; ``route_imbalance`` is
    the worst layer's busiest held expert over its mean; each gives None
    where the program has nothing to read."""
    from vqabench import tracing
    from vqabench.metrics import _work_moe
    from vqa_tpu_torch.train import profiling

    events = [_event("user_annotation", "vqa.model.experts", 0, 10),
              _event("cuda_driver", "cuLaunchKernelEx", 2, 1, 1),
              _event("kernel", "cutlass_grouped_gemm", 20, 300, 1),
              _event("cuda_runtime", "cudaLaunchKernel", 12, 1, 2),
              _event("kernel", "silu", 330, 50, 2),
              _event("user_annotation", "vqa.model.experts", 495, 10),
              _event("cuda_driver", "cuLaunchKernelEx", 500, 1, 3),
              _event("kernel", "cutlass_grouped_gemm_tn", 510, 700, 3),
              _event("cuda_driver", "cuLaunchKernelEx", 600, 1, 4),
              _event("kernel", "cutlass_grouped_gemm", 1300, 400, 4)]
    with open(CONFIG) as f:
        cfg = json.load(f)
    ctx = tracing.TraceContext(events=events, steps=2, window_s=1.0, wall_s_per_step=0.5,
                               config=cfg, batch=160, kind="train")
    assert _work_moe.expert_ms(ctx) == pytest.approx(0.5)
    monkeypatch.setattr(profiling, "COUNTERS", {})
    ops, moved = _work_moe.expert_work(cfg, 160)
    assert ops == pytest.approx(3 * 4 * 2 * 160 * 219 * 6 * 32 / 64 * 3 * 2048 * 1408)
    assert ops / moved > 295        # above the card's ridge: bound by the operations
    assert _work_moe.expert_roofline(ctx) == pytest.approx(100 * (ops / 989e12) / 0.5e-3)
    spanless = [e for e in events if e["cat"] != "user_annotation"]
    none = tracing.TraceContext(events=spanless, steps=2, window_s=1.0, wall_s_per_step=0.5,
                                config=cfg, batch=160, kind="train")
    assert _work_moe.expert_ms(none) is None and _work_moe.expert_roofline(none) is None
    assert _work_moe.route_imbalance(ctx) is None and _work_moe.held_shares() is None
    # two layers of 4 held experts, the pairs of experts not held last
    profiling.count("vqa.model.expert_rows.1", torch.tensor([3, 3, 3, 3, 12]))
    profiling.count("vqa.model.expert_rows.2", torch.tensor([1, 2, 3, 6, 0]))
    profiling.count("vqa.model.expert_rows.2", torch.tensor([1, 2, 3, 6, 0]))
    assert profiling.counter("vqa.model.expert_rows.2") == [2, 4, 6, 12, 0]
    assert _work_moe.route_imbalance(ctx) == pytest.approx(2.0)
    assert _work_moe.held_shares() == pytest.approx([0.5, 1.0])
    held_ops, _ = _work_moe.expert_work(cfg, 160, [0.5, 1.0])
    assert held_ops == pytest.approx(ops * (0.5 + 1.0) / 2)
    assert _work_moe.expert_roofline(ctx) == pytest.approx(100 * (held_ops / 989e12) / 0.5e-3)
