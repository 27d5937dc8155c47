"""The port's spans (``vqa_tpu_torch.train.profiling.span``) on the CPU.

The record of nested spans on two threads (name, parent, root, self time),
the log's bound, its summary, that no profiler API is touched while no
profiler records and that a profiler's trace holds the span as a
``user_annotation``; the spans of a tiny attention train step and of a tiny
predictor's batch, once each; and that ``torch.export`` of the attention
and baseline predictors' serving function, while a profiler records,
records no span and captures no profiler op.
"""

import collections
import json
import threading
import time

import numpy as np
import pytest
import torch

from vqa_tpu_torch.config import build_model
from vqa_tpu_torch.export import ServingFunction
from vqa_tpu_torch.serve import VQAPredictor
from vqa_tpu_torch.train import profiling
from vqa_tpu_torch.train.profiling import LOG, SpanLog, span
from vqa_tpu_torch.train.state import create_train_state
from vqa_tpu_torch.train.steps import make_train_step
from vqa_tpu_torch.vocab import PAD_TOKEN, UNK_TOKEN, Vocab

V, K, L, S, B = 30, 4, 6, 32, 2
TRAIN_SPANS = ("vqa.train.step", "vqa.train.forward", "vqa.train.backward",
               "vqa.train.optimizer", "vqa.model.tower", "vqa.model.head", "vqa.model.lstm")
SERVE_SPANS = ("vqa.serve.decode", "vqa.serve.encode", "vqa.serve.forward",
               "vqa.serve.to_device", "vqa.model.tower", "vqa.model.head",
               "vqa.model.lstm", "vqa.serve.to_host")


def _by_name(records):
    out = collections.defaultdict(list)
    for r in records:
        out[r.name].append(r)
    return out


def _nest(log, prefix, pause_s):
    with log.span(f"{prefix}.outer"):
        time.sleep(pause_s)
        with log.span(f"{prefix}.inner"):
            time.sleep(pause_s)
        with log.span(f"{prefix}.inner"):
            time.sleep(pause_s)


@pytest.mark.parametrize("prefix", ["main", "worker"])
def test_nested_spans_on_two_threads(prefix):
    """Each thread nests its own spans while the other's are open: parents
    and roots stay within a thread; self time is the duration less the
    children's."""
    log = SpanLog()
    worker = threading.Thread(target=_nest, args=(log, "worker", 0.01))
    with log.span("main.outer"):
        worker.start()
        with log.span("main.inner"):
            time.sleep(0.01)
        with log.span("main.inner"):
            time.sleep(0.01)
        worker.join(timeout=10)
    assert not worker.is_alive()
    recs = _by_name(log.records())
    (outer,), inners = recs[f"{prefix}.outer"], recs[f"{prefix}.inner"]
    assert outer.parent is None and outer.root == outer.id
    assert len(inners) == 2
    for r in inners:
        assert r.parent == outer.id and r.root == outer.id
        assert outer.start_ns <= r.start_ns < r.end_ns <= outer.end_ns
    assert inners[0].end_ns <= inners[1].start_ns
    selfs = log.self_seconds()
    assert selfs[outer.id] == pytest.approx(outer.seconds - sum(r.seconds for r in inners))
    assert selfs[inners[0].id] == inners[0].seconds
    assert log.durations(f"{prefix}.inner") == [r.seconds for r in inners]


def test_log_is_bounded_and_summarised():
    log = SpanLog(capacity=5)
    for i in range(12):
        with log.span(f"s{i % 2}"):
            pass
    mark = time.perf_counter_ns()
    with log.span("s1"):
        time.sleep(0.002)
    recs = log.records()
    assert len(recs) == 5 and [r.name for r in recs] == ["s0", "s1", "s0", "s1", "s1"]
    assert recs[-1].id == 13
    assert len(log.durations("s1")) == 3
    since = log.summary(since=mark)
    assert list(since) == ["s1"] and since["s1"]["count"] == 1
    assert since["s1"]["median_ms"] == since["s1"]["p95_ms"] >= 2.0
    whole = log.summary()
    assert whole["s0"]["count"] == 2 and whole["s1"]["count"] == 3
    ms = sorted(1e3 * d for d in log.durations("s1"))
    assert whole["s1"]["median_ms"] == ms[1] and ms[1] <= whole["s1"]["p95_ms"] <= ms[2]


@pytest.mark.parametrize("profiler_on", [False, True])
def test_profiler_only_while_one_records(profiler_on, monkeypatch, tmp_path):
    """No profiler API while none records; in a CPU trace the span is a
    ``user_annotation`` around the operator it ran."""
    if not profiler_on:
        def refuse(*args, **kwargs):
            raise AssertionError("a profiler API was touched with no profiler on")
        monkeypatch.setattr(profiling.autograd_profiler, "record_function", refuse)
        mark = time.perf_counter_ns()
        with span("vqa.model.tower"):
            torch.ones(3).add_(1)
        assert [r.name for r in LOG.records(since=mark)] == ["vqa.model.tower"]
        return
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with span("vqa.model.tower"):
            torch.ones(3).add_(1)
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    (ann,) = [e for e in events if e.get("name") == "vqa.model.tower"]
    assert ann["cat"] == "user_annotation"
    adds = [e for e in events if e.get("name") == "aten::add_"]
    assert adds and all(ann["ts"] <= e["ts"] <= ann["ts"] + ann["dur"] for e in adds)


def _batch(rng):
    q = rng.integers(2, V, (B, L))
    lens = rng.integers(2, L + 1, (B,))
    for i, k in enumerate(lens):
        q[i, k:] = 0
    return {"image": torch.from_numpy(rng.standard_normal((B, S, S, 3)).astype(np.float32)),
            "question": torch.from_numpy(q), "ques_len": torch.from_numpy(lens),
            "label": torch.from_numpy(rng.integers(0, K, (B,)))}


def test_train_step_spans_once_a_step():
    torch.manual_seed(0)
    model, _ = build_model("attention", V, K, opt_lvl=0, device="cpu")
    state = create_train_state(model, 1e-3)
    step = make_train_step()
    rng = np.random.default_rng(0)
    mark = time.perf_counter_ns()
    for _ in range(2):
        step(state, _batch(rng))
    recs = _by_name(LOG.records(since=mark))
    assert sorted(recs) == sorted(TRAIN_SPANS)
    assert all(len(recs[n]) == 2 for n in TRAIN_SPANS)
    for i, st in enumerate(recs["vqa.train.step"]):
        assert st.parent is None
        for name in TRAIN_SPANS[1:]:
            assert recs[name][i].root == st.id
        fwd = recs["vqa.train.forward"][i]
        assert recs["vqa.model.tower"][i].parent == recs["vqa.model.head"][i].parent == fwd.id
        assert recs["vqa.model.lstm"][i].parent == recs["vqa.model.head"][i].id


def test_predictor_batch_spans(tmp_path):
    words = [PAD_TOKEN, UNK_TOKEN] + [f"w{i}" for i in range(V - 2)]
    labels = [f"a{i}" for i in range(K)]
    vocab = Vocab(word2idx={w: i for i, w in enumerate(words)}, idx2word=dict(enumerate(words)),
                  label2idx={a: i for i, a in enumerate(labels)},
                  idx2label=dict(enumerate(labels)), max_seq_length=L)
    predictor = VQAPredictor("attention", vocab, batch_size=B, synthetic_images=True,
                             image_size=S, opt_lvl=0, device="cpu")
    mark = time.perf_counter_ns()
    predictor.predict([str(tmp_path / "a.jpg"), str(tmp_path / "b.jpg")], ["w1,w2", "w3"])
    recs = _by_name(LOG.records(since=mark))
    assert sorted(recs) == sorted(SERVE_SPANS)
    assert all(len(recs[n]) == 1 for n in SERVE_SPANS)
    fwd = recs["vqa.serve.forward"][0]
    assert recs["vqa.serve.encode"][0].parent is None and fwd.parent is None
    for name in ("vqa.serve.to_device", "vqa.model.tower", "vqa.model.head",
                 "vqa.serve.to_host"):
        assert recs[name][0].parent == fwd.id
    assert recs["vqa.model.lstm"][0].parent == recs["vqa.model.head"][0].id


@pytest.mark.parametrize("model_name", ["attention", "baseline"])
def test_export_records_and_captures_nothing(model_name):
    """Exported while a profiler records (with none, no span enters the
    profiler at all): no span recorded, no profiler op in the program."""
    model, _ = build_model(model_name, V, K, opt_lvl=0, device="cpu")
    fn = ServingFunction(model, S).eval()
    args = (torch.zeros((B, S, S, 3), dtype=torch.uint8), torch.zeros((B, L), dtype=torch.int64),
            torch.ones((B,), dtype=torch.int64))
    mark = time.perf_counter_ns()
    with torch.no_grad(), torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        program = torch.export.export(fn, args, strict=False)
    assert LOG.records(since=mark) == []
    targets = {str(n.target) for gm in program.graph_module.modules()
               if isinstance(gm, torch.fx.GraphModule) for n in gm.graph.nodes
               if n.op == "call_function"}
    assert not [t for t in targets if "profiler" in t]
