"""The readers of the program's spans (``metrics/_spans.py``): device
operations put down to the innermost program span by their launch, on a
hand-made trace with launches on two threads; host medians from a
hand-made span log with set-up outliers and traced calls; nothing read
from a program that keeps no log or a trace that holds no such span."""

from __future__ import annotations

import statistics

import pytest

from vqabench import harness, tracing
from vqabench.metrics import _readers, _spans
from vqa_tpu_torch.train import profiling

MAIN, AUTOGRAD = 1, 2


def _span(name, ts, dur, tid=MAIN):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts, "dur": dur,
            "tid": tid}


def _launch(corr, ts, tid=MAIN, cat="cuda_runtime"):
    return {"ph": "X", "cat": cat, "name": "cudaLaunchKernel", "ts": ts, "dur": 2, "tid": tid,
            "args": {"correlation": corr}}


def _kernel(corr, ts, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": f"k{corr}", "ts": ts, "dur": 5,
            "args": {"correlation": corr}}


def fixture_events():
    """Two steps of 1,000 us. On the main thread: the benchmark's span and
    the program's (step; forward holding tower and head; backward;
    optimizer); the backward's launches come from the autograd thread,
    where no span is open. Per step: tower 1 launch, head 2, forward 1
    (the loss), backward 3 (one a ``cuda_driver`` launch), optimizer 2 (one a copy),
    the step 1 after the optimizer, 1 outside every program span, and a
    kernel with no launch in the trace."""
    events = []
    for step in range(2):
        t, c = 1000.0 * step, 100 * step
        events += [_span("vqabench.train_step", t, 990), _span("vqa.train.step", t + 5, 980),
                   _span("vqa.train.forward", t + 10, 300), _span("vqa.model.tower", t + 10, 100),
                   _span("vqa.model.head", t + 120, 150), _span("vqa.train.backward", t + 320, 400),
                   _span("vqa.train.optimizer", t + 730, 200)]
        launches = [(1, t + 50, MAIN, "cuda_runtime"), (2, t + 130, MAIN, "cuda_runtime"),
                    (3, t + 200, MAIN, "cuda_runtime"), (4, t + 290, MAIN, "cuda_runtime"),
                    (5, t + 330, AUTOGRAD, "cuda_runtime"), (6, t + 500, AUTOGRAD, "cuda_driver"),
                    (7, t + 700, AUTOGRAD, "cuda_runtime"), (8, t + 750, MAIN, "cuda_runtime"),
                    (9, t + 800, MAIN, "cuda_runtime"), (10, t + 950, MAIN, "cuda_runtime"),
                    (11, t + 995, MAIN, "cuda_runtime")]
        for corr, ts, tid, cat in launches:
            events.append(_launch(c + corr, ts, tid, cat))
            events.append(_kernel(c + corr, ts + 20, "gpu_memcpy" if corr == 9 else "kernel"))
        events.append(_kernel(c + 50, t + 600))
    return events


def ctx(events=None):
    return tracing.TraceContext(events=fixture_events() if events is None else events, steps=2,
                                window_s=2e-3, wall_s_per_step=1e-3, config={}, batch=160,
                                kind="train")


def test_ops_put_down_to_the_innermost_span_on_any_thread():
    assert _spans.ops_by_span(fixture_events()) == {
        "vqa.model.tower": 2, "vqa.model.head": 4, "vqa.train.forward": 2,
        "vqa.train.backward": 6, "vqa.train.optimizer": 4, "vqa.train.step": 2}
    c = ctx()
    assert _spans.ops_a_step(c, "vqa.train.backward") == 3
    assert _spans.ops_a_step(c, "vqa.train.optimizer") == 2
    assert 3 + 2 <= _readers.device_ops(c) == 12


def _log(monkeypatch, calls: dict):
    log = profiling.SpanLog()
    for name, seconds in calls.items():
        for s in seconds:
            log._records.append((name, 0, round(s * 1e9), 0, None, 0))
    monkeypatch.setattr(profiling, "LOG", log)


@pytest.mark.parametrize("metric, span, ms", [
    ("fwd_host_ms.train", "vqa.train.forward", 4.0),
    ("bwd_host_ms.train", "vqa.train.backward", 10.0),
    ("optim_host_ms.train", "vqa.train.optimizer", 3.0),
    ("tower_host_ms.serve", "vqa.model.tower", 1.5),
    ("head_host_ms.serve", "vqa.model.head", 2.0),
    ("input_host_ms.serve", "vqa.serve.to_device", 0.5),
])
def test_host_readers_take_the_median_outside_the_traced_steps(metric, span, ms, monkeypatch):
    """Three set-up calls (slow), nine of the window, two traced (slower):
    the median of the first twelve, within the window's middle."""
    setup = [1.0, 0.5, 0.2]
    window = [ms * f / 1e3 for f in (0.9, 0.95, 0.97, 1.0, 1.0, 1.0, 1.03, 1.05, 1.1)]
    _log(monkeypatch, {span: setup + window + [2.0, 2.0], "vqa.other": [9.0] * 5})
    value = harness.load_module("metrics", metric).read(ctx())
    assert value == pytest.approx(1e3 * statistics.median(setup + window))
    assert ms * 1.0 < value <= ms * 1.03


def test_count_readers_by_name():
    c = ctx()
    assert harness.load_module("metrics", "bwd_ops.train").read(c) == 3
    assert harness.load_module("metrics", "optim_ops.train").read(c) == 2


@pytest.mark.parametrize("metric", ["fwd_host_ms.train", "bwd_host_ms.train",
                                    "optim_host_ms.train", "bwd_ops.train", "optim_ops.train",
                                    "tower_host_ms.serve", "head_host_ms.serve",
                                    "input_host_ms.serve"])
def test_readers_find_nothing_in_a_program_without_spans(metric, monkeypatch):
    """A program without the log (the module lacks ``durations``), a trace
    with the benchmark's spans only: each reader gives None, raising nothing."""
    monkeypatch.delattr(profiling, "durations")
    events = [e for e in fixture_events() if not e["name"].startswith("vqa.")]
    assert harness.load_module("metrics", metric).read(ctx(events)) is None


def test_host_readers_need_more_calls_than_traced_steps(monkeypatch):
    _log(monkeypatch, {"vqa.train.forward": [0.01, 0.01]})
    assert _spans.host_ms(ctx(), "vqa.train.forward") is None
    assert _spans.host_ms(ctx(), "vqa.train.backward") is None
