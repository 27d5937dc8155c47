"""The frozen metric arithmetic on a hand-made Chrome trace, and the rule
that a configuration, traffic mix or metric is found by name."""

from __future__ import annotations

import importlib
import json
import os
import shutil
import sys

import pytest

from vqabench import harness, tracing
from vqabench.metrics import _readers, _trace, _work
from vqabench.reference import weights

CFG = {"model": "attention", "image_size": 448, "word_emb_dim": 512, "hidden_dim": 512,
       "mlp_dim": 1024, "num_classes": 1001, "max_seq_length": 23}


def _kernel(name, ts, dur, ext=None, cat="kernel"):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "args": {}}
    if ext is not None:
        e["args"]["External id"] = ext
    return e


def _span(name, ts, dur):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts, "dur": dur}


def fixture_events():
    """Two steps of 1,000 us each. Device events: kernel A (50 us), kernel B
    seven times (100 us each), an elementwise kernel overlapping B's last
    call by 20 us, a GEMM launched by aten::mm, and a copy; spans of the
    benchmark around each step, the feed inside the first."""
    events = []
    for step in range(2):
        t = 1000.0 * step
        events.append({"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": t + 860, "dur": 5,
                       "args": {"External id": 7 + step, "Input Dims": [[64, 128], [128, 32]],
                                "Input type": ["float", "float"]}})
        events += [_span("vqabench.train_step", t, 900), _span("vqabench.device_batch", t, 100)]
        events.append(_kernel("void conv0_s2d_i8_kernel<2>(...)", t + 100, 50))
        for i in range(7):
            events.append(_kernel("void conv3x3_i8_pool<1>(...)", t + 150 + 100 * i, 100))
        events.append(_kernel("void at::elementwise_kernel<128>(...)", t + 830, 40))
        events.append(_kernel("ampere_sgemm_64x32", t + 870, 30, ext=7 + step))
        events.append(_kernel("Memcpy HtoD (Pinned -> Device)", t + 950, 10, cat="gpu_memcpy"))
    return events


def ctx(wall_s=1e-3):
    return tracing.TraceContext(events=fixture_events(), steps=2, window_s=2e-3,
                                wall_s_per_step=wall_s, config=CFG, batch=160, kind="train",
                                window_peak_bytes=3 * 2 ** 30,
                                host_spans={"vqabench.train_step": 0.9e-3})


def test_busy_union_and_groups():
    events = fixture_events()
    # per step: A 100-150, B 150-850, elementwise 830-870, GEMM 870-900, copy 950-960
    assert tracing.busy_s(events) == pytest.approx(2 * (800 + 10) * 1e-6)
    assert _trace.busy_us([(0, 10), (5, 20), (30, 40)]) == 30
    dev = _trace.device_events(events)
    groups = {_trace.group_of(e["name"], "", e["cat"]) for e in dev}
    assert groups == {_trace.KERNEL_A, _trace.KERNEL_B, _trace.ELEMENTWISE, _trace.GEMMS,
                      _trace.COPIES}


def test_readers_on_the_fixture():
    c = ctx()
    assert _readers.device_ops(c) == 11
    assert _readers.tower_ab_ms(c) == pytest.approx(0.75)
    assert _readers.step_host_ms(c) == pytest.approx(0.9)
    assert _readers.encode_ms(c) is None
    assert _readers.device_idle(c) == pytest.approx(100.0 * (1 - 810e-6 / 1e-3))
    assert _readers.peak_mem_gib(c) == 3.0
    work = _work.vgg_int8_work(160, 448)
    floor = max(work["A"][0] / _work.INT8_OPS, work["A"][1] / _work.HBM_BPS) \
        + max(work["B"][0] / _work.INT8_OPS, work["B"][1] / _work.HBM_BPS)
    assert _readers.ab_roofline(c) == pytest.approx(100.0 * 2 * floor / 1.5e-3)
    assert _readers.mfu(c) == pytest.approx(100.0 * _work.ideal_seconds(CFG, 160, True) / 1e-3)


def test_readers_find_nothing_in_an_empty_trace():
    c = ctx()
    c.events = []
    c.host_spans = {}
    for read in (_readers.device_ops, _readers.tower_ab_ms, _readers.ab_roofline,
                 _readers.device_idle, _readers.step_host_ms):
        assert read(c) is None


def test_idle_gaps_by_span_and_breakdown():
    gaps = _trace.idle_gaps(fixture_events())
    # each step's 900-950 lies outside every span; 960 to the next step's
    # kernel A (1100) in its feed, the innermost span there
    assert gaps == {_trace.OUTSIDE: pytest.approx(2 * 50),
                    "vqabench.device_batch": pytest.approx(140)}
    b = tracing.breakdown(fixture_events())
    assert b["device_ops"][0] == ["void conv3x3_i8_pool<1>(...)", pytest.approx(1.4e-3)]
    assert len(b["device_ops"]) == 5 and len(b["idle_gaps"]) == 2


def test_vgg_work_and_op_counts():
    work = _work.vgg_int8_work(160, 448)
    assert work["A"][0] == 2.0 * 160 * 448 * 448 * 3 * 64 * 9
    assert work["A"][0] + work["B"][0] == pytest.approx(9.5814e12, rel=1e-4)
    frozen, trained = weights.model_module("baseline").head_flops(
        {**CFG, "model": "baseline", "word_emb_dim": 300, "hidden_dim": 1024}, 1)
    assert frozen == 2.0 * (25088 * 4096 + 4096 * 4096)
    assert trained > 0
    frozen, trained = weights.model_module("attention").head_flops(CFG, 1)
    assert frozen == 0.0 and trained > 2.0 * 1024 * 1001


def test_per_layer_metric_must_name_its_cells():
    bench = harness.load_benchmark()
    bench["per_layer"].append({"name": "x.serve", "unit": "ms", "better": "lower",
                               "source": "host_clock", "layer": "engine",
                               "moves": "serve_qa_per_s"})
    with pytest.raises(SystemExit, match="lists no workloads"):
        harness.cell(bench, "attention.serve.b160")


def test_a_new_cell_and_metric_are_found_by_name(tmp_path, monkeypatch):
    """A configuration of a new model family, a traffic mix, a cell's limits,
    a per-layer metric and the family's reference added as files, with
    entries added to BENCHMARK.json, are found with no edit to any file that
    is there: the cell, its reader, and the family's operation count behind
    ``mfu``."""
    root = tmp_path / "checkout"
    shutil.copytree(harness.BENCH, root / "vqabench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.load(open(os.path.join(harness.ROOT, "BENCHMARK.json")))
    before = {p: open(p, "rb").read() for p in map(str, (root / "vqabench").rglob("*.*"))}
    cfg = {**json.load(open(root / "vqabench/configs/attention-448.json")),
           "model": "newfamily", "image_size": 896}
    (root / "vqabench/configs/newfamily-896.json").write_text(json.dumps(cfg))
    (root / "vqabench/reference/newfamily.py").write_text(
        "def head_flops(cfg, batch):\n    return 1.0e9 * batch, 2.0e9 * batch\n")
    tr = json.load(open(root / "vqabench/traffic/serve-b160.json"))
    (root / "vqabench/traffic/serve-b32.json").write_text(json.dumps({**tr, "batch": 32}))
    (root / "vqabench/limits/attention.serve.b32.json").write_text('{"logp_err": {"limit": 1}}')
    (root / "vqabench/metrics/batch_rows.serve.py").write_text(
        "def read(ctx):\n    return float(ctx.batch)\n")
    bench["configs"].append({"name": "newfamily-896",
                             "file": "vqabench/configs/newfamily-896.json"})
    bench["workloads"].append({"name": "attention.serve.b32", "config": "newfamily-896",
                               "traffic": "serve-b32", "chips": 1})
    for m in bench["end_to_end"]:
        if m["name"] in ("serve_qa_per_s", "serve_batch_p95_ms"):
            m["workloads"].append("attention.serve.b32")
    bench["per_layer"].append({"name": "batch_rows.serve", "unit": "rows", "better": "higher",
                               "source": "program_counter", "layer": "engine",
                               "moves": "serve_qa_per_s", "workloads": ["attention.serve.b32"]})
    bench["per_layer"][[m["name"] for m in bench["per_layer"]].index("mfu.serve")][
        "workloads"].append("attention.serve.b32")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    monkeypatch.setattr(harness, "BENCH", str(root / "vqabench"))
    monkeypatch.setattr(harness, "ROOT", str(root))
    c = harness.cell(harness.load_benchmark(), "attention.serve.b32")
    assert c.config["image_size"] == 896 and c.traffic["batch"] == 32
    assert {m["name"] for m in c.end_to_end} == {"serve_qa_per_s", "serve_batch_p95_ms",
                                                 "setup_s"}
    assert c.limits == {"logp_err": {"limit": 1}}
    assert "batch_rows.serve" in [m["name"] for m in c.per_layer]
    assert harness.load_module("metrics", "batch_rows.serve").read(ctx()) == 160.0
    assert "mfu.serve" in [m["name"] for m in c.per_layer]
    monkeypatch.syspath_prepend(str(root))
    for name in [n for n in sys.modules if n.split(".", 1)[0] == "vqabench"]:
        monkeypatch.delitem(sys.modules, name)
    readers = importlib.import_module("vqabench.metrics._readers")
    c2 = ctx()
    c2.config, c2.kind = c.config, "serve"
    work = readers._work.vgg_int8_work(160, 896)
    want = (work["A"][0] + work["B"][0]) / readers._work.INT8_OPS + 3.0e9 * 160 / \
        readers._work.BF16_FLOPS
    assert readers.mfu(c2) == pytest.approx(100.0 * want / 1e-3)
    assert hasattr(harness.load_module("traffic", c.traffic["loop"]), "Loop")
    assert {p: open(p, "rb").read() for p in before} == before
