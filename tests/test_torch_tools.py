"""The port's run tools (``vqa_tpu_torch.tools``) against the JAX repo's
``tools/*.py``, on the CPU.

Each JAX tool is loaded from its file under a name of its own (the tools
live outside the package) and run in this process; ``sys.path`` and
``sys.modules`` are restored after. Equality is exact throughout: the same
files byte for byte (the dataset generator), the same tensors bit for bit
(the exported ``.pth``), the same parsed numbers (the log parser). The
arithmetic of ``mem_report`` and the trace reduction of
``profile_headline`` are checked on made-up numbers and events.
"""

import filecmp
import importlib.util
import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from vqa_tpu_torch.models.convert import from_jax
from vqa_tpu_torch.tools import TOOLS, export_vgg_pth, make_synth_dataset, mem_report, \
    profile_headline, run_accuracy
from vqa_tpu_torch.train.checkpoint import FORMAT

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SYNTH_FLAGS = ["--n_train", "20", "--n_val", "10", "--size", "32", "--questions_per_image", "3"]


@pytest.fixture
def jax_tool(monkeypatch):
    """jax_tool(name): tools/<name>.py as a fresh module; sys.path and the
    modules it imports by bare name are restored after."""
    monkeypatch.setattr(sys, "path", list(sys.path))

    def _load(name):
        spec = importlib.util.spec_from_file_location(f"vqa_tpu_tool_{name}",
                                                      os.path.join(REPO, "tools", f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    yield _load
    sys.modules.pop("make_synth_dataset", None)


def dataset_files(root: str) -> list[str]:
    return ["train.txt", "val.txt", "vocab.pkl"] + [
        os.path.join("imgs", n) for n in sorted(os.listdir(os.path.join(root, "imgs")))]


def assert_same_dataset(a: str, b: str, pth: bool) -> None:
    files = dataset_files(a)
    assert files == dataset_files(b)
    for f in files:
        assert filecmp.cmp(os.path.join(a, f), os.path.join(b, f), shallow=False), f
    if pth:
        sa = torch.load(os.path.join(a, "vgg11_bn_synth.pth"), weights_only=True)
        sb = torch.load(os.path.join(b, "vgg11_bn_synth.pth"), weights_only=True)
        assert list(sa) == list(sb)
        for k in sa:
            assert sa[k].dtype == sb[k].dtype and torch.equal(sa[k], sb[k]), k


def small_state_dict(seed=0):
    torch.manual_seed(seed)
    return {"w": torch.randn(4)}


@pytest.mark.parametrize("task", ["redblue", "grid", "gridpair"])
def test_make_synth_dataset_matches_jax(task, tmp_path, jax_tool, monkeypatch):
    """The same flags write the same files: splits, vocab pickle, every JPEG
    and the .pth. The .pth is ``torch.save`` of ``make_vgg11_bn_state_dict
    (seed)`` in both tools: here both draw a small stand-in (the 530 MB
    state dict written twice a task would cost the suite 3 GB of disk), and
    the redblue case holds the two functions' state dicts equal in memory."""
    jax_mod = jax_tool("make_synth_dataset")
    if task == "redblue":
        ref = jax_mod.make_vgg11_bn_state_dict(3)
        ours = make_synth_dataset.make_vgg11_bn_state_dict(3)
        assert list(ref) == list(ours) and set(ours) == make_synth_dataset.vgg11_bn_keys()
        for k in ref:
            assert ref[k].dtype == ours[k].dtype and torch.equal(ref[k], ours[k]), k
        del ref, ours
    monkeypatch.setattr(jax_mod, "make_vgg11_bn_state_dict", small_state_dict)
    monkeypatch.setattr(make_synth_dataset, "make_vgg11_bn_state_dict", small_state_dict)
    flags = SYNTH_FLAGS + ["--task", task, "--grid_n", "2"]
    monkeypatch.setattr(sys, "argv", ["make_synth_dataset", "--out_dir", str(tmp_path / "jax")]
                        + flags)
    jax_mod.main()
    out = make_synth_dataset.main(["--out_dir", str(tmp_path / "port")] + flags)
    assert out["K"] == {"redblue": 2, "grid": 12, "gridpair": 144}[task]
    assert_same_dataset(str(tmp_path / "jax"), str(tmp_path / "port"), pth=True)


def test_make_synth_dataset_runs_from_the_repo_root(tmp_path, monkeypatch):
    """``python -m`` from the repository root, no PYTHONPATH: exits 0, writes
    what the in-process run writes, and a ``.pth`` with torchvision
    ``vgg11_bn``'s keys and shapes (its values are held equal above)."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-m", "vqa_tpu_torch.tools.make_synth_dataset",
                           "--out_dir", str(tmp_path / "cli")] + SYNTH_FLAGS,
                          cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    pth = tmp_path / "cli" / "vgg11_bn_synth.pth"
    sd = torch.load(pth, weights_only=True, mmap=True)
    assert set(sd) == make_synth_dataset.vgg11_bn_keys()
    assert sd["features.0.weight"].shape == (64, 3, 3, 3)
    assert sd["classifier.0.weight"].shape == (4096, 512 * 7 * 7)
    assert sd["classifier.6.weight"].shape == (1000, 4096)
    del sd
    pth.unlink()                             # 530 MB the suite need not keep
    monkeypatch.setattr(make_synth_dataset, "make_vgg11_bn_state_dict", small_state_dict)
    make_synth_dataset.main(["--out_dir", str(tmp_path / "here")] + SYNTH_FLAGS)
    assert_same_dataset(str(tmp_path / "cli"), str(tmp_path / "here"), pth=False)


SAMPLE_LOGS = [
    "",
    "Validation Accuracy: 50.00 %  || Validation Loss: 0.6931\n",
    ("Epoch [1/1], Step [2/312], Loss: 0.6950\nValidation Accuracy: 49.85 %  || "
     "Validation Loss: 0.6940\n\nAfter 1 epoch:\nValidation Accuracy: 99.55 %  || "
     "Validation Loss: 0.0128\n"),
    "Validation Accuracy: 7.5 % || Validation Loss: 12.25\nValidation Accuracy: 100.00 %",
]


def test_last_val_accuracy_matches_jax(jax_tool):
    jax_mod = jax_tool("run_accuracy")
    for text in SAMPLE_LOGS:
        assert run_accuracy.last_val_accuracy(text) == jax_mod.last_val_accuracy(text)
    assert run_accuracy.last_val_accuracy(SAMPLE_LOGS[2]) == (99.55, 0.0128)


def _baseline_trees(rng):
    """vqa_tpu baseline parameter and batch-stats trees (numpy): the conv
    stack at full width, its classifier at 16 outputs (fc0 keeps the
    7 x 7 x 512 inputs that its HWC -> CHW reorder needs; neither exporter
    reads the other widths), the question tower and head tiny."""
    def dense(i, o):
        return {"kernel": rng.standard_normal((i, o), dtype=np.float32),
                "bias": rng.standard_normal(o, dtype=np.float32)}

    feats, stats, c = {}, {}, 3
    for n, o in enumerate((64, 128, 256, 256, 512, 512, 512, 512)):
        feats[f"conv{n}"] = {"kernel": rng.standard_normal((3, 3, c, o), dtype=np.float32),
                             "bias": rng.standard_normal(o, dtype=np.float32)}
        feats[f"bn{n}"] = {"scale": rng.standard_normal(o, dtype=np.float32),
                           "bias": rng.standard_normal(o, dtype=np.float32)}
        stats[f"bn{n}"] = {"mean": rng.standard_normal(o, dtype=np.float32),
                           "var": rng.random(o, dtype=np.float32) + 0.5}
        c = o
    params = {"image_encoder": {"vgg11_encoder": {"features": feats, "classifier": {
                  "fc0": dense(7 * 7 * 512, 16), "fc1": dense(16, 16)}},
                                "embedding_fc": dense(16, 8)},
              "question_encoder": {"word_embedding": {"embedding": rng.standard_normal(
                  (5, 4), dtype=np.float32)},
                  "gru": {"w_ih": rng.standard_normal((4, 24), dtype=np.float32),
                          "w_hh": rng.standard_normal((8, 24), dtype=np.float32),
                          "b_ih": np.zeros(24, np.float32), "b_hh": np.zeros(24, np.float32)},
                  "embedding_fc": dense(8, 8)},
              "mlp_fc": dense(8, 8), "fc_final": dense(8, 3)}
    return params, {"image_encoder": {"vgg11_encoder": {"features": stats}}}


def test_export_vgg_pth_matches_jax(tmp_path, jax_tool, monkeypatch):
    """A baseline's weights carried across with ``from_jax`` into a port
    ``.ckpt``: the port's exporter writes vqa_tpu's tool's tensors, bit for
    bit, under torchvision's keys."""
    import vqa_tpu.train.checkpoint

    params, stats = _baseline_trees(np.random.default_rng(0))
    ckpt = str(tmp_path / "model_1.ckpt")
    torch.save({"format": FORMAT, "model": from_jax("baseline", params, stats)}, ckpt)
    port_out = export_vgg_pth.main(["--ckpt", ckpt, "--out", str(tmp_path / "port.pth"),
                                    "--seed", "3"])
    jax_mod = jax_tool("export_vgg_pth")
    monkeypatch.setattr(vqa_tpu.train.checkpoint, "load_params_only",
                        lambda path, model_name=None: (params, stats))
    monkeypatch.setattr(sys, "argv", ["export_vgg_pth", "--ckpt", "unused.ckpt", "--out",
                                      str(tmp_path / "jax.pth"), "--seed", "3"])
    jax_mod.main()
    ours = torch.load(port_out, weights_only=True)
    ref = torch.load(str(tmp_path / "jax.pth"), weights_only=True)
    assert sorted(ours) == sorted(ref) and len(ours) == 62
    for k in ref:
        assert ours[k].dtype == ref[k].dtype and torch.equal(ours[k], ref[k]), k


def test_mem_report_headroom():
    """Peaks of 20 GiB at b160 and 8 GiB at b32 on an 80 GiB card: 96 MiB a
    sample over 5 GiB fixed, so 800 samples fit."""
    gib = 2 ** 30
    h = mem_report.headroom(20 * gib, 8 * gib, 160, 32, 80 * gib)
    assert h["per_sample_mib"] == 96.0
    assert h["fixed_gib"] == 5.0
    assert h["max_batch"] == 800
    assert mem_report.headroom(8 * gib, 8 * gib, 160, 32, 80 * gib)["max_batch"] is None
    assert set(mem_report.CONFIGS) == {"attention_default", "attention_bf16",
                                       "attention_eval", "baseline_default"}


def _ev(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "args": args}


def test_profile_headline_groups_a_trace():
    """Two steps of made-up device events: each kernel lands in its group,
    A's and B's work comes from the VGG's shapes; a GEMM's operations from
    the profiler's FLOP count (a made-up one here, to tell it from the
    shapes') and its bytes from its operator's shapes (counted once for its
    two kernels); a cuDNN kernel's operations from the count of the
    aten::conv2d above its operator; aten::cat's, which the profiler does
    not count, from its shapes; a copy's bytes from the trace; busy time is
    the union of the intervals."""
    events, fn_events = [], []
    for step in range(2):
        t = 1000.0 * step
        events += [
            _ev("cpu_op", "vqa_tpu_torch::conv0_i8", t, 5, **{"External id": 10 + step}),
            _ev("kernel", "void conv0_s2d_i8_kernel<2>(signed char const*)", t + 1, 100,
                **{"External id": 10 + step}),
            *[_ev("kernel", "conv3x3_i8_kernel(signed char const*)", t + 101 + 10 * i, 10)
              for i in range(7)],
            _ev("cpu_op", "aten::mm", t + 200, 5, **{"External id": 20 + step,
                "Input Dims": [[64, 128], [128, 32]],
                "Input type": ["c10::BFloat16", "c10::BFloat16"]}),
            _ev("kernel", "sm90_xmma_gemm_bf16bf16_bf16f32", t + 200, 50,
                **{"External id": 20 + step}),
            _ev("kernel", "cublasLt::splitKreduce_kernel", t + 250, 10,
                **{"External id": 20 + step}),
            _ev("cpu_op", "aten::add", t + 300, 5, **{"External id": 30 + step,
                "Input Dims": [[1000], [1000], []],
                "Input type": ["float", "float", "Scalar"]}),
            _ev("kernel", "void at::native::vectorized_elementwise_kernel<4>", t + 300, 20,
                **{"External id": 30 + step}),
            _ev("cpu_op", "aten::cat", t + 350, 5, **{"External id": 40 + step,
                "Input Dims": [[[10, 4], [10, 4]], []], "Input type": ["TensorList", "Scalar"]}),
            _ev("kernel", "void at::native::CatArrayBatchedCopy<float>", t + 350, 0,
                **{"External id": 40 + step}),
            _ev("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", t + 400, 40, bytes=4e6),
            _ev("cpu_op", "aten::cudnn_convolution", t + 450, 5, **{"External id": 50 + step,
                "Input Dims": [[2, 3, 8, 8], [5, 3, 3, 3], [], []],
                "Input type": ["float", "float", "ScalarList", "ScalarList"]}),
            _ev("kernel", "sm90_xmma_fprop_implicit_gemm_f32f32", t + 450, 30,
                **{"External id": 50 + step}),
            _ev("cuda_runtime", "cudaLaunchKernel", t, 3),
        ]
        conv2d = SimpleNamespace(id=60 + step, flops=2 * 640 * 27, cpu_parent=None)
        fn_events += [SimpleNamespace(id=20 + step, flops=10 ** 6, cpu_parent=None),
                      SimpleNamespace(id=30 + step, flops=1000, cpu_parent=None),
                      SimpleNamespace(id=40 + step, flops=0, cpu_parent=None), conv2d,
                      SimpleNamespace(id=50 + step, flops=0, cpu_parent=conv2d)]
    flops = profile_headline.counted_flops(fn_events)
    assert flops[51] == (61, 2 * 640 * 27) and 40 not in flops
    work = profile_headline.vgg_int8_work(2, 64)
    rep = profile_headline.reduce_trace(events, steps=2, wall_ms=2.0, vgg_work=work,
                                        flops=flops)
    groups = {r["group"]: r for r in rep["groups"]}
    a, b = groups["kernel A (conv0_s2d_i8)"], groups["kernel B (conv3x3_i8)"]
    assert (a["calls"], a["ms"]) == (1, 0.1) and (b["calls"], b["ms"]) == (7, 0.07)
    assert a["gflop"] == 2 * 2 * 64 * 64 * 3 * 64 * 9 / 1e9 and a["dtype"] == "signed char"
    assert b["gflop"] * 1e9 == work["B"][0]
    gemm = groups["cuBLAS GEMMs"]
    assert gemm["calls"] == 2 and gemm["ms"] == pytest.approx(0.06)
    assert gemm["gflop"] == 1e-3
    assert gemm["mb"] * 1e6 == (64 * 128 + 128 * 32 + 64 * 32) * 2
    elem = groups["elementwise and reductions"]
    # aten::add: 1000 elements, 3 x 4000 bytes; aten::cat: 40 elements of a
    # list of two [10, 4] (type unknown: 4 bytes each), 3 x 160 bytes
    assert elem["gflop"] * 1e9 == 1000 + 40 and elem["mb"] * 1e6 == 3 * 4000 + 3 * 160
    assert groups["copies"]["mb"] == 4.0 and groups["copies"]["verdict"] != "not counted"
    conv = groups["cuDNN convolutions and RNNs"]
    assert conv["gflop"] * 1e9 == 2 * 640 * 27
    assert conv["mb"] * 1e6 == (2 * 3 * 8 * 8 + 5 * 27 + 640) * 4
    assert rep["device_busy_ms_per_step"] == pytest.approx(0.1 + 0.07 + 0.06 + 0.02 + 0.04
                                                           + 0.03)
    assert rep["device_idle_share"] == pytest.approx(1 - 0.32)
    assert profile_headline.group_of("sm90_xmma_fprop_implicit_gemm", "aten::cudnn_convolution",
                                     "kernel") == "cuDNN convolutions and RNNs"


def test_tools_table_names_existing_files():
    for name, (jax_file, _) in TOOLS.items():
        assert os.path.exists(os.path.join(REPO, jax_file)), jax_file
        assert importlib.util.find_spec(f"vqa_tpu_torch.tools.{name}") is not None
