"""Serving artifacts of the port (vqa_tpu_torch.export) on the CPU.

The port's counterpart of tests/test_export.py, at its sizes (attention, b2,
32², ``--opt_lvl 0``, the 3-line vocab, ``device="cpu"``): the manifest
contract, an exported program equal to the live predictor bit for bit (fp32,
and int8 at ``--opt_lvl 1``, where the kernels' operators run their plain
versions), the manifest's refusals, and the serve and export CLIs. Beyond
the JAX package's tests: the port's fp32 artifact against vqa_tpu's, both
from one flax init (``models.convert.from_jax``), within 1e-5 and with the
same top-1 (the tolerance of tests/test_torch_serve.py); ``opcheck`` of the
three kernel operators; an interrupted save leaves no manifest; a fresh
process serves from an artifact without importing any model module; and
the two warnings (flags ignored with ``--from_export``, an unverified vocab
fingerprint).
"""

import collections
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_vgg import parity_safe_variables
from vqa_tpu.config import build_model as jax_build
from vqa_tpu.export import ExportedPredictor as JaxExportedPredictor
from vqa_tpu.export import export_predictor as jax_export_predictor
from vqa_tpu.serve import VQAPredictor as JaxPredictor
from vqa_tpu_torch import _build
from vqa_tpu_torch.export import (ARTIFACT, MANIFEST, ExportedPredictor, export_predictor,
                                  kernel_ops)
from vqa_tpu_torch.export import main as export_main
from vqa_tpu_torch.models.convert import from_jax
from vqa_tpu_torch.ops import library, quant
from vqa_tpu_torch.serve import VQAPredictor
from vqa_tpu_torch.serve import main as serve_main
from vqa_tpu_torch.vocab import Vocab, save_vocab

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
S, B = 32, 2
NAMES = ("a.jpg", "b.jpg", "c.jpg")
QUESTIONS = ["is,the,cat,black", "what,color,is,the,dog", "is,this,a,cat"]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("export_torch")
    lines = [f"{n}\t{q}\t{a}" for n, q, a in zip(NAMES, QUESTIONS, ("yes", "brown", "no"))]
    data = root / "data.txt"
    data.write_text("\n".join(lines) + "\n")
    vocab_file = root / "vocab.pkl"
    save_vocab(str(data), str(vocab_file), 1, 3)
    return {"root": str(root), "data": str(data), "vocab": str(vocab_file),
            "paths": [str(root / n) for n in NAMES]}


@pytest.fixture(scope="module")
def exported(setup, tmp_path_factory):
    """One flax init of the attention model, as a ``.pth`` through
    ``from_jax``; the export CLI's artifact of it and a live predictor."""
    vocab = Vocab.load(setup["vocab"])
    jm, _ = jax_build("attention", vocab.size, vocab.num_labels, opt_lvl=0)
    params, stats = parity_safe_variables(jm, seed=41, seq=vocab.max_seq_length)
    ckpt = str(tmp_path_factory.mktemp("ckpt") / "model.pth")
    torch.save(from_jax("attention", params, stats), ckpt)
    art = str(tmp_path_factory.mktemp("art"))
    manifest = export_main(["--model", "attention", "--vocab_file", setup["vocab"],
                            "--model_ckpt", ckpt, "--out", art, "--batch_size", str(B),
                            "--image_size", str(S), "--opt_lvl", "0", "--device", "cpu"])
    predictor = VQAPredictor("attention", vocab, ckpt, batch_size=B, synthetic_images=True,
                             image_size=S, opt_lvl=0, device="cpu")
    return {"predictor": predictor, "art": art, "manifest": manifest, "vocab": vocab,
            "params": params, "stats": stats}


def _targets(program) -> collections.Counter:
    """Every operator node of a program, nested graphs included."""
    return collections.Counter(
        str(n.target) for gm in program.graph_module.modules()
        if isinstance(gm, torch.fx.GraphModule) for n in gm.graph.nodes
        if n.op == "call_function")


def test_manifest_contract(exported):
    m, art = exported["manifest"], exported["art"]
    assert m["format"] == "vqa_tpu_torch.export.v1"
    assert m["model"] == "attention"
    assert (m["batch_size"], m["image_size"]) == (B, S)
    assert m["num_classes"] == exported["predictor"].num_classes
    assert m["platforms"] == ["cpu"] and m["artifacts"] == {"cpu": ARTIFACT}
    assert m["int8_stages"] == [] and m["kernels"] == {"conv0_f": 1}
    assert m["op_library"] == "vqa_tpu_torch.ops.library" == library.__name__
    assert m["torch_version"] == torch.__version__ and len(m["vocab_sha256"]) == 64
    with open(os.path.join(art, MANIFEST)) as f:
        assert json.load(f) == m
    assert sorted(os.listdir(art)) == [MANIFEST, ARTIFACT]       # no temporary file left
    assert os.path.getsize(os.path.join(art, ARTIFACT)) == m["artifact_bytes"]


@pytest.mark.parametrize("route", ["fp32", "int8"])
def test_exported_equals_live_bit_for_bit(exported, setup, tmp_path, route):
    """The program holds the kernels' operators, never their plain
    versions, and answers exactly as the live predictor does."""
    if route == "fp32":
        live, art = exported["predictor"], exported["art"]
        ops, convs = {"conv0_f": 1}, 7               # kernel C; conv1-7 in cuDNN's place
    else:
        live = VQAPredictor("attention", exported["vocab"], batch_size=B,
                            synthetic_images=True, image_size=S, opt_lvl=1,
                            int8_backbone=True, device="cpu")
        live.predict_probs(setup["paths"][:B], QUESTIONS[:B])      # calibrates
        art = str(tmp_path / "int8")
        # the scales' constants are made while tracing: the eager calls
        # below must not get the tracer's fake tensors from the cache
        quant._const.cache_clear()
        assert export_predictor(live, art)["int8_stages"] == list(range(8))
        ops, convs = {"conv0_i8": 1, "int8_conv3x3": 7}, 0   # fused stem, stages 0-7
    aot = ExportedPredictor(art, exported["vocab"], vocab_path=setup["vocab"],
                            synthetic_images=True, device="cpu")
    assert kernel_ops(aot.program) == ops
    assert _targets(aot.program)["aten.conv2d.default"] == convs
    _build.reset_counts()
    want = live.predict_probs(setup["paths"], QUESTIONS)
    got = aot.predict_probs(setup["paths"], QUESTIONS)
    assert got.shape == want.shape == (3, live.num_classes) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert aot.predict(setup["paths"], QUESTIONS, top_k=3) == \
        live.predict(setup["paths"], QUESTIONS, top_k=3)
    assert all(k.launches == 0 and k.plain_on_cuda == 0 for k in _build.KERNELS)


def test_port_artifact_agrees_with_vqa_tpu(exported, setup, tmp_path):
    """The same flax init exported by both packages (fp32): the same top-1
    answers, probabilities within 1e-5."""
    vocab = exported["vocab"]
    jp = JaxPredictor("attention", vocab, batch_size=B, synthetic_images=True,
                      image_size=S, opt_lvl=0)
    jp.variables = {"params": jax_tree(exported["params"]),
                    "batch_stats": jax_tree(exported["stats"])}
    jax_export_predictor(jp, str(tmp_path), vocab_path=setup["vocab"])
    ref = JaxExportedPredictor(str(tmp_path), vocab, vocab_path=setup["vocab"],
                               synthetic_images=True)
    port = ExportedPredictor(exported["art"], vocab, vocab_path=setup["vocab"],
                             synthetic_images=True, device="cpu")
    k = port.num_classes
    for a, b in zip(ref.predict(setup["paths"], QUESTIONS, top_k=k),
                    port.predict(setup["paths"], QUESTIONS, top_k=k)):
        assert a["answer"] == b["answer"]
        np.testing.assert_allclose(sorted(p for _, p in b["topk"]),
                                   sorted(p for _, p in a["topk"]), atol=1e-5, rtol=0)


def jax_tree(tree):
    return {k: jax_tree(v) if isinstance(v, dict) else jnp.asarray(v) for k, v in tree.items()}


def test_vocab_fingerprint_mismatch_raises(exported, tmp_path):
    other = tmp_path / "other.txt"
    other.write_text("x.jpg\tsome,other,words\tmaybe\n")
    other_vocab = tmp_path / "other_vocab.pkl"
    save_vocab(str(other), str(other_vocab), 1, 2)
    with pytest.raises(ValueError, match="fingerprint"):
        ExportedPredictor(exported["art"], Vocab.load(str(other_vocab)),
                          vocab_path=str(other_vocab), device="cpu")


def test_unverified_fingerprint_warns(exported):
    with pytest.warns(UserWarning, match="fingerprint is unverified"):
        ExportedPredictor(exported["art"], exported["vocab"], device="cpu")


def test_wrong_platform_raises(exported, setup, tmp_path):
    """A card's artifact on a host served on the CPU: refused, and the
    message names the flag value that fixes it."""
    art2 = tmp_path / "art_cuda_only"
    art2.mkdir()
    os.link(os.path.join(exported["art"], ARTIFACT), str(art2 / ARTIFACT))
    m = dict(exported["manifest"], platforms=["cuda"], artifacts={"cuda": ARTIFACT})
    (art2 / MANIFEST).write_text(json.dumps(m))
    with pytest.raises(ValueError, match="platforms cpu"):
        ExportedPredictor(str(art2), exported["vocab"], vocab_path=setup["vocab"],
                          device="cpu")
    with pytest.raises(ValueError, match="one of"):
        export_predictor(exported["predictor"], str(tmp_path / "tpu"), platforms=("tpu",))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ExportedPredictor(exported["art"], exported["vocab"], vocab_path=setup["vocab"])
        with pytest.raises(RuntimeError, match="no CUDA device"):
            export_predictor(exported["predictor"], str(tmp_path / "c"), platforms=("cuda",))


def test_unknown_format_raises(exported, tmp_path):
    (tmp_path / MANIFEST).write_text(json.dumps({"format": "v999"}))
    with pytest.raises(ValueError, match="format"):
        ExportedPredictor(str(tmp_path), exported["vocab"], device="cpu")


def test_uncalibrated_int8_refuses_export(exported, tmp_path):
    p = VQAPredictor("attention", exported["vocab"], batch_size=B, synthetic_images=True,
                     image_size=S, opt_lvl=1, int8_backbone=True, device="cpu")
    assert p._needs_calib
    with pytest.raises(ValueError, match="calib"):
        export_predictor(p, str(tmp_path / "art"))
    assert not os.path.exists(tmp_path / "art")


def test_interrupted_save_leaves_no_manifest(exported, tmp_path, monkeypatch):
    """The program is written under a temporary name and the manifest after
    it: a save that fails half-way leaves neither behind."""
    def fail(program, f, *args, **kwargs):
        with open(f, "wb") as fh:
            fh.write(b"partial")
        raise OSError("disk full")

    monkeypatch.setattr(torch.export, "save", fail)
    out = tmp_path / "art"
    with pytest.raises(OSError, match="disk full"):
        export_predictor(exported["predictor"], str(out))
    assert os.listdir(out) == []


def test_serve_export_to_then_from_export(setup, tmp_path):
    """``serve --export_to`` (no --input), then ``--from_export`` with no
    --model: the same JSONL as the live CLI on the same seeded init."""
    art = str(tmp_path / "cli_art")
    common = ["--vocab_file", setup["vocab"], "--device", "cpu"]
    serve_main(["--model", "attention", "--export_to", art, "--batch_size", str(B),
                "--image_size", str(S), "--opt_lvl", "0", "--synthetic_images", *common])
    assert os.path.exists(os.path.join(art, ARTIFACT))
    serve = ["--img_dir", setup["root"], "--input", setup["data"], "--synthetic_images",
             "--top_k", "2", *common]
    out_aot, out_live = tmp_path / "aot.jsonl", tmp_path / "live.jsonl"
    serve_main(["--from_export", art, "--output", str(out_aot), *serve])
    serve_main(["--model", "attention", "--output", str(out_live), "--batch_size", str(B),
                "--image_size", str(S), "--opt_lvl", "0", *serve])
    aot = [json.loads(s) for s in out_aot.read_text().splitlines()]
    live = [json.loads(s) for s in out_live.read_text().splitlines()]
    assert len(aot) == 3 and aot == live


def test_from_export_notes_ignored_flags(exported, setup, tmp_path, capsys):
    serve_main(["--from_export", exported["art"], "--vocab_file", setup["vocab"],
                "--img_dir", setup["root"], "--input", setup["data"], "--synthetic_images",
                "--output", str(tmp_path / "o.jsonl"), "--device", "cpu",
                "--model", "bert", "--batch_size", "8", "--opt_lvl", "0"])
    out = capsys.readouterr().out
    assert "NOTE: --model, --batch_size, --opt_lvl are ignored with --from_export" in out
    assert len((tmp_path / "o.jsonl").read_text().splitlines()) == 3


def test_cli_flag_validation(setup, tmp_path):
    v = ["--vocab_file", setup["vocab"], "--device", "cpu"]
    with pytest.raises(SystemExit):
        serve_main(["--input", setup["data"], *v])                     # no --model, no export
    with pytest.raises(SystemExit):
        serve_main(["--model", "baseline", *v])                         # no --input/--export_to
    with pytest.raises(SystemExit):
        serve_main(["--model", "attention", "--from_export", str(tmp_path),
                    "--export_to", str(tmp_path), *v])                  # mutually exclusive
    with pytest.raises(SystemExit):
        export_main(["--model", "attention", "--vocab_file", setup["vocab"]])   # no --out


def test_fresh_process_serves_without_model_code(exported, setup, tmp_path):
    """``ExportedPredictor`` in a new process imports the operator library
    and no model module (nor JAX), and answers bit for bit as the live
    predictor."""
    out = str(tmp_path / "probs.npy")
    code = (
        "import sys, numpy as np\n"
        "from vqa_tpu_torch.export import ExportedPredictor\n"
        "from vqa_tpu_torch.vocab import Vocab\n"
        f"v = {setup['vocab']!r}\n"
        f"p = ExportedPredictor({exported['art']!r}, Vocab.load(v), vocab_path=v, "
        "synthetic_images=True, device='cpu')\n"
        f"np.save({out!r}, p.predict_probs({setup['paths']!r}, {QUESTIONS!r}))\n"
        "bad = [m for m in sys.modules if m.startswith('vqa_tpu_torch.models') "
        "or m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'vqa_tpu')]\n"
        "assert not bad, bad\n"
        "assert 'vqa_tpu_torch.ops.library' in sys.modules\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=300)
    want = exported["predictor"].predict_probs(setup["paths"], QUESTIONS)
    np.testing.assert_array_equal(np.load(out), want)


def _op_cases():
    """Small CPU inputs for each operator: (name, [args, ...])."""
    rng = np.random.default_rng(11)

    def i8(*shape):
        return torch.from_numpy(rng.integers(-127, 128, shape).astype(np.int8))

    def f32(*shape, lo=1e-5, hi=1e-4):
        return torch.from_numpy((rng.random(shape) * (hi - lo) + lo).astype(np.float32))

    return {
        "conv0_i8": [(i8(1, 4, 6, 3), i8(3, 3, 3, 64), f32(64), f32(64, lo=-0.1, hi=0.1),
                      torch.bfloat16, None),
                     (i8(2, 4, 4, 3), i8(3, 3, 3, 64), f32(64), f32(64, lo=-0.1, hi=0.1),
                      torch.float32, f32(64, lo=1e-3, hi=2e-2))],
        "int8_conv3x3": [(i8(1, 4, 6, 32), i8(3, 3, 32, 64), f32(64), f32(64, lo=-0.1, hi=0.1),
                          True, f32(64, lo=1e-3, hi=2e-2), torch.float32),
                         (i8(2, 3, 5, 32), i8(3, 3, 32, 64), f32(64), f32(64, lo=-0.1, hi=0.1),
                          False, None, torch.bfloat16)],
        "conv0_f": [(f32(1, 4, 6, 3, lo=-1, hi=1), f32(3, 3, 3, 64, lo=-0.2, hi=0.2),
                     f32(64, lo=-0.1, hi=0.1)),
                    (f32(2, 4, 4, 3, lo=-1, hi=1).bfloat16(), f32(3, 3, 3, 64, lo=-0.2, hi=0.2),
                     f32(64, lo=-0.1, hi=0.1))],
        "conv3x3_f": [(f32(1, 5, 6, 8, lo=-1, hi=1), f32(3, 3, 8, 16, lo=-0.2, hi=0.2),
                       f32(16, lo=-0.1, hi=0.1)),
                      (f32(2, 4, 7, 8, lo=-1, hi=1).bfloat16(), f32(3, 3, 8, 16, lo=-0.2, hi=0.2),
                       f32(16, lo=-0.1, hi=0.1)),
                      (f32(2, 4, 7, 8, lo=-1, hi=1).bfloat16(), f32(3, 3, 8, 16, lo=-0.2, hi=0.2),
                       f32(16, lo=-0.1, hi=0.1), False)],
        "coattention_fwd": [(f32(2, 6, 32, lo=-1, hi=1).to(dt), f32(2, 3, 4, 32, lo=-1, hi=1).to(dt),
                             f32(32, 32, lo=-0.2, hi=0.2), f32(32, lo=-0.1, hi=0.1),
                             f32(32, 32, lo=-0.2, hi=0.2), f32(32, lo=-0.1, hi=0.1),
                             f32(32, 1, lo=-0.2, hi=0.2), f32(32, 1, lo=-0.2, hi=0.2))
                            for dt in (torch.float32, torch.bfloat16)],
        "mma_rate": [(i8(2, 2, 64, 128), i8(3, 128, 128)),
                     (i8(2, 1, 128, 64).bfloat16(), i8(2, 64, 128).bfloat16())],
    }


@pytest.mark.parametrize("name", ["conv0_i8", "int8_conv3x3", "conv0_f", "conv3x3_f",
                                  "coattention_fwd", "mma_rate"])
def test_kernel_operator_opcheck(name):
    """torch.library.opcheck on the CPU: the schema, the autograd
    registration, the fake (export's tracing) against the CPU
    implementation, and AOT dispatch with dynamic shapes."""
    op = library.OPS[name]
    for args in _op_cases()[name]:
        result = torch.library.opcheck(op, args)
        assert set(result.values()) == {"SUCCESS"}, result
