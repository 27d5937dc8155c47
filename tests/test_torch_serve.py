"""Port serving engine (vqa_tpu_torch.serve) vs vqa_tpu.serve, on the CPU.

The same weights go to both predictors through a reference-format ``.pth``
(vqa_tpu's ``save_pth`` -> ``--model_ckpt``), at 64² and fp32 (int8 off:
the CPU default). Tolerance: the same top-1 answer and probabilities within
1e-5 (JAX's jitted forward vs PyTorch's eager one differ in summation order
only). Also: the JSONL CLI, the first-batch calibration and the calibration
resolution order, that the port imports no JAX, and that ``--device cuda``
without a card fails instead of falling back.
"""

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_torch_vgg import parity_safe_variables
from vqa_tpu.config import build_model as jax_build
from vqa_tpu.models.convert import save_pth
from vqa_tpu.serve import VQAPredictor as JaxPredictor
from vqa_tpu.serve import main as jax_main
from vqa_tpu.vocab import Vocab, save_vocab
from vqa_tpu_torch.serve import VQAPredictor
from vqa_tpu_torch.serve import main as serve_main
from vqa_tpu_torch.train.calibrate import save_calib

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
S = 64
STAGES = (0, 1, 2, 3, 4, 5, 6, 7)
WIDTHS = (3, 64, 128, 256, 256, 512, 512, 512)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("serve_torch")
    lines = ["a.jpg\tis,the,cat,black\tyes",
             "b.jpg\twhat,color,is,the,dog\tbrown",
             "c.jpg\tis,this,a,cat\tno",
             "d.jpg\thow,many,dogs,are,there\ttwo",
             "e.jpg\tis,the,dog,brown\tyes"]
    data = root / "data.txt"
    data.write_text("\n".join(lines) + "\n")
    vocab_file = root / "vocab.pkl"
    save_vocab(str(data), str(vocab_file), 1, 4)
    vocab = Vocab.load(str(vocab_file))
    jm, _ = jax_build("attention", vocab.size, vocab.num_labels, opt_lvl=0)
    params, stats = parity_safe_variables(jm, seed=31, seq=vocab.max_seq_length)
    run = root / "run"
    run.mkdir()
    ckpt = str(run / "model.pth")
    save_pth(ckpt, "attention", params, stats)
    return {"root": str(root), "data": str(data), "vocab": str(vocab_file),
            "ckpt": ckpt, "run": str(run)}


def _pairs(setup, names=("a", "b", "c", "d", "e")):
    qs = {"a": "is,the,cat,black", "b": "what,color,is,the,dog", "c": "is,this,a,cat",
          "d": "how,many,dogs,are,there", "e": "completely,unseen,words"}
    return [os.path.join(setup["root"], f"{n}.jpg") for n in names], [qs[n] for n in names]


def test_predictions_match_vqa_tpu(setup):
    vocab = Vocab.load(setup["vocab"])
    kw = dict(batch_size=2, synthetic_images=True, image_size=S, opt_lvl=0)
    ref = JaxPredictor("attention", vocab, setup["ckpt"], **kw)
    port = VQAPredictor("attention", vocab, setup["ckpt"], device="cpu", **kw)
    assert port.num_classes == ref.num_classes == vocab.num_labels
    assert port.model.int8_stages == ()
    paths, qs = _pairs(setup)
    r_ref = ref.predict(paths, qs, top_k=3)
    r_port = port.predict(paths, qs, top_k=3)
    assert len(r_port) == 5 and len(port.batch_seconds) == 3
    for a, b in zip(r_ref, r_port):
        assert a["answer"] == b["answer"]
        np.testing.assert_allclose([p for _, p in b["topk"]], [p for _, p in a["topk"]],
                                   atol=1e-5, rtol=0)


@pytest.mark.parametrize("model", ["attention", "baseline", "bert"])
def test_cli_jsonl_matches_vqa_tpu(setup, tmp_path, model, capsys):
    """The same ``.pth`` through both CLIs at full width: the reference
    format for attention and baseline, vqa_tpu's flat dict for bert. The
    port's stderr line counts attention's sentence LSTM on the fused path,
    once a batch at least."""
    ckpt = setup["ckpt"]
    if model != "attention":
        vocab = Vocab.load(setup["vocab"])
        jm, _ = jax_build(model, vocab.size, vocab.num_labels, opt_lvl=0)
        params, stats = parity_safe_variables(jm, seed=37, seq=vocab.max_seq_length)
        ckpt = str(tmp_path / f"{model}.pth")
        save_pth(ckpt, model, params, stats)
    args = ["--model", model, "--vocab_file", setup["vocab"],
            "--model_ckpt", ckpt, "--img_dir", setup["root"],
            "--input", setup["data"], "--batch_size", "2", "--image_size", str(S),
            "--synthetic_images", "--opt_lvl", "0", "--top_k", "2"]
    out_j, out_t = tmp_path / "j.jsonl", tmp_path / "t.jsonl"
    jax_main(args + ["--output", str(out_j)])
    capsys.readouterr()
    port = serve_main(args + ["--output", str(out_t), "--device", "cpu"])
    assert port.num_classes == port.vocab.num_labels
    calls = re.search(r"lstm calls fused=(\d+) loop=(\d+)", capsys.readouterr().err)
    if model == "attention":
        assert int(calls[1]) >= 3 and int(calls[2]) == 0
    if ckpt != setup["ckpt"]:
        os.remove(ckpt)             # 0.5 GB (the VGG head)
    rows_j = [json.loads(s) for s in out_j.read_text().splitlines()]
    rows_t = [json.loads(s) for s in out_t.read_text().splitlines()]
    assert len(rows_t) == len(rows_j) == 5
    for a, b in zip(rows_j, rows_t):
        assert set(b) == set(a) == {"image", "question", "answer", "prob", "topk"}
        assert (a["image"], a["question"], a["answer"]) == (b["image"], b["question"],
                                                            b["answer"])
        assert abs(a["prob"] - b["prob"]) <= 1e-5


def test_first_batch_calibration_then_batch_invariant(setup, capsys):
    vocab = Vocab.load(setup["vocab"])
    p = VQAPredictor("attention", vocab, setup["ckpt"], batch_size=2,
                     synthetic_images=True, image_size=S, opt_lvl=0,
                     int8_backbone=True, device="cpu")
    assert p.model.int8_stages == STAGES and p._needs_calib
    assert "calibrated from the first request batch" in capsys.readouterr().out
    paths, qs = _pairs(setup)
    r_ab = p.predict(paths[:2], [qs[0]] * 2)[0]
    assert p.calibrated_on_batch == 1 and not p._needs_calib
    assert [len(a) for a in p.model.int8_amax] == list(WIDTHS)
    r_ac = p.predict([paths[0], paths[2]], [qs[0]] * 2)[0]
    assert r_ab["answer"] == r_ac["answer"]
    assert r_ab["prob"] == r_ac["prob"]


def test_calib_resolution_order(setup, tmp_path):
    vocab = Vocab.load(setup["vocab"])
    side = tuple(tuple(1.0 + i / 10 for _ in range(c)) for i, c in enumerate(WIDTHS))
    save_calib(setup["run"], STAGES, side)          # the checkpoint's sidecar
    try:
        kw = dict(batch_size=2, synthetic_images=True, image_size=S, opt_lvl=0,
                  int8_backbone=True, device="cpu")
        p = VQAPredictor("attention", vocab, setup["ckpt"], **kw)
        assert p.model.int8_amax == side and not p._needs_calib
        explicit = tuple(tuple(2.0 for _ in range(c)) for c in WIDTHS)
        d = tmp_path / "explicit"
        d.mkdir()
        path = save_calib(str(d), STAGES, explicit)
        p = VQAPredictor("attention", vocab, setup["ckpt"], calib_file=path, **kw)
        assert p.model.int8_amax == explicit           # --calib_file wins
        p = VQAPredictor("attention", vocab, setup["ckpt"],
                         calib_file=os.path.join(REPO, "tools", "bench_calib.json"), **kw)
        assert [len(a) for a in p.model.int8_amax] == list(WIDTHS)
    finally:
        os.remove(os.path.join(setup["run"], "int8_calib.json"))


def test_unported_entry_points_raise(setup, tmp_path):
    """What the port does not take raises: a flax ``.ckpt`` that vqa_tpu
    wrote (with checkpoint.py's message), and ``--use_pallas``, the retired
    co-attention kernel."""
    import flax.serialization

    vocab = Vocab.load(setup["vocab"])
    flax_ckpt = tmp_path / "model_1.ckpt"
    flax_ckpt.write_bytes(flax.serialization.to_bytes({"step": 1, "params": {"w": np.ones(3)}}))
    with pytest.raises(ValueError, match="vqa_tpu flax .ckpt does not load here"):
        VQAPredictor("attention", vocab, str(flax_ckpt), device="cpu")
    with pytest.raises(NotImplementedError, match="retired"):
        serve_main(["--model", "attention", "--vocab_file", setup["vocab"], "--use_pallas",
                    "--input", setup["data"], "--device", "cpu"])


def test_native_ckpt_serves_its_model(setup, tmp_path):
    """A ``model_<step>.ckpt`` that ``vqa_tpu_torch.main`` wrote serves (the
    head's width read from it) exactly the probabilities of the model it holds."""
    from vqa_tpu_torch.main import main as train_main

    out = train_main(["--mode", "train", "--model", "attention", "--expt_dir", str(tmp_path),
                      "--expt_name", "e", "--run_name", "r", "--train_img", setup["root"],
                      "--train_file", setup["data"], "--vocab_file", setup["vocab"],
                      "--batch_size", "2", "--num_epochs", "1", "--num_cls", "6",
                      "--synthetic_images", "true", "--image_size", str(S), "--opt_lvl", "0",
                      "--save_interval", "2", "--num_workers", "1", "--device", "cpu"])
    ckpt = os.path.join(out["log_dir"], "model_2.ckpt")
    vocab = Vocab.load(setup["vocab"])
    kw = dict(batch_size=2, synthetic_images=True, image_size=S, opt_lvl=0, device="cpu")
    served = VQAPredictor("attention", vocab, ckpt, **kw)
    assert served.num_classes == 7 != vocab.num_labels
    ref = VQAPredictor("attention", vocab, num_cls=6, **kw)
    paths, qs = _pairs(setup)
    seeded = ref.predict_probs(paths, qs)
    ref.model.load_state_dict(torch.load(ckpt, weights_only=True)["model"])
    want = ref.predict_probs(paths, qs)
    assert not np.array_equal(seeded, want)          # the two steps moved the weights
    np.testing.assert_array_equal(served.predict_probs(paths, qs), want)


def test_port_imports_no_jax():
    code = ("import sys; import vqa_tpu_torch.serve, vqa_tpu_torch.models.convert, "
            "vqa_tpu_torch.train.calibrate, vqa_tpu_torch.ops.conv_stem, "
            "vqa_tpu_torch.models.baseline, vqa_tpu_torch.models.bert, "
            "vqa_tpu_torch.main, vqa_tpu_torch.profile_train, "
            "vqa_tpu_torch.datahelper, vqa_tpu_torch.prepare_data, "
            "vqa_tpu_torch.native, vqa_tpu_torch.native.jpeg, "
            "vqa_tpu_torch.data.feature_cache, vqa_tpu_torch.data._decode_worker, "
            "vqa_tpu_torch.export, vqa_tpu_torch.ops.library, vqa_tpu_torch.utils, "
            "vqa_tpu_torch.utils.plotting, vqa_tpu_torch.parallel.distributed, "
            "vqa_tpu_torch.parallel.mesh, vqa_tpu_torch.parallel.sharding, "
            "vqa_tpu_torch.multichip, vqa_tpu_torch.tools._run, "
            "vqa_tpu_torch.tools.make_synth_dataset, vqa_tpu_torch.tools.run_accuracy, "
            "vqa_tpu_torch.tools.dress_rehearsal, vqa_tpu_torch.tools.latency_report, "
            "vqa_tpu_torch.tools.mem_report, vqa_tpu_torch.tools.export_vgg_pth, "
            "vqa_tpu_torch.tools.profile_vgg, vqa_tpu_torch.tools.profile_headline; "
            "bad = [m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'vqa_tpu')]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)


def test_device_cuda_without_card_fails(setup):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run(
        [sys.executable, "-m", "vqa_tpu_torch.serve", "--model", "attention",
         "--vocab_file", setup["vocab"], "--input", setup["data"],
         "--synthetic_images", "--image_size", str(S)],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    with pytest.raises(RuntimeError, match="no CUDA device"):
        VQAPredictor("attention", Vocab.load(setup["vocab"]), device="cuda")


def test_defaults_are_the_attention_serving_config(setup):
    vocab = Vocab.load(setup["vocab"])
    p = VQAPredictor("attention", vocab, setup["ckpt"], device="cpu")
    assert p.image_size == 448 and p.batch_size == 32
    assert p.model.dtype == torch.bfloat16       # --opt_lvl 1
    assert p.model.int8_stages == ()             # int8 auto-enables on the card only


@pytest.mark.parametrize("size", [64, 32, 80])
def test_preprocess_matches_vqa_tpu(size):
    """Bit-equal at the decoded size (the serving path); within 2e-6 when a
    resize runs (bilinear + antialias in both, different kernels)."""
    import jax.numpy as jnp
    from vqa_tpu.data.pipeline import preprocess_images as jax_preprocess
    from vqa_tpu_torch.data.pipeline import preprocess_images

    u8 = np.random.default_rng(size).integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    ref = np.asarray(jax_preprocess(jnp.asarray(u8), size))
    out = preprocess_images(u8, size, device="cpu").numpy()
    assert out.shape == ref.shape == (2, size, size, 3) and out.dtype == np.float32
    if size == 64:
        np.testing.assert_array_equal(out, ref)
    else:
        np.testing.assert_allclose(out, ref, rtol=0, atol=2e-6)
