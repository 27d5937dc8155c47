"""Port training (vqa_tpu_torch.train, vqa_tpu_torch.main) vs vqa_tpu's, on the CPU.

The attention model at image 64, vocab 30, K 4, question length 6 (hidden
stays 512: the co-attention contracts it against the VGG's 512 channels).
One flax init goes to both packages (``models.convert.from_jax``); the same
numpy batches go through ``vqa_tpu.train.steps.make_train_step`` (fp32,
``--opt_lvl 0``, frozen running-stats VGG, ``create_train_state`` /
``make_optimizer``) and the port's step, whose conv0 is kernel C's plain
version on the CPU.

Tolerances: step-0 loss within 1e-5 (the two forwards differ in summation
order only); the 10-step trajectory within rtol = atol = 2e-3, the bound of
tests/test_train_parity.py (fp32 drift compounds through Adam across
steps). On one package and one device, resume is exact: bit-equal losses.
"""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vqa_tpu.config import build_model as jax_build
from vqa_tpu.train import steps as j_steps
from vqa_tpu.train.state import create_train_state as j_create_train_state
from vqa_tpu.train.state import make_optimizer as j_make_optimizer
from vqa_tpu_torch.config import build_model
from vqa_tpu_torch.main import main
from vqa_tpu_torch.models.convert import from_jax
from vqa_tpu_torch.train import checkpoint as t_ckpt
from vqa_tpu_torch.train import steps as t_steps
from vqa_tpu_torch.train.state import create_train_state

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V, K, L, S, B = 30, 4, 6, 64, 2
LR = 1e-3
N_STEPS = 10


def _batches(n=3, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        q = rng.integers(2, V, (B, L)).astype(np.int32)
        lens = rng.integers(2, L + 1, (B,)).astype(np.int32)
        for i, k in enumerate(lens):
            q[i, k:] = 0
        out.append({"image": rng.standard_normal((B, S, S, 3)).astype(np.float32),
                    "question": q, "ques_len": lens,
                    "label": rng.integers(0, K, (B,)).astype(np.int32)})
    return out


def _torch_batch(b):
    return {"image": torch.from_numpy(b["image"]),
            **{k: torch.from_numpy(b[k]).long() for k in ("question", "ques_len", "label")}}


@pytest.fixture(scope="module")
def trajectories():
    batches = _batches()
    jm, _ = jax_build("attention", V, K, opt_lvl=0)
    init = {k: jnp.asarray(v[:1]) for k, v in batches[0].items() if k != "label"}
    state = j_create_train_state(jm, jax.random.PRNGKey(0), init, LR)
    sd = from_jax("attention", jax.tree_util.tree_map(np.asarray, state.params),
                  jax.tree_util.tree_map(np.asarray, state.batch_stats))
    tx = j_make_optimizer(LR, state.params, False)
    j_step = j_steps.make_train_step(jm, tx, donate=False)
    j_losses = []
    for i in range(N_STEPS):
        state, m = j_step(state, {k: jnp.asarray(v) for k, v in batches[i % 3].items()})
        j_losses.append(float(m["loss"]))

    model, _ = build_model("attention", V, K, opt_lvl=0, device="cpu")
    model.load_state_dict(sd, strict=True)
    t_state = create_train_state(model, LR)
    step = t_steps.make_train_step()
    t_losses = []
    for i in range(N_STEPS):
        t_losses.append(float(step(t_state, _torch_batch(batches[i % 3]))["loss"]))
    return j_losses, t_losses, t_state


def test_step0_loss_matches(trajectories):
    j_losses, t_losses, _ = trajectories
    np.testing.assert_allclose(t_losses[0], j_losses[0], rtol=1e-5, atol=1e-5)


def test_ten_step_trajectory_matches(trajectories):
    j_losses, t_losses, t_state = trajectories
    np.testing.assert_allclose(t_losses, j_losses, rtol=2e-3, atol=2e-3,
                               err_msg=f"jax={j_losses}\ntorch={t_losses}")
    assert t_losses[0] != t_losses[-1]         # the loss moved
    assert t_state.step == N_STEPS


def test_vgg_frozen_and_out_of_the_optimizer(trajectories):
    _, _, t_state = trajectories
    trained = {id(p) for g in t_state.optimizer.param_groups for p in g["params"]}
    for name, p in t_state.model.named_parameters():
        frozen = name.startswith("image_encoder.")
        assert p.requires_grad != frozen and (id(p) in trained) != frozen, name
        if frozen:
            assert p.grad is None, name


class _Identity:
    """A stand-in model whose logits are the batch's ``image`` entry, for
    both packages' eval steps."""

    def apply(self, variables, img, q, ql, **kw):
        return img

    def __call__(self, img, q, ql):
        return img


def test_validation_metrics_match_with_off_by_one():
    rng = np.random.default_rng(5)
    batches = [{"image": rng.standard_normal((4, K)).astype(np.float32),
                "question": np.zeros((4, L), np.int32), "ques_len": np.ones(4, np.int32),
                "label": rng.integers(0, K, 4).astype(np.int32)} for _ in range(5)]
    ref = j_steps.compute_validation_metrics(
        j_steps.make_eval_step(_Identity()), {}, iter(batches),
        lambda b: {k: jnp.asarray(v) for k, v in b.items()}, 4, 10)
    out = t_steps.compute_validation_metrics(
        t_steps.make_eval_step(), _Identity(), iter(batches), _torch_batch, 4, 10)
    assert out["batches"] == 3                 # n_iters = 2, plus the off-by-one
    assert out["accuracy"] == ref["accuracy"]
    np.testing.assert_allclose(out["loss"], ref["loss"], rtol=1e-6)


# ------------------------------------------------------------------ CLI

LINES_Q = ["w2,w3,w4", "w5,w6", "w7,w8,w9,w10", "w11,w12", "w13,w14,w15",
           "w2,w9,w12,w20", "w21,w22", "w23,w24,w25"]


@pytest.fixture(scope="module")
def cli_data(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_cli")
    words = [f"w{i}" for i in range(2, V)]
    word2idx = {"<PAD>": 0, "<UNKNOWN>": 1, **{w: i + 2 for i, w in enumerate(words)}}
    labels = ["UNKNOWN", "a1", "a2", "a3"]
    vocab = {"word2idx": word2idx, "idx2word": {i: w for w, i in word2idx.items()},
             "label2idx": {a: i for i, a in enumerate(labels)},
             "idx2label": dict(enumerate(labels)), "max_seq_length": L}
    import pickle
    (root / "vocab.pkl").write_bytes(pickle.dumps(vocab))
    train = [f"t{i}.png\t{LINES_Q[i % 8]}\t{labels[1 + i % 3]}" for i in range(16)]
    val = [f"v{i}.png\t{LINES_Q[(i + 3) % 8]}\t{labels[1 + i % 3]}" for i in range(6)]
    (root / "train.txt").write_text("\n".join(train) + "\n")
    (root / "val.txt").write_text("\n".join(val) + "\n")
    return root


MODELS = ["attention", "baseline", "bert"]


def _cli(root, run, *extra, model="attention"):
    return ["--model", model, "--expt_dir", str(root / "runs"), "--expt_name", "e",
            "--run_name", run, "--train_img", str(root), "--train_file",
            str(root / "train.txt"), "--vocab_file", str(root / "vocab.pkl"),
            "--batch_size", "4", "--num_epochs", "1", "--num_cls", "3",
            "--synthetic_images", "true", "--image_size", str(S), "--device", "cpu",
            "--opt_lvl", "0", "--learning_rate", str(LR), "--num_workers", "2", *extra]


@pytest.mark.parametrize("model", MODELS)
def test_resume_is_exact(cli_data, model):
    """4 straight steps == 2 steps, checkpoint, ``--model_ckpt`` resume, 2
    steps: the same losses and final weights, bit for bit (baseline and
    bert with their dropouts live: the checkpoint carries the generator)."""
    full = main(["--mode", "train", *_cli(cli_data, f"full_{model}", "--save_interval", "2",
                                           "--log_interval", "2", model=model)])
    assert full["steps"] == 4 and full["first_step"] == 0
    ckpt = os.path.join(full["log_dir"], "model_2.ckpt")
    assert os.path.exists(ckpt) and os.path.exists(os.path.join(full["log_dir"],
                                                                "model_4.ckpt"))
    resumed = main(["--mode", "train", *_cli(cli_data, f"resumed_{model}", "--save_interval",
                                              "2", "--log_interval", "2", "--model_ckpt", ckpt,
                                              model=model)])
    assert resumed["first_step"] == 2 and resumed["steps"] == 2
    assert resumed["losses"] == full["losses"][2:]
    a = t_ckpt.load_params_only(os.path.join(full["log_dir"], "model_4.ckpt"))
    b = t_ckpt.load_params_only(os.path.join(resumed["log_dir"], "model_4.ckpt"))
    assert set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)
    if model == "attention":
        # 'latest' resolves in the run directory (the same code for every
        # model); as in vqa_tpu, --num_epochs counts the epochs of this
        # invocation, so it trains epoch 2 in full
        latest = main(["--mode", "train", *_cli(cli_data, f"full_{model}", "--model_ckpt",
                                                 "latest", model=model)])
        assert latest["first_step"] == 4 and latest["steps"] == 4
    for run in (full, resumed):         # baseline/bert checkpoints hold the 0.4 GB VGG head
        shutil.rmtree(run["log_dir"])


@pytest.mark.parametrize("model", MODELS)
def test_train_then_test_cli(cli_data, capsys, model):
    val = ["--val_img", str(cli_data), "--val_file", str(cli_data / "val.txt")]
    out = main(["--mode", "train", *_cli(cli_data, f"tt_{model}", "--save_interval", "4",
                                          "--log_interval", "2", "--val_size", "4", *val,
                                          model=model)])
    # validations after steps 2 and 4 and at the epoch end; the val loader
    # drops the last partial batch (as vqa_tpu's), so each runs its one batch
    assert out["eval_batches"] == 3 and np.isfinite(out["losses"]).all()
    assert "Validation Accuracy" in capsys.readouterr().out
    preds = cli_data / f"preds_{model}.json"
    res = main(["--mode", "test", *_cli(cli_data, f"tt_{model}", "--model_ckpt",
                                         "model_4.ckpt", "--test_out", str(preds),
                                         "--test_out_format", "vqa", *val, model=model)])
    assert res["samples"] == 6 and 0.0 <= res["accuracy"] <= 100.0 and np.isfinite(res["loss"])
    rows = json.loads(preds.read_text())
    assert [r["question_id"] for r in rows] == list(range(6))
    assert "Test Accuracy" in capsys.readouterr().out
    shutil.rmtree(out["log_dir"])


def test_pth_export_loads_for_serving_and_resume(cli_data, tmp_path):
    from vqa_tpu_torch.serve import VQAPredictor
    from vqa_tpu_torch.vocab import Vocab

    model, _ = build_model("attention", V, K, opt_lvl=0, device="cpu")
    path = t_ckpt.export_pth(model, str(tmp_path / "model.pth"))
    state = create_train_state(build_model("attention", V, K, opt_lvl=0, device="cpu",
                                           generator=torch.Generator().manual_seed(9))[0], LR)
    t_ckpt.load_any(path, state)
    assert state.step == 0
    assert all(torch.equal(a, b) for a, b in zip(model.state_dict().values(),
                                                   state.model.state_dict().values()))
    p = VQAPredictor("attention", Vocab.load(str(cli_data / "vocab.pkl")), path,
                     batch_size=2, synthetic_images=True, image_size=S, opt_lvl=0,
                     device="cpu")
    r = p.predict([str(cli_data / "t0.png")], ["w2,w3"])
    assert np.isfinite(r[0]["prob"])


@pytest.mark.parametrize("flags", [
    ("--num_devices", "2"), ("--model_parallel", "2"), ("--fsdp", "true"),
    ("--seq_parallel", "true"), ("--force_mesh", "true"), ("--ckpt_backend", "orbax"),
])
def test_unported_flags_raise(cli_data, flags):
    """The multi-device flags are ported (no NotImplementedError): those that
    need a mesh stop at start-up with vqa_tpu's message (vqa_tpu/main.py:
    432-450), the others pass the checks (tests/test_torch_parallel.py runs
    them)."""
    from vqa_tpu_torch.main import build_parser, check_mesh_flags
    args = build_parser().parse_args(["--mode", "train", *_cli(cli_data, "x", *flags)])
    if flags[0] in ("--model_parallel", "--fsdp", "--seq_parallel"):
        with pytest.raises(SystemExit, match="need a device mesh|requires --model_parallel"):
            check_mesh_flags(args)
    else:
        check_mesh_flags(args)


def test_device_cuda_without_card_exits_nonzero(cli_data):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    args = [a for a in _cli(cli_data, "nocard") if a not in ("--device", "cpu")]
    proc = subprocess.run([sys.executable, "-m", "vqa_tpu_torch.main", "--mode", "train",
                           *args], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr


@pytest.mark.parametrize("opt_lvl", [0, 1])
def test_profile_train_rehearses_each_opt_lvl(tmp_path, monkeypatch, opt_lvl):
    """``profile_train --opt_lvl`` builds the model and the preprocessor at
    that level (0: f32 throughout, conv0 = kernel C in f32; 1: bf16) and
    runs both measurements; on the CPU a rehearsal, with no device numbers."""
    from vqa_tpu_torch import profile_train

    seen = []
    real = t_steps.make_train_step

    def spy(**kw):
        step = real(**kw)

        def run(state, batch):
            seen.append(batch["image"].dtype)
            return step(state, batch)
        return run

    monkeypatch.setattr(profile_train, "ANSWERS", K)
    monkeypatch.setattr("vqa_tpu_torch.train.steps.make_train_step", spy)
    monkeypatch.chdir(tmp_path)
    out = tmp_path / "p.json"
    summary = profile_train.main(["--model", "attention", "--device", "cpu", "--opt_lvl",
                                  str(opt_lvl), "--image_size", str(S), "--batch_size", "2",
                                  "--steps", "1", "--num_workers", "1", "--out", str(out)])
    assert summary["opt_lvl"] == opt_lvl and summary["route"] == "float (kernel C)"
    assert summary["peak_memory_gib"] is None and json.loads(out.read_text())["steps"] == 1
    assert seen and set(seen) == {torch.float32 if opt_lvl == 0 else torch.bfloat16}
