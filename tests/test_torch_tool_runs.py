"""The port's run tools end to end on the CPU (``--device cpu``): an
accuracy run and the dress rehearsal (marked slow) at a tiny size, and the
rule that a tool meant for the card exits without one unless it is given
``--device cpu``. Nothing here needs JAX; the numbers are the CPU's, and
only the control flow and the tools' outputs are checked."""

import json
import os
import re

import pytest
import torch

from vqa_tpu_torch.tools import TOOLS, dress_rehearsal, make_synth_dataset, run_accuracy

# a small run of each card tool on the CPU: (arguments, settings)
CPU_RUNS = {
    "latency_report": (["1", "--trials", "1", "--image_size", "32"], {}),
    "mem_report": (["attention_eval", "--image_size", "32"], {}),
    "profile_vgg": (["--image_size", "32"],
                    {"BENCH_BATCH": "1", "BENCH_STEPS": "1"}),
    "profile_headline": (["--image_size", "32"],
                         {"BENCH_BATCH": "1", "PROFILE_STEPS": "1"}),
}


@pytest.fixture
def dataset(tmp_path_factory, monkeypatch):
    """A tiny redblue dataset (16 train, 8 val pairs at 32²; the .pth's
    530 MB state dict swapped for the conv stack's, which is all that an
    attention model loads)."""
    full = make_synth_dataset.make_vgg11_bn_state_dict

    def conv_stack(seed=0):
        return {k: v for k, v in full(seed).items() if k.startswith("features.")}

    monkeypatch.setattr(make_synth_dataset, "make_vgg11_bn_state_dict", conv_stack)
    out = str(tmp_path_factory.mktemp("redblue"))
    make_synth_dataset.main(["--out_dir", out, "--n_train", "16", "--n_val", "8", "--size",
                             "32", "--questions_per_image", "2"])
    return out


def test_run_accuracy_on_the_cpu(dataset, tmp_path, capsys):
    """Attention at 32² (the baseline's 0.4 GB head is slow here) through
    ``main``: the JSON line's accuracy and loss are the log's "After 1 epoch"
    line, 4 steps of 4 ran, the decode engine is named."""
    rec = run_accuracy.main(["--data_dir", dataset, "--model", "attention", "--image_size",
                             "32", "--batch_size", "4", "--device", "cpu", "--expt_dir",
                             str(tmp_path)])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    with open(os.path.join(rec["summary"]["log_dir"], "train_log.txt")) as f:
        after = re.search(r"After 1 epoch:\nValidation Accuracy: ([0-9.]+) %  \|\| "
                          r"Validation Loss: ([0-9.]+)", f.read())
    assert (line["val_accuracy"], line["val_loss"]) == (float(after[1]), float(after[2]))
    assert line["framework"] == "port" and line["device"].startswith("cpu")
    assert line["train_steps"] == 4 and line["decode_backend"] in ("native_mp", "native", "pil")
    assert line["train_qa_per_s"] > 0 and not any(line["launches"].values())
    with pytest.raises(SystemExit, match="does not hold"):
        run_accuracy.main(["--data_dir", dataset, "--framework", "ref", "--device", "cpu"])


@pytest.mark.slow
def test_dress_rehearsal_on_the_cpu(tmp_path, capsys):
    """The six stages through the CLIs, each in a fresh process: all three
    PASS lines. Slow, as vqa_tpu's own (tests/test_dress_rehearsal.py): four
    fresh processes, 21-24 s alone and 137 s of one worker inside the
    six-worker suite."""
    out = dress_rehearsal.main(["--device", "cpu", "--model", "attention", "--epochs", "1",
                                "--batch_size", "6", "--work_dir", str(tmp_path)])
    text = capsys.readouterr().out
    for line in ("DRESS REHEARSAL PASS", "loadRes round-trip OK", "serve smoke OK"):
        assert line in text
    assert out["pairs"] == 24 and out["accuracy"] is not None


@pytest.mark.parametrize("name", [n for n, (_, card) in TOOLS.items() if card])
def test_card_tool_needs_a_card_or_device_cpu(name, tmp_path, monkeypatch, capsys):
    """Without a card a card tool exits non-zero with a message, before any
    work; with ``--device cpu`` it runs (run_accuracy and dress_rehearsal
    run above)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    import importlib
    mod = importlib.import_module(f"vqa_tpu_torch.tools.{name}")
    required = {"run_accuracy": ["--data_dir", str(tmp_path)],
                "dress_rehearsal": ["--work_dir", str(tmp_path)]}.get(name, [])
    with pytest.raises(SystemExit) as e:
        mod.main(required)
    assert e.value.code not in (0, None) and "no CUDA device" in str(e.value.code)
    if name in CPU_RUNS:
        argv, env = CPU_RUNS[name]
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        monkeypatch.setenv("PROFILE_OUT", str(tmp_path / "profile"))
        mod.main(argv + ["--device", "cpu"])
        assert capsys.readouterr().out.startswith("cpu")
