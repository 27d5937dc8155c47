"""Train and evaluate one configuration on a synthetic dataset; one JSON line.

Port of tools/run_accuracy.py (BASELINE.md's accuracy ladder). It trains
through ``vqa_tpu_torch.main`` in this process on a directory written by
``vqa_tpu_torch.tools.make_synth_dataset`` (its images, splits, vocab and
random-init ``vgg11_bn_synth.pth``), with the JAX tool's training command:
validation over the whole val split at each epoch's end (and at step 2, as
``main`` validates there), no periodic log, ``--decode_backend auto``. The
final validation accuracy and loss come from the run's log, as the JAX tool
parses them. The JSON line keeps the JAX tool's keys and adds the device
(the card's name and power limit), the decode engine that ran, the
training loop's QA/s (validation and checkpoints taken out), its seconds
and the kernels' launches.

``--framework ref`` (the unmodified reference implementation, as a
subprocess) needs the reference's files, which this repository does not
hold: it exits.

    python -m vqa_tpu_torch.tools.make_synth_dataset --out_dir data/redblue
    python -m vqa_tpu_torch.tools.run_accuracy --data_dir data/redblue [--opt_lvl 1]
    python -m vqa_tpu_torch.tools.run_accuracy --data_dir data/redblue \\
        --opt_lvl 0 --bn_mode batch --device cpu
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
import time


def last_val_accuracy(text: str):
    """Final 'Validation Accuracy: X %  || Validation Loss: Y' occurrence."""
    hits = re.findall(r"Validation Accuracy: ([0-9.]+) %\s*\|\|\s*"
                      r"Validation Loss: ([0-9.]+)", text)
    return (float(hits[-1][0]), float(hits[-1][1])) if hits else (None, None)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--framework", choices=["port", "ref"], default="port",
                    help="port: vqa_tpu_torch.main; ref: the reference (not in this "
                         "repository)")
    ap.add_argument("--data_dir", required=True)
    ap.add_argument("--model", default="baseline")
    ap.add_argument("--num_cls", type=int, default=2)
    ap.add_argument("--epochs", type=int, default=1)
    ap.add_argument("--batch_size", type=int, default=32)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--opt_lvl", type=int, default=0)
    ap.add_argument("--bn_mode", default="auto",
                    help="'batch' reproduces the reference's quirk")
    ap.add_argument("--int8", default="auto", help="--int8_backbone")
    ap.add_argument("--vgg_train", default="false", help="train the backbone end to end")
    ap.add_argument("--vgg_wts", default="vgg11_bn_synth.pth",
                    help="weights file inside data_dir (--vgg_wts_path)")
    ap.add_argument("--save_interval", type=int, default=1000000)
    ap.add_argument("--int8_calib", type=int, default=-1,
                    help="calibration batches (0 = dynamic per-batch scales; "
                         "-1 = main's default)")
    ap.add_argument("--seed", type=int, default=0, help="init and shuffle seed")
    ap.add_argument("--image_size", type=int, default=0, help="model input size override")
    ap.add_argument("--host_size", type=int, default=0,
                    help="host decode size (the device resizes to the model's)")
    ap.add_argument("--num_workers", type=int, default=4, help="host decode threads")
    ap.add_argument("--run_name", default=None)
    ap.add_argument("--expt_dir", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) needs a card; cpu rehearses the run")
    return ap


def run_name(args) -> str:
    return args.run_name or f"{args.framework}_o{args.opt_lvl}_i{args.int8}" \
        f"_bn{args.bn_mode}_e{args.epochs}" \
        + ("_vt" if args.vgg_train == "true" else "") \
        + (f"_s{args.seed}" if args.seed else "") \
        + (f"_im{args.image_size}" if args.image_size else "")


def training_argv(args) -> list[str]:
    """``vqa_tpu_torch.main``'s arguments for this configuration."""
    d = args.data_dir
    with open(os.path.join(d, "val.txt")) as f:
        n_val = sum(1 for _ in f)
    argv = [
        "--mode", "train", "--model", args.model,
        "--expt_dir", args.expt_dir or os.path.join(d, "expts"), "--expt_name", "acc",
        "--run_name", run_name(args),
        "--train_img", os.path.join(d, "imgs"), "--train_file", os.path.join(d, "train.txt"),
        "--val_img", os.path.join(d, "imgs"), "--val_file", os.path.join(d, "val.txt"),
        "--vocab_file", os.path.join(d, "vocab.pkl"),
        "--num_cls", str(args.num_cls), "--batch_size", str(args.batch_size),
        "--num_epochs", str(args.epochs), "--learning_rate", str(args.lr),
        "--opt_lvl", str(args.opt_lvl),
        # epoch-end full validation only: a log interval beyond any step count
        "--log_interval", "100000", "--save_interval", str(args.save_interval),
        "--val_size", str(n_val), "--vgg_train", args.vgg_train,
        "--vgg_wts_path", os.path.join(d, args.vgg_wts),
        "--num_workers", str(args.num_workers), "--decode_backend", "auto",
        "--bn_mode", args.bn_mode, "--int8_backbone", args.int8, "--device", args.device]
    for flag, value, unset in (("--image_size", args.image_size, 0),
                               ("--host_size", args.host_size, 0),
                               ("--seed", args.seed, 0),
                               ("--int8_calib", args.int8_calib, -1)):
        if value != unset:
            argv += [flag, str(value)]
    return argv


def run(args) -> dict:
    """Train, evaluate and return the JSON line's record (the main run's
    summary under ``summary``)."""
    from ._run import device_and_card

    if args.framework == "ref":
        raise SystemExit("--framework ref runs the unmodified reference implementation, "
                         "whose files this repository does not hold")
    _, card = device_and_card(args.device)
    from ..main import main as vqa_main

    t0 = time.perf_counter()
    summary = vqa_main(training_argv(args))
    seconds = time.perf_counter() - t0
    with open(os.path.join(summary["log_dir"], "train_log.txt")) as f:
        acc, loss = last_val_accuracy(f.read())
    qa_s = summary["steps"] * args.batch_size / summary["train_seconds"] \
        if summary["train_seconds"] else None
    return {
        "framework": args.framework, "model": args.model,
        "opt_lvl": args.opt_lvl, "int8": args.int8, "bn_mode": args.bn_mode,
        "epochs": args.epochs, "batch_size": args.batch_size,
        "val_accuracy": acc, "val_loss": loss,
        "wall_min": round(seconds / 60, 1), "run": run_name(args),
        "device": card, "decode_backend": summary["decode_backend"],
        "train_steps": summary["steps"], "train_qa_per_s": qa_s, "seconds": seconds,
        "launches": summary["launches"], "summary": summary}


def main(argv=None) -> dict:
    rec = run(build_parser().parse_args(argv))
    print(json.dumps({k: v for k, v in rec.items() if k != "summary"}), flush=True)
    return rec


if __name__ == "__main__":
    main(sys.argv[1:])
