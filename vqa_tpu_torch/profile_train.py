"""Where a training step's time goes, on the card.

    python -m vqa_tpu_torch.profile_train [--model attention|baseline|bert]
        [--steps 6] [--batch_size 32] [--opt_lvl 1|0] [--int8_backbone false|auto]
        [--vgg_train true|false] [--bn_mode auto|batch|running]
        [--out build/profile_train.json]

Trains one model family at full width (``config.MODEL_CONFIGS``: attention
at 448², baseline and bert at 224²; K = 1001, vocab 10,000, question length
23; random weights from seed 0) on synthetic images, at ``--opt_lvl 1``
(bf16 compute) or ``--opt_lvl 0`` (f32 throughout, kernel C in f32), on the
float route by default (conv0 = kernel C). ``--vgg_train true`` trains the
VGG too (batch-stats BatchNorm, the conv stack recomputed in backward,
cuDNN convs, no kernel); ``--bn_mode`` as in ``vqa_tpu_torch.main``. Two
measurements, each after 2 warm-up steps:

1. pieces: each part of a step timed alone, with the card synchronized
   before and after it (host clock, median over ``--steps``): host decode of
   one batch (the loader's thread pool, pinning included), H2D copy +
   preprocess, the tower's forward (``VQANet.features``: the VGG, with its
   classifier head for baseline and bert; with autograd when it trains),
   the head's forward and backward, the tower's backward when it trains
   (the recomputation included), the Adam step, and the whole train step;
2. the loop: the loader thread, ``device_prefetch`` and ``train_step`` as
   ``vqa_tpu_torch.main`` runs them (no validation), ``--steps`` steps
   timed by the host clock, then ``--steps`` more under ``torch.profiler``:
   the device's busy time (the union of its kernel and copy intervals), its
   idle share of the unprofiled wall time, launches per step and the
   kernels that take the most device time.

Needs a card (``--device cpu`` only rehearses the script); prints the card's
name and power limit beside the numbers and writes the JSON summary to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import statistics
import subprocess
import time

import numpy as np
import torch

VOCAB_WORDS, SEQ_LEN, ANSWERS = 10000, 23, 1000        # bench.py:279 (K = 1001)


def _write_data(work: str, n: int) -> tuple[str, str]:
    """A vocab pickle of bench.py's sizes and ``n`` synthetic training lines."""
    os.makedirs(work, exist_ok=True)
    words = [f"w{i}" for i in range(2, VOCAB_WORDS)]
    word2idx = {"<PAD>": 0, "<UNKNOWN>": 1, **{w: i + 2 for i, w in enumerate(words)}}
    labels = ["UNKNOWN"] + [f"a{i}" for i in range(ANSWERS)]
    vocab = {"word2idx": word2idx, "idx2word": {i: w for w, i in word2idx.items()},
             "label2idx": {a: i for i, a in enumerate(labels)},
             "idx2label": dict(enumerate(labels)), "max_seq_length": SEQ_LEN}
    vocab_file = os.path.join(work, "vocab.pkl")
    with open(vocab_file, "wb") as f:
        pickle.dump(vocab, f, protocol=pickle.HIGHEST_PROTOCOL)
    rng = np.random.default_rng(0)
    lines = []
    for i in range(n):
        k = int(rng.integers(3, SEQ_LEN + 1))
        q = ",".join(words[int(j)] for j in rng.integers(0, len(words), k))
        lines.append(f"p_{i:05d}.png\t{q}\t{labels[1 + i % ANSWERS]}")
    data = os.path.join(work, "train.txt")
    with open(data, "w") as f:
        f.write("\n".join(lines) + "\n")
    return vocab_file, data


def _busy_us(events) -> float:
    """Length of the union of the device events' [start, end) intervals."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", default="attention", choices=["attention", "baseline", "bert"])
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--batch_size", type=int, default=32)
    ap.add_argument("--opt_lvl", type=int, default=1, choices=[0, 1],
                    help="1: bf16 compute; 0: f32 throughout (kernel C in f32)")
    ap.add_argument("--int8_backbone", default="false", choices=["auto", "false"])
    ap.add_argument("--vgg_train", default="false", choices=["true", "false"])
    ap.add_argument("--bn_mode", default="auto", choices=["auto", "batch", "running"])
    ap.add_argument("--num_workers", type=int, default=8)
    ap.add_argument("--image_size", type=int, default=0, help="0 = the model's")
    ap.add_argument("--device", default="cuda", help="'cpu' only to rehearse the script")
    ap.add_argument("--out", default=os.path.join("build", "profile_train.json"))
    args = ap.parse_args(argv)
    from .config import build_model, compute_dtype_for_opt_lvl, resolve_device
    from .data.dataset import VQASamples
    from .data.pipeline import DataLoader, device_batch, device_prefetch, \
        make_image_preprocessor
    from .train.calibrate import calibrate_model
    from .train.state import create_train_state
    from .train.steps import cross_entropy_loss, make_train_step
    from .vocab import Vocab

    dev = resolve_device(args.device)
    on_card = dev.type == "cuda"
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60, check=True).stdout.strip().splitlines()[0] \
        if on_card else "cpu (a rehearsal: no device numbers)"
    print(card, flush=True)
    bs, n = args.batch_size, args.steps
    work = os.path.join("build", "profile_train")
    vocab_file, data = _write_data(work, bs * (2 * n + 2) + bs)
    vocab = Vocab.load(vocab_file)
    vgg_train = args.vgg_train == "true"
    bn_batch_stats = {"auto": None, "batch": True, "running": False}[args.bn_mode]
    batch_stats = vgg_train if bn_batch_stats is None else bn_batch_stats
    model, cfg = build_model(args.model, vocab.size, ANSWERS + 1, device=dev, opt_lvl=args.opt_lvl,
                             vgg_trainable=vgg_train,
                             int8_backbone=None if args.int8_backbone == "auto" else False,
                             max_seq_length=SEQ_LEN, generator=torch.Generator().manual_seed(0))
    size = args.image_size or cfg.image_size
    preprocess = make_image_preprocessor(size, compute_dtype_for_opt_lvl(args.opt_lvl), dev)
    samples = VQASamples(data, work, vocab.word2idx, vocab.label2idx, vocab.max_seq_length)
    loader = DataLoader(samples, bs, host_size=size, num_workers=args.num_workers,
                        synthetic_images=True, pin_memory=on_card)
    if model.int8_stages:
        calibrate_model(args.model, model, preprocess,
                        [loader._make_batch(np.arange(bs))["image"]], log=print)
    state = create_train_state(model, 1e-4)
    train_step = make_train_step(vgg_trainable=vgg_train, bn_batch_stats=bn_batch_stats)

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def synced(fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        return out, 1e3 * (time.perf_counter() - t0)

    # 1. pieces
    pieces = {k: [] for k in ("host_decode", "h2d_preprocess", "vgg_forward",
                              "head_forward_backward", "vgg_backward", "adam", "train_step")}
    if not vgg_train:
        del pieces["vgg_backward"]
    model.train()
    for i in range(n + 2):
        idx = np.arange(i * bs, (i + 1) * bs)
        host, t_dec = synced(lambda: loader._make_batch(idx))
        b, t_h2d = synced(lambda: device_batch(host, preprocess, dev))
        feats, t_vgg = synced(lambda: model.features(b["image"], not batch_stats))
        # a trainable tower's backward is timed apart: the head stops at a
        # leaf copy of the features, whose gradient then enters the tower
        head_in = feats.detach().requires_grad_() if vgg_train else feats

        def head():
            logits = model.head(head_in, b["question"], b["ques_len"])
            state.optimizer.zero_grad(set_to_none=True)
            cross_entropy_loss(logits, b["label"]).backward()

        _, t_head = synced(head)
        times = [t_dec, t_h2d, t_vgg, t_head]
        if vgg_train:
            times.append(synced(lambda: feats.backward(head_in.grad))[1])
        _, t_adam = synced(state.optimizer.step)
        del feats, head_in
        _, t_step = synced(lambda: train_step(state, b))
        if i >= 2:
            for k, v in zip(pieces, times + [t_adam, t_step]):
                pieces[k].append(v)
    medians = {k: statistics.median(v) for k, v in pieces.items()}
    for k, v in medians.items():
        print(f"piece {k}: median {v:.3f} ms over {n} (all: {[round(x, 3) for x in pieces[k]]})",
              flush=True)

    # 2. the loop, as main runs it
    from . import _build
    batches = device_prefetch(loader, lambda b: device_batch(b, preprocess, dev), depth=2)
    for _ in range(2):
        train_step(state, next(batches))
    sync()
    t0 = time.perf_counter()
    for _ in range(n):
        train_step(state, next(batches))
    sync()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    _build.reset_counts()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            train_step(state, next(batches))
        sync()
        prof_wall_ms = 1e3 * (time.perf_counter() - t0)
    batches.close()
    loader.close()
    dev_events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    copies = [e for e in dev_events if e.name.startswith(("Memcpy", "Memset"))]
    busy_ms = _busy_us(dev_events) / 1e3
    avgs = prof.key_averages()
    key = "self_device_time_total" if hasattr(avgs[0], "self_device_time_total") \
        else "self_cuda_time_total"
    top = sorted(avgs, key=lambda a: getattr(a, key), reverse=True)[:12]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip() if on_card else ""
    summary = {
        "card": card, "clocks_power_after": smi, "model": args.model, "opt_lvl": args.opt_lvl,
        "image_size": size, "vgg_train": vgg_train, "bn_batch_stats": batch_stats,
        "route": "int8" if model.int8_stages else "float (kernel C)"
        if model.vgg.conv0_pallas else "cuDNN convs (no kernel)",
        "batch": bs, "steps": n, "pieces_median_ms": medians,
        "loop_ms_per_step": wall_ms / n, "loop_qa_per_s": bs * n / (wall_ms / 1e3),
        "profiled_ms_per_step": prof_wall_ms / n,
        "device_busy_ms_per_step": busy_ms / n,
        "device_idle_share": 1.0 - busy_ms / wall_ms,
        "device_ops_per_step": (len(dev_events) - len(copies)) / n,
        "copies_per_step": len(copies) / n,
        "kernel_launches_per_step": {k.symbol: k.launches / n for k in _build.KERNELS},
        "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30 if on_card else None,
        "top_device_ms_per_step": {a.key[:80]: getattr(a, key) / 1e3 / n for a in top},
    }
    print(json.dumps(summary, indent=1), flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(summary, f, indent=1)
    return summary


if __name__ == "__main__":
    main()
