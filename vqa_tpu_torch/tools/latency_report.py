"""Serving latency: a request's forward time at small batch sizes.

Port of tools/latency_report.py, through :class:`vqa_tpu_torch.serve.
VQAPredictor` (attention, ``--opt_lvl 1``: on the card the int8 route,
kernels A and B; seeded weights, bench.py's vocabulary of 1,000 words and
100 answers). Per batch size:

- ``forward_ms``: the model's forward on inputs already on the card
  (preprocessed images, question ids and lengths), timed with CUDA events
  around the eager call, median over ``--trials`` calls: the stream's time,
  which holds the host's dispatch whenever the host is slower than the
  card; the int8 scales are calibrated by a warm-up ``predict()`` first, so
  it times the calibrated path;
- ``device_ms``: the card's busy time in one such forward, the union of its
  kernels' and copies' intervals in a ``torch.profiler`` trace of
  ``--trials`` forwards, over ``--trials``;
- ``e2e_ms``: the whole ``predict()`` (host decode of synthetic images,
  the copy to the card, preprocess, forward, softmax, the copy back), host
  clock, median over a quarter of the trials (at least 3);
- each beside its value per sample, and the kernels' launches in the timed
  calls.

``--device cpu`` rehearses it: ``device_ms`` is then null and ``forward_ms``
the host's time.

    python -m vqa_tpu_torch.tools.latency_report [bs ...]   (default 1 8 32)
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import numpy as np
import torch


def bench_vocab():
    """The JAX tool's vocabulary: 1,000 words (PAD, UNK, w0..w997), 100
    answers, questions of up to 23 tokens."""
    from ..vocab import PAD_TOKEN, UNK_TOKEN, Vocab

    words = {PAD_TOKEN: 0, UNK_TOKEN: 1, **{f"w{i}": i + 2 for i in range(998)}}
    labels = {f"ans{i}": i for i in range(100)}
    return Vocab(word2idx=words, idx2word={v: k for k, v in words.items()},
                 label2idx=labels, idx2label={v: k for k, v in labels.items()},
                 max_seq_length=23)


def device_busy_ms(forward, trials: int) -> float:
    """The card's busy time a call of ``forward``: the union of its device
    events' intervals in a trace of ``trials`` calls, over ``trials``."""
    from ..profile_train import busy_us

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(trials):
            forward()
        torch.cuda.synchronize()
    spans = [(e.time_range.start, e.time_range.end) for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    if not spans:
        raise AssertionError("the trace holds no device event")
    return busy_us(spans) / 1e3 / trials


def measure(bs: int, device: torch.device, trials: int = 20,
            image_size: int | None = None) -> dict:
    from .. import _build
    from ..serve import VQAPredictor
    from ._run import sync

    vocab = bench_vocab()
    pred = VQAPredictor("attention", vocab, batch_size=bs, opt_lvl=1, synthetic_images=True,
                        image_size=image_size, device=str(device))
    paths = [f"synthetic_{i}.jpg" for i in range(bs)]
    qs = ["what color is the square"] * bs
    pred.predict(paths, qs)         # warm-up: calibrates the int8 scales
    if pred._needs_calib:
        raise AssertionError("the warm-up predict() did not calibrate")

    # the predictor's own preprocess, so the forward timed is the one predict() runs
    raw = np.random.default_rng(0).integers(0, 256, (bs, pred.image_size, pred.image_size, 3),
                                            dtype=np.uint8)
    img = pred.preprocess(raw)
    ids = torch.ones((bs, vocab.max_seq_length), dtype=torch.long, device=device)
    lens = torch.full((bs,), 5, dtype=torch.long, device=device)

    @torch.no_grad()
    def forward():
        return pred.model(img, ids, lens)

    forward()
    sync(device)
    _build.reset_counts()
    times = []
    for _ in range(trials):
        if device.type == "cuda":
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            forward()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            forward()
            times.append(1e3 * (time.perf_counter() - t0))
    forward_ms = statistics.median(times)
    launches = {k.symbol: k.launches for k in _build.KERNELS if k.launches}
    e2e = []
    for _ in range(max(trials // 4, 3)):
        t0 = time.perf_counter()
        pred.predict(paths, qs)
        e2e.append(1e3 * (time.perf_counter() - t0))
    e2e_ms = statistics.median(e2e)
    device_ms = device_busy_ms(forward, trials) if device.type == "cuda" else None
    rec = {"batch": bs, "device_ms": device_ms,
           "device_ms_per_sample": None if device_ms is None else device_ms / bs,
           "forward_ms": forward_ms, "forward_ms_per_sample": forward_ms / bs,
           "e2e_ms": e2e_ms, "e2e_ms_per_sample": e2e_ms / bs,
           "route": "int8 (kernels A, B)" if pred.model.int8_stages else "float",
           "forward_launches": {k: v / trials for k, v in launches.items()},
           "trials": trials}
    print(json.dumps(rec), flush=True)
    del pred
    return rec


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("sizes", type=int, nargs="*", default=[1, 8, 32])
    ap.add_argument("--trials", type=int, default=20)
    ap.add_argument("--image_size", type=int, help="default: the model's (448)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) needs a card; cpu rehearses the tool")
    args = ap.parse_args(argv)
    from ._run import device_and_card

    device, card = device_and_card(args.device)
    print(card, flush=True)
    rows = [{**measure(bs, device, args.trials, args.image_size), "card": card}
            for bs in args.sizes]
    print(f"{'batch':>5}  {'device_ms':>9}  {'per-sample':>10}  {'forward_ms':>10}  "
          f"{'e2e_ms':>8}", file=sys.stderr)
    for r in rows:
        dev_ms = "—" if r["device_ms"] is None else f"{r['device_ms']:.3f}"
        per = "—" if r["device_ms"] is None else f"{r['device_ms_per_sample']:.3f}"
        print(f"{r['batch']:>5}  {dev_ms:>9}  {per:>10}  {r['forward_ms']:>10.3f}  "
              f"{r['e2e_ms']:>8.2f}", file=sys.stderr)
    return rows


if __name__ == "__main__":
    main()
