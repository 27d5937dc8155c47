#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root, with one card and the CUDA toolkit (nvcc):

    python3 chip_smoke.py

Phases, each of which must pass (the script exits non-zero otherwise, and
without CUDA it exits non-zero before printing any result):

1. the card's name and power limit (nvidia-smi);
2. build every CUDA kernel of the serving path from ``vqa_tpu_torch/csrc``
   (one nvcc per source, started together) and time the build;
3. kernel phase: each kernel mode of the path against its plain PyTorch
   version on the card at the 448² serving shapes (2 samples), bit for bit,
   then each mode's time against its plain version's at batch 32 (the JSON
   line carries the static path's: kernel A's requant mode, and kernel B's
   conv1-7 summed);
4. serve phase: ``vqa_tpu_torch.serve.main`` answers 96 (image, question)
   requests with the ``attention`` model at full width, batch 32, 448²,
   ``--opt_lvl 1`` (int8 stages 0..7, fused stem, int8 hand-offs), random
   seeded weights and a synthetic vocab of bench.py's sizes; the launch
   counts are zeroed just before and read just after, and every kernel must
   have run and no plain conv on a CUDA tensor;
5. cross-device phase: 2 of those requests through the same weights and
   calibration on the CPU's plain path; the VGG features must be bit-equal
   and the probabilities within PROB_TOL.

The line before the last is a JSON object of per-kernel launches, errors and
times; the last is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import pickle
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "build", "chip_smoke")
N_REQUESTS, BATCH, IMAGE = 96, 32, 448
VOCAB_WORDS, SEQ_LEN, ANSWERS = 10000, 23, 1000        # bench.py:279 (K = 1001)
# CPU vs card probabilities: the question tower, co-attention and head run
# in bf16 on both, with different matmul kernels; the VGG features are equal
PROB_TOL = 1e-3


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()
    return out[0]


def cuda_ms(fn, n: int) -> float:
    import torch
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def timed_pair(kernel_fn, plain_fn, n_kernel=20, n_plain=2):
    """Plain, kernel, kernel, plain: mean ms of each (after a warm-up)."""
    import torch
    kernel_fn(), plain_fn()
    torch.cuda.synchronize()
    p1 = cuda_ms(plain_fn, n_plain)
    k1 = cuda_ms(kernel_fn, n_kernel)
    k2 = cuda_ms(kernel_fn, n_kernel)
    p2 = cuda_ms(plain_fn, n_plain)
    return (k1 + k2) / 2, (p1 + p2) / 2


def kernel_phase(dev):
    """Every kernel mode on the path vs its plain version, then times."""
    import torch
    from vqa_tpu_torch.ops import conv_hpack, conv_stage1

    g = torch.Generator().manual_seed(0)

    def ri(*shape):
        return torch.randint(-127, 128, shape, generator=g, dtype=torch.int8).to(dev)

    def rs(n, lo, hi):
        return (torch.rand(n, generator=g) * (hi - lo) + lo).to(dev)

    errs = {"conv0_s2d_i8": 0.0, "conv3x3_i8": 0.0}
    times = {"conv0_s2d_i8": [0.0, 0.0], "conv3x3_i8": [0.0, 0.0]}

    def check(name, label, out, ref):
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        equal = torch.equal(out, ref)
        print(f"kernel {name} {label}: shape {tuple(out.shape)} {out.dtype} "
              f"bit-equal {equal} max_abs_err {err}", flush=True)
        if not equal:
            raise AssertionError(f"{name} {label}: kernel differs from its plain version")
        errs[name] = max(errs[name], err)

    # kernel A: conv0, calibration pass (bf16 out, dynamic scale) and static
    # path (requant for conv1)
    for b in (2, BATCH):
        x = ri(b, IMAGE, IMAGE, 3)
        w = ri(3, 3, 3, 64)
        sc, bias, s1 = rs(64, 1e-5, 1e-4), rs(64, -0.1, 0.1), rs(64, 1e-3, 2e-2)
        modes = {"calibration bf16": dict(out_dtype=torch.bfloat16),
                 "static requant": dict(s1=s1)}
        for label, kw in modes.items():
            k = lambda: conv_stage1.conv0_i8(x, w, sc, bias, **kw)          # noqa: E731
            p = lambda: conv_stage1.conv0_i8_plain(x, w, sc, bias, **kw)    # noqa: E731
            if b == 2:
                check("conv0_s2d_i8", label, k(), p())
                continue
            ms, pms = timed_pair(k, p)
            if label == "static requant":
                times["conv0_s2d_i8"] = [ms, pms]
            print(f"time conv0_s2d_i8 b{b} {label}: kernel {ms:.4f} ms, "
                  f"plain {pms:.4f} ms", flush=True)
        del x

    # kernel B: conv1..conv7 at 448² (H, C_in, C_out, pool); the static
    # path requantizes for the next stage except conv7 (bf16 out), the
    # calibration pass stores bf16 everywhere
    layers = [("conv1", 224, 64, 128, True), ("conv2", 112, 128, 256, False),
              ("conv3", 112, 256, 256, True), ("conv4", 56, 256, 512, False),
              ("conv5", 56, 512, 512, True), ("conv6", 28, 512, 512, False),
              ("conv7", 28, 512, 512, True)]
    for name, hw, c, o, pool in layers:
        for b in (2, BATCH):
            x, w = ri(b, hw, hw, c), ri(3, 3, c, o)
            sc, bias, sn = rs(o, 1e-6, 1e-5), rs(o, -0.1, 0.1), rs(o, 1e-3, 2e-2)
            static = dict(out_dtype=torch.bfloat16) if name == "conv7" else dict(s_next=sn)
            modes = {"static": static, "calibration bf16": dict(out_dtype=torch.bfloat16)}
            for label, kw in modes.items():
                args = (x, w, sc, bias)
                k = lambda: conv_hpack.int8_conv3x3(*args, pool=pool, **kw)  # noqa: E731
                p = lambda: conv_hpack.int8_conv3x3_plain(*args, pool=pool, **kw)  # noqa: E731
                if b == 2:
                    check("conv3x3_i8", f"{name} {label}", k(), p())
                    continue
                ms, pms = timed_pair(k, p)
                if label == "static":
                    times["conv3x3_i8"][0] += ms
                    times["conv3x3_i8"][1] += pms
                tops = 2 * b * hw * hw * c * o * 9 / (ms * 1e-3) / 1e12
                print(f"time conv3x3_i8 {name} b{b} {label}: kernel {ms:.4f} ms "
                      f"({tops:.1f} int8 TOP/s), plain {pms:.4f} ms", flush=True)
            del x
    return errs, times


def write_requests():
    import numpy as np
    os.makedirs(WORK, exist_ok=True)
    words = [f"w{i}" for i in range(2, VOCAB_WORDS)]
    word2idx = {"<PAD>": 0, "<UNKNOWN>": 1, **{w: i + 2 for i, w in enumerate(words)}}
    labels = ["UNKNOWN"] + [f"a{i}" for i in range(ANSWERS)]
    vocab = {"word2idx": word2idx, "idx2word": {i: w for w, i in word2idx.items()},
             "label2idx": {a: i for i, a in enumerate(labels)},
             "idx2label": dict(enumerate(labels)), "max_seq_length": SEQ_LEN}
    vocab_file = os.path.join(WORK, "vocab.pkl")
    with open(vocab_file, "wb") as f:
        pickle.dump(vocab, f, protocol=pickle.HIGHEST_PROTOCOL)
    rng = np.random.default_rng(0)
    lines = []
    for i in range(N_REQUESTS):
        n = int(rng.integers(3, SEQ_LEN + 1))
        q = ",".join(words[int(j)] for j in rng.integers(0, len(words), n))
        lines.append(f"synth_{i:05d}.png\t{q}\t{labels[1 + i % ANSWERS]}")
    pairs = os.path.join(WORK, "pairs.txt")
    with open(pairs, "w") as f:
        f.write("\n".join(lines) + "\n")
    return vocab_file, pairs


def serve_phase(vocab_file, pairs, device="cuda"):
    import numpy as np
    from vqa_tpu_torch import _build
    from vqa_tpu_torch.serve import main as serve_main

    out = os.path.join(WORK, "preds.jsonl")
    _build.reset_counts()
    predictor = serve_main(["--model", "attention", "--vocab_file", vocab_file,
                            "--img_dir", WORK, "--input", pairs, "--output", out,
                            "--batch_size", str(BATCH), "--opt_lvl", "1",
                            "--synthetic_images", "--device", device])
    launches = {k.symbol: k.launches for k in _build.KERNELS}
    plain_on_cuda = {k.symbol: k.plain_on_cuda for k in _build.KERNELS}
    with open(out) as f:
        rows = [json.loads(s) for s in f]
    model = predictor.model
    print(f"serve: {len(rows)} answers, int8 stages {model.int8_stages}, fused stem "
          f"{model.vgg.fused_stem}, calibrated on batch {predictor.calibrated_on_batch}, "
          f"launches {launches}, plain convs on CUDA {plain_on_cuda}", flush=True)
    if len(rows) != N_REQUESTS:
        raise AssertionError(f"expected {N_REQUESTS} answers, got {len(rows)}")
    probs = np.array([[p for _, p in r["topk"]] for r in rows])
    if not (np.isfinite(probs).all() and ((probs >= 0) & (probs <= 1)).all()):
        raise AssertionError("non-finite or out-of-range probabilities")
    if model.int8_stages != (0, 1, 2, 3, 4, 5, 6, 7) or predictor.calibrated_on_batch != 1:
        raise AssertionError("the int8 stages did not calibrate on the first batch")
    if any(v == 0 for v in launches.values()):
        raise AssertionError(f"a kernel of the path never launched: {launches}")
    if any(v != 0 for v in plain_on_cuda.values()):
        raise AssertionError(f"a plain conv ran on a CUDA tensor: {plain_on_cuda}")
    secs = predictor.batch_seconds
    steady = secs[1:3]
    print(f"serve: batch seconds {[round(s, 4) for s in secs]} (batch 1 calibrates); "
          f"batches 2-3: {2 * BATCH / sum(steady):.2f} QA/s, "
          f"{1e3 * sum(steady) / 2:.2f} ms per batch of {BATCH}", flush=True)
    return predictor, launches


def cross_device_phase(predictor, pairs, device="cuda"):
    """2 requests on the card and on the CPU's plain path, same weights and
    calibration: bit-equal VGG features, probabilities within PROB_TOL."""
    import numpy as np
    import torch
    from vqa_tpu.data.images import decode_batch
    from vqa_tpu_torch.config import build_model
    from vqa_tpu_torch.data.pipeline import make_image_preprocessor

    gpu_model = predictor.model
    cpu_model, _ = build_model("attention", predictor.vocab.size, predictor.num_classes,
                               device="cpu", opt_lvl=1, int8_backbone=True)
    cpu_model.load_state_dict({k: v.cpu() for k, v in gpu_model.state_dict().items()})
    cpu_model.int8_amax = gpu_model.int8_amax
    cpu_model.eval()
    with open(pairs) as f:
        lines = [ln.split("\t") for ln in f.read().splitlines()[:2]]
    images = decode_batch([os.path.join(WORK, ln[0]) for ln in lines], IMAGE,
                          synthetic_fallback=True)
    ids, lens = predictor.encode_questions([ln[1] for ln in lines])
    out = {}
    for name, model, d in (("cuda", gpu_model, torch.device(device)),
                           ("cpu", cpu_model, torch.device("cpu"))):
        x = make_image_preprocessor(IMAGE, device=d)(images)
        feats = model.image_encoder(x)
        logits = model(x, torch.from_numpy(ids).long().to(d), torch.from_numpy(lens).long().to(d))
        out[name] = (feats.float().cpu(), torch.softmax(logits.float(), -1).cpu())
    f_gpu, p_gpu = out["cuda"]
    f_cpu, p_cpu = out["cpu"]
    feat_equal = torch.equal(f_gpu, f_cpu)
    dp = (p_gpu - p_cpu).abs().max().item()
    top_equal = bool((p_gpu.argmax(-1) == p_cpu.argmax(-1)).all())
    print(f"cross-device: features {tuple(f_gpu.shape)} bit-equal {feat_equal} "
          f"(max diff {(f_gpu - f_cpu).abs().max().item()}), probabilities max diff {dp} "
          f"(tolerance {PROB_TOL}), same top-1 {top_equal}", flush=True)
    if not feat_equal:
        raise AssertionError("VGG features differ between the card and the CPU plain path")
    if not (dp <= PROB_TOL and np.isfinite(p_gpu.numpy()).all()):
        raise AssertionError(f"probabilities differ by {dp} > {PROB_TOL}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from vqa_tpu_torch import _build

    card = card_line()
    print(card, flush=True)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    _build.build_all()
    print(f"build: {len(_build.KERNELS)} kernels in {time.perf_counter() - t0:.2f} s", flush=True)
    for k in _build.KERNELS:
        regs = [ln.strip() for ln in k.build_log.splitlines() if "registers" in ln]
        print(f"build {k.source}: {regs}", flush=True)

    dev = torch.device("cuda")
    errs, times = kernel_phase(dev)
    vocab_file, pairs = write_requests()
    predictor, launches = serve_phase(vocab_file, pairs)
    cross_device_phase(predictor, pairs)

    print(card, flush=True)
    print(json.dumps({"kernels": [
        {"name": k.symbol, "route": "cuda",
         "source": os.path.relpath(os.path.join(_build.CSRC, k.source), ROOT),
         "replaces": k.replaces, "launches": launches[k.symbol],
         "max_abs_err": errs[k.symbol], "ms": times[k.symbol][0],
         "plain_ms": times[k.symbol][1]} for k in _build.KERNELS]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
