#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root, with one card and the CUDA toolkit (nvcc):

    python3 chip_smoke.py

Phases, each of which must pass (the script exits non-zero otherwise, and
without CUDA it exits non-zero before printing any result):

1. the card's name and power limit (nvidia-smi);
2. build every CUDA kernel of the port from ``vqa_tpu_torch/csrc`` (one nvcc
   per source, started together), time the build, and count the
   tensor-core instructions in each kernel's SASS (``cuobjdump -sass``:
   every function of kernels A and B must hold integer ones, kernel C's
   bf16 body bf16 ones);
3. kernel phase, at the attention model's 448² shapes and again at the
   baseline and bert models' 224² (conv0 224 -> 112, conv1 at 112, conv2-3
   at 56, conv4-5 at 28, conv6-7 at 14): each kernel mode of the serving and
   training paths against its plain PyTorch version on the card, at 2
   samples and at batch 32: bit for bit, except kernel C in bf16, which sums
   on the tensor cores in another order and must lie within
   ``conv_stage1.conv0_f_bound`` (the share of elements that differ is
   printed). Then, at batch 32, each mode's time twice, the wrapper as the
   paths call it (weight packing included; the JSON line's ``ms``) and the
   launch alone (operands packed outside the timed call; ``launch_ms``),
   beside the plain version's time, its bound (the least time the card could
   take: bytes over the memory rate or operations over the peak rate for
   their type, whichever is larger) and a library yardstick: for kernels A
   and B ``torch._int_mm`` on the im2col matrix (A: its 27 taps zero-padded
   to 32; B: each layer's; the GEMM alone, its second operand column-major
   as cuBLASLt's int8 tensor-core GEMM takes it), for kernel C ``F.conv2d``
   (cuDNN, the conv alone). The JSON line carries the 448² numbers of kernel
   A's requant mode, kernel B's conv1-7 summed (static path) and kernel C in
   bf16; a line before it carries every mode at 224²;
4. serve phase: ``vqa_tpu_torch.serve.main`` answers 96 (image, question)
   requests with each model at full width and its own image size (attention
   448², baseline and bert 224²), batch 32, ``--opt_lvl 1`` (int8 stages
   0..7, fused stem, int8 hand-offs), random seeded weights and a synthetic
   vocab of bench.py's sizes; the launch counts are zeroed just before each
   model's run and read just after: kernel A once and kernel B 7 times per
   forward (3 batches and the calibration pass), no plain conv on a CUDA
   tensor;
5. cross-device phase (attention, baseline): 2 of those requests through the
   same weights and calibration on the CPU's plain path; the VGG conv
   features must be bit-equal and the probabilities within PROB_TOL;
6. train phase: ``vqa_tpu_torch.main.main`` trains at batch 32 on 192
   synthetic (image, question, answer) lines with 64 validation lines:
   the attention model's float route (``--opt_lvl 1 --int8_backbone false``:
   kernel C in bf16) and the baseline's at ``--opt_lvl 0`` (kernel C in
   f32, dropout live), each launching kernel C once per train step and per
   eval batch and A and B never, each resumed from its step-3 checkpoint with
   losses within RESUME_RTOL of the uninterrupted run's, each through
   ``--mode test``; then 2 steps of the default int8 route (calibration,
   kernels A and B) for the attention and bert models. Each run zeroes the
   counts just before and reads them just after.

Per-path launch counts go on a line of their own. The line before the last
is a JSON object of per-kernel launches (kernels A and B: the attention
model's serving path; kernel C: its float-route training run), errors,
times and bounds; the last is ``{"ok": true, "device": {...}}``.
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
N_REQUESTS, BATCH = 96, 32
IMAGE, IMAGE_224 = 448, 224        # attention; baseline and bert (config.MODEL_CONFIGS)
VOCAB_WORDS, SEQ_LEN, ANSWERS = 10000, 23, 1000        # bench.py:279 (K = 1001)
# CPU vs card probabilities: the question tower, co-attention and head run
# in bf16 on both, with different matmul kernels; the VGG features are equal
PROB_TOL = 1e-3
N_TRAIN, N_VAL = 192, 64
# the resumed run repeats steps 4-6 of the uninterrupted one from its
# checkpoint; the head's cuBLAS/cuDNN kernels (weight-gradient reductions
# among them) need not sum in the same order in two runs, so the losses are
# held to a relative tolerance instead of bit-equality
RESUME_RTOL = 1e-5
# H100 SXM peaks (NVIDIA's data sheet, dense, 700 W): HBM bytes/s, int8
# tensor-core ops/s, bf16 tensor-core FLOP/s (f32 sums), f32 CUDA-core FLOP/s
HBM_BPS, INT8_OPS, BF16_FLOPS, F32_FLOPS = 3.35e12, 1979e12, 989e12, 67e12


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


def timed(fn, n=20):
    """Mean ms of ``fn`` over two runs of ``n`` (after a warm-up)."""
    import torch
    fn()
    torch.cuda.synchronize()
    return (cuda_ms(fn, n) + cuda_ms(fn, n)) / 2


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(bytes_moved: int, ops: float, peak: float):
    """(ms, what sets it): the larger of bytes over the memory rate and
    operations over the peak rate for their type."""
    t_bytes, t_ops = bytes_moved / HBM_BPS, ops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def sass_counts():
    """Tensor-core instructions in each kernel's SASS (``cuobjdump -sass``),
    by function: {source: {function: {opcode: count}}}."""
    import re
    import shutil
    from vqa_tpu_torch import _build
    tool = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    tool = tool if os.path.exists(tool) else shutil.which("cuobjdump")
    if not tool:
        raise RuntimeError("cuobjdump not found next to nvcc")
    counts = {}
    for k in _build.KERNELS:
        sass = subprocess.run([tool, "-sass", _build._lib_path(k.source)], capture_output=True,
                              text=True, timeout=120, check=True).stdout
        funcs, name = {}, None
        for line in sass.splitlines():
            m = re.search(r"Function : (\S+)", line)
            if m:
                name = m.group(1)
                funcs[name] = {}
                continue
            for op in re.findall(r"\b(IMMA|IGMMA|HMMA|HGMMA)\.", line):
                funcs[name][op] = funcs[name].get(op, 0) + 1
        counts[k.source] = funcs
        for fn, ops in funcs.items():
            print(f"sass {k.source} {fn}: {ops or 'no tensor-core instructions'}", flush=True)
    b_ops = [op for ops in counts["conv3x3_i8.cu"].values() for op in ops]
    c_bf16 = [ops for fn, ops in counts["conv0_f.cu"].items() if "bf16" in fn]
    if not set(b_ops) & {"IMMA", "IGMMA"} or not c_bf16 \
            or not all(set(ops) & {"HMMA", "HGMMA"} for ops in c_bf16):
        raise AssertionError("kernel B lacks integer or kernel C's bf16 body bf16 "
                             "tensor-core instructions")
    a_funcs = counts["conv0_s2d_i8.cu"]
    if not a_funcs or not all(set(ops) & {"IMMA", "IGMMA"} for ops in a_funcs.values()):
        raise AssertionError("a function of kernel A lacks integer tensor-core instructions")
    return counts


def layer_shapes(image: int):
    """Kernel B's conv1-7 at an input of ``image``²: (name, H, C_in, C_out, pool)."""
    return [("conv1", image // 2, 64, 128, True), ("conv2", image // 4, 128, 256, False),
            ("conv3", image // 4, 256, 256, True), ("conv4", image // 8, 256, 512, False),
            ("conv5", image // 8, 512, 512, True), ("conv6", image // 16, 512, 512, False),
            ("conv7", image // 16, 512, 512, True)]


def kernel_phase(dev, image: int):
    """Every kernel mode on the paths vs its plain version at the ``image``²
    shapes, then times: the wrapper (packing included) and the launch alone
    (operands packed outside the timed call), beside the plain version, the
    bound and a library yardstick. Returns {(kernel, mode): row}, each row
    with the JSON line's fields (kernel B's conv1-7 summed per mode)."""
    import torch
    import torch.nn.functional as F
    from vqa_tpu_torch.ops import conv_hpack, conv_stage1

    g = torch.Generator().manual_seed(0)
    tag = f"{image}²"

    def ri(*shape):
        return torch.randint(-127, 128, shape, generator=g, dtype=torch.int8).to(dev)

    def rs(n, lo, hi):
        return (torch.rand(n, generator=g) * (hi - lo) + lo).to(dev)

    rows = {}

    def row(name, mode):
        return rows.setdefault((name, mode), {
            "max_abs_err": 0.0, "ms": 0.0, "launch_ms": 0.0, "plain_ms": 0.0,
            "bound_ms": 0.0, "bound_by": "bytes", "library_ms": None})

    def record(name, mode, ms, lms, pms, bms, by, lib=None):
        r = row(name, mode)
        r["ms"] += ms
        r["launch_ms"] += lms
        r["plain_ms"] += pms
        r["bound_ms"] += bms
        r["bound_by"] = by
        if lib is not None:
            r["library_ms"] = (r["library_ms"] or 0.0) + lib

    def check(name, mode, label, out, ref, tol=None):
        """Bit-equal, or within the per-element bound ``tol``."""
        torch.cuda.synchronize()
        diff = (out.float() - ref.float()).abs()
        err = diff.max().item()
        if tol is None:
            ok = torch.equal(out, ref)
            what = f"bit-equal {ok}"
        else:
            ok = bool((diff <= tol).all())
            what = (f"within bound {ok} (worst diff / bound "
                    f"{(diff / tol.clamp_min(1e-30)).max().item():.4f}), "
                    f"{100 * (out != ref).float().mean().item():.4f}% of elements differ")
        print(f"kernel {name} {tag} {label}: shape {tuple(out.shape)} {out.dtype} {what} "
              f"max_abs_err {err}", flush=True)
        if not ok:
            raise AssertionError(f"{name} {tag} {label}: kernel differs from its plain version")
        r = row(name, mode)
        r["max_abs_err"] = max(r["max_abs_err"], err)

    # kernel A: conv0, calibration pass (bf16 out, dynamic scale) and static
    # path (requant for conv1). The yardstick is torch._int_mm on kernel A's
    # im2col matrix, [B*H*W, 32] (27 taps x channels, zero-padded) x [32, 64]
    # with a column-major second operand: the GEMM alone, int32 out, without
    # im2col, pool or epilogue (timed here, never called by the port)
    for b in (2, BATCH):
        x = ri(b, image, image, 3)
        w = ri(3, 3, 3, 64)
        wf = conv_stage1.pack_conv0_i8_weights(w)
        sc, bias, s1 = rs(64, 1e-5, 1e-4), rs(64, -0.1, 0.1), rs(64, 1e-3, 2e-2)
        modes = {"calibration bf16": dict(out_dtype=torch.bfloat16),
                 "static requant": dict(s1=s1)}
        ims = None
        if b == BATCH:
            cols = torch.cat([F.pad(x, (0, 0, 1, 1, 1, 1))[:, ky:ky + image, kx:kx + image]
                              for ky in range(3) for kx in range(3)], -1)
            cols = F.pad(cols, (0, 5)).reshape(-1, 32)
            wmat = F.pad(w.reshape(27, 64), (0, 0, 0, 5)).t().contiguous().t()
            ims = timed(lambda: torch._int_mm(cols, wmat))  # noqa: B023
            print(f"time conv0_s2d_i8 {tag} b{b} torch._int_mm on im2col [{cols.shape[0]}, 32] "
                  f"x [32, 64]: {ims:.4f} ms "
                  f"({2.0 * cols.shape[0] * 32 * 64 / (ims * 1e-3) / 1e12:.1f} int8 TOP/s)",
                  flush=True)
            del cols
        for label, kw in modes.items():
            k = lambda: conv_stage1.conv0_i8(x, w, sc, bias, **kw)          # noqa: E731
            p = lambda: conv_stage1.conv0_i8_plain(x, w, sc, bias, **kw)    # noqa: E731
            # at b32 each persistent block walks over several tiles,
            # prefetching the next while it computes: checked there too
            check("conv0_s2d_i8", label, f"b{b} {label}", k(), p())
            if b == 2:
                continue
            ms, pms = timed_pair(k, p)
            lms = timed(lambda: conv_stage1.launch_conv0_i8(x, wf, sc, bias, **kw))
            out = k()
            bms, by = bound(nbytes(x, w, sc, bias, out) + (nbytes(s1) if "s1" in kw else 0),
                            2.0 * b * image * image * 27 * 64, INT8_OPS)
            record("conv0_s2d_i8", label, ms, lms, pms, bms, by, ims)
            print(f"time conv0_s2d_i8 {tag} b{b} {label}: wrapper {ms:.4f} ms "
                  f"({100 * bms / ms:.1f}% of bound), launch {lms:.4f} ms ({100 * bms / lms:.1f}% of bound), plain "
                  f"{pms:.4f} ms, bound {bms:.4f} ms ({by})", flush=True)
            del out
        del x

    # kernel B: conv1..conv7 (H, C_in, C_out, pool); the static path
    # requantizes for the next stage except conv7 (bf16 out), the
    # calibration pass stores bf16 everywhere. The yardstick is
    # torch._int_mm on the layer's im2col matrix: the GEMM alone, without
    # im2col, pool or epilogue (timed here, never called by the port). Its
    # second operand is column-major, the layout cuBLASLt's int8 tensor-core
    # GEMM takes; the TOP/s printed show the rate it reached
    for name, hw, c, o, pool in layer_shapes(image):
        for b in (2, BATCH):
            x, w = ri(b, hw, hw, c), ri(3, 3, c, o)
            wp = conv_hpack.pack_conv3x3_weights(w)
            sc, bias, sn = rs(o, 1e-6, 1e-5), rs(o, -0.1, 0.1), rs(o, 1e-3, 2e-2)
            static = dict(out_dtype=torch.bfloat16) if name == "conv7" else dict(s_next=sn)
            modes = {"static": static, "calibration bf16": dict(out_dtype=torch.bfloat16)}
            ims = None
            if b == BATCH:
                cols = torch.cat([F.pad(x, (0, 0, 1, 1, 1, 1))[:, ky:ky + hw, kx:kx + hw]
                                  for ky in range(3) for kx in range(3)], -1)
                cols, wmat = cols.reshape(-1, 9 * c), w.reshape(9 * c, o).t().contiguous().t()
                ims = timed(lambda: torch._int_mm(cols, wmat))  # noqa: B023
                print(f"time conv3x3_i8 {tag} {name} b{b} torch._int_mm on im2col "
                      f"[{cols.shape[0]}, {9 * c}] x [{9 * c}, {o}]: {ims:.4f} ms "
                      f"({2.0 * cols.shape[0] * 9 * c * o / (ims * 1e-3) / 1e12:.1f} int8 TOP/s)",
                      flush=True)
                del cols
            for label, kw in modes.items():
                args = (x, w, sc, bias)
                k = lambda: conv_hpack.int8_conv3x3(*args, pool=pool, **kw)  # noqa: E731
                p = lambda: conv_hpack.int8_conv3x3_plain(*args, pool=pool, **kw)  # noqa: E731
                check("conv3x3_i8", label, f"{name} b{b} {label}", k(), p())
                if b == 2:
                    continue
                ms, pms = timed_pair(k, p)
                lms = timed(lambda: conv_hpack.launch_int8_conv3x3(  # noqa: B023
                    x, wp, sc, bias, pool=pool, **kw))
                out = k()
                ops = 2.0 * b * hw * hw * c * o * 9
                bms, by = bound(nbytes(x, w, sc, bias, out)
                                + (nbytes(sn) if "s_next" in kw else 0), ops, INT8_OPS)
                del out
                record("conv3x3_i8", label, ms, lms, pms, bms, by, ims)
                print(f"time conv3x3_i8 {tag} {name} b{b} {label}: wrapper {ms:.4f} ms, launch "
                      f"{lms:.4f} ms ({ops / (lms * 1e-3) / 1e12:.1f} int8 TOP/s, "
                      f"{100 * bms / lms:.1f}% of bound), plain {pms:.4f} ms, bound {bms:.4f} ms "
                      f"({by})", flush=True)
            del x
    r = rows[("conv3x3_i8", "static")]
    print(f"time conv3x3_i8 {tag} conv1-7 static b{BATCH}: wrapper {r['ms']:.4f} ms "
          f"({100 * r['bound_ms'] / r['ms']:.1f}% of bound), launch {r['launch_ms']:.4f} ms "
          f"({100 * r['bound_ms'] / r['launch_ms']:.1f}% of bound), plain {r['plain_ms']:.4f} ms, "
          f"torch._int_mm {r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms", flush=True)

    # kernel C: float conv0 (int8 off), bf16 (the training route at
    # --opt_lvl >= 1; tensor cores, held within conv0_f_bound) and f32
    # (--opt_lvl 0; bit-equal); the library yardstick is cuDNN's conv alone
    # (no bias, ReLU or pool), in full f32 for f32 (TF32 off)
    for dt, label in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        for b in (2, BATCH):
            x = (torch.randn((b, image, image, 3), generator=g) * 1.5).to(dev, dt)
            w = (torch.randn((3, 3, 3, 64), generator=g) * 0.2).to(dev, dt)
            bias = (torch.randn(64, generator=g) * 0.1).to(dev, dt)
            k = lambda: conv_stage1.conv0_f(x, w, bias)          # noqa: E731
            p = lambda: conv_stage1.conv0_f_plain(x, w, bias)    # noqa: E731
            ref = p()
            tol = conv_stage1.conv0_f_bound(x, w, ref) if label == "bf16" else None
            check("conv0_f", label, f"b{b} {label}", k(), ref, tol)
            del ref, tol
            if b == 2:
                continue
            ms, pms = timed_pair(k, p)
            w32, b32 = conv_stage1.conv0_f_operands(x, w, bias)
            lms = timed(lambda: conv_stage1.launch_conv0_f(x, w32, b32))
            x_nchw, w_oihw = x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1).contiguous()
            tf32 = torch.backends.cudnn.allow_tf32
            torch.backends.cudnn.allow_tf32 = False
            try:
                lib = lambda: F.conv2d(x_nchw, w_oihw, padding=1)  # noqa: E731
                cms, _ = timed_pair(lib, lib, n_plain=20)
            finally:
                torch.backends.cudnn.allow_tf32 = tf32
            out = k()
            bms, by = bound(nbytes(x, w, bias, out), 2.0 * b * image * image * 27 * 64,
                            BF16_FLOPS if dt == torch.bfloat16 else F32_FLOPS)
            del out
            record("conv0_f", label, ms, lms, pms, bms, by, cms)
            print(f"time conv0_f {tag} b{b} {label}: wrapper {ms:.4f} ms, launch {lms:.4f} ms, "
                  f"plain {pms:.4f} ms, F.conv2d (conv only) {cms:.4f} ms, bound {bms:.4f} ms "
                  f"({by}, {100 * bms / ms:.1f}% of bound)", flush=True)
            del x
    return rows


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


def write_dataset(name: str, n: int, seed: int) -> str:
    """``n`` training lines (synthetic image names, questions over the
    vocab's words, answers among its labels) in the dataset .txt format."""
    import numpy as np
    rng = np.random.default_rng(seed)
    lines = []
    for i in range(n):
        k = int(rng.integers(3, SEQ_LEN + 1))
        q = ",".join(f"w{int(j)}" for j in rng.integers(2, VOCAB_WORDS, k))
        lines.append(f"{name}_{i:05d}.png\t{q}\ta{int(rng.integers(ANSWERS))}")
    path = os.path.join(WORK, f"{name}.txt")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


def serve_phase(vocab_file, pairs, model_name="attention", device="cuda"):
    """``vqa_tpu_torch.serve.main`` answers the requests with one model at
    its full width and image size, ``--opt_lvl 1`` (int8 stages 0..7, fused
    stem, int8 hand-offs); the counts are zeroed just before and read just
    after."""
    import numpy as np
    from vqa_tpu_torch import _build
    from vqa_tpu_torch.serve import main as serve_main

    out = os.path.join(WORK, f"preds_{model_name}.jsonl")
    _build.reset_counts()
    predictor = serve_main(["--model", model_name, "--vocab_file", vocab_file,
                            "--img_dir", WORK, "--input", pairs, "--output", out,
                            "--batch_size", str(BATCH), "--opt_lvl", "1",
                            "--synthetic_images", "--device", device])
    launches, plain_on_cuda = counts()
    with open(out) as f:
        rows = [json.loads(s) for s in f]
    model = predictor.model
    tag = f"serve {model_name} b{BATCH}@{predictor.image_size}²"
    print(f"{tag}: {len(rows)} answers, int8 stages {model.int8_stages}, fused stem "
          f"{model.vgg.fused_stem}, calibrated on batch {predictor.calibrated_on_batch}, "
          f"plain convs on CUDA {plain_on_cuda}", flush=True)
    print(f"launches path=serve model={model_name}: {json.dumps(launches)}", flush=True)
    if len(rows) != N_REQUESTS:
        raise AssertionError(f"expected {N_REQUESTS} answers, got {len(rows)}")
    probs = np.array([[p for _, p in r["topk"]] for r in rows])
    if not (np.isfinite(probs).all() and ((probs >= 0) & (probs <= 1)).all()):
        raise AssertionError("non-finite or out-of-range probabilities")
    if model.int8_stages != (0, 1, 2, 3, 4, 5, 6, 7) or predictor.calibrated_on_batch != 1 \
            or not model.vgg.fused_stem:
        raise AssertionError("the int8 stages did not calibrate on the first batch")
    # one VGG forward per request batch, plus the calibration pass
    forwards = 1 + -(-N_REQUESTS // BATCH)
    if launches["conv0_s2d_i8"] != forwards or launches["conv3x3_i8"] != 7 * forwards \
            or launches["conv0_f"]:
        raise AssertionError(f"the serving path did not run kernel A once and kernel B 7 "
                             f"times per forward: {launches}")
    if any(v != 0 for v in plain_on_cuda.values()):
        raise AssertionError(f"a plain conv ran on a CUDA tensor: {plain_on_cuda}")
    secs = predictor.batch_seconds
    steady = secs[1:3]
    print(f"{tag}: batch seconds {[round(s, 4) for s in secs]} (batch 1 calibrates); "
          f"batches 2-3: {2 * BATCH / sum(steady):.2f} QA/s, "
          f"{1e3 * sum(steady) / 2:.2f} ms per batch of {BATCH}", flush=True)
    return predictor, launches


def cross_device_phase(predictor, pairs, device="cuda"):
    """2 requests on the card and on the CPU's plain path, same weights and
    calibration: bit-equal VGG conv features, probabilities within PROB_TOL."""
    import numpy as np
    import torch
    from vqa_tpu_torch.config import build_model
    from vqa_tpu_torch.data.images import decode_batch
    from vqa_tpu_torch.data.pipeline import make_image_preprocessor

    gpu_model = predictor.model
    cpu_model, _ = build_model(predictor.model_name, predictor.vocab.size,
                               predictor.num_classes, device="cpu", opt_lvl=1,
                               int8_backbone=True,
                               max_seq_length=predictor.vocab.max_seq_length)
    cpu_model.load_state_dict({k: v.cpu() for k, v in gpu_model.state_dict().items()})
    cpu_model.int8_amax = gpu_model.int8_amax
    cpu_model.eval()
    with open(pairs) as f:
        lines = [ln.split("\t") for ln in f.read().splitlines()[:2]]
    size = predictor.image_size
    images = decode_batch([os.path.join(WORK, ln[0]) for ln in lines], size,
                          synthetic_fallback=True)
    ids, lens = predictor.encode_questions([ln[1] for ln in lines])
    out = {}
    for name, model, d in (("cuda", gpu_model, torch.device(device)),
                           ("cpu", cpu_model, torch.device("cpu"))):
        x = make_image_preprocessor(size, device=d)(images)
        with torch.no_grad():
            feats = model.vgg(x)
            logits = model(x, torch.from_numpy(ids).long().to(d),
                           torch.from_numpy(lens).long().to(d))
        out[name] = (feats.float().cpu(), torch.softmax(logits.float(), -1).cpu())
    f_gpu, p_gpu = out["cuda"]
    f_cpu, p_cpu = out["cpu"]
    feat_equal = torch.equal(f_gpu, f_cpu)
    dp = (p_gpu - p_cpu).abs().max().item()
    top_equal = bool((p_gpu.argmax(-1) == p_cpu.argmax(-1)).all())
    print(f"cross-device {predictor.model_name} {size}²: features {tuple(f_gpu.shape)} "
          f"bit-equal {feat_equal} (max diff {(f_gpu - f_cpu).abs().max().item()}), "
          f"probabilities max diff {dp} (tolerance {PROB_TOL}), same top-1 {top_equal}",
          flush=True)
    if not feat_equal:
        raise AssertionError("VGG features differ between the card and the CPU plain path")
    if not (dp <= PROB_TOL and np.isfinite(p_gpu.numpy()).all()):
        raise AssertionError(f"probabilities differ by {dp} > {PROB_TOL}")


def counts():
    from vqa_tpu_torch import _build
    return ({k.symbol: k.launches for k in _build.KERNELS},
            {k.symbol: k.plain_on_cuda for k in _build.KERNELS})


def train_phase(vocab_file, card="", device="cuda"):
    """Per model: a float-route run, its resume from step 3 and ``--mode
    test``, then the int8 route's calibration and 2 steps. attention: the
    float route at ``--opt_lvl 1`` (kernel C in bf16), the int8 route;
    baseline: the float route at ``--opt_lvl 0`` (kernel C in f32, dropout
    live); bert: the int8 route. Returns {path: launches}, each read just
    after its own run."""
    import shutil

    import torch
    from vqa_tpu_torch import _build
    from vqa_tpu_torch.main import main as vqa_main

    runs = os.path.join(WORK, "runs")
    shutil.rmtree(runs, ignore_errors=True)
    train, val = write_dataset("train", N_TRAIN, 1), write_dataset("val", N_VAL, 2)
    train_int8 = write_dataset("train_int8", 2 * BATCH, 3)
    path_launches = {}

    def args(model, mode, run, *extra, train_file=train):
        return ["--mode", mode, "--model", model, "--expt_dir", runs,
                "--expt_name", "smoke", "--run_name", f"{model}_{run}", "--train_img", WORK,
                "--train_file", train_file, "--val_img", WORK, "--val_file", val,
                "--vocab_file", vocab_file, "--batch_size", str(BATCH), "--num_epochs", "1",
                "--num_cls", str(ANSWERS), "--synthetic_images", "true", "--log_interval",
                "2", "--save_interval", "3", "--val_size", str(N_VAL), "--num_workers", "8",
                "--device", device, *extra]

    def run(model, path, *a, **kw):
        _build.reset_counts()
        out = vqa_main(args(model, *a, **kw))
        launches, plain = counts()
        path_launches[f"{path} {model}"] = launches
        print(f"launches path={path.replace(' ', '_')} model={model}: {json.dumps(launches)}",
              flush=True)
        if any(plain.values()):
            raise AssertionError(f"{path} {model} ran a plain conv on a CUDA tensor: {plain}")
        return out, launches

    def float_route(model, flags, mode_name):
        torch.cuda.reset_peak_memory_stats()
        full, launches = run(model, "train float", "train", "float", *flags)
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        losses = full["losses"]
        print(f"train {model} float route ({mode_name}): {full['steps']} steps, losses {losses}, "
              f"eval batches {full['eval_batches']}", flush=True)
        finite = all(v == v and abs(v) != float("inf") for v in losses)
        if full["steps"] != N_TRAIN // BATCH or not finite:
            raise AssertionError(f"the {model} float-route run did not train 6 finite steps")
        if launches["conv0_f"] != full["steps"] + full["eval_batches"]:
            raise AssertionError(f"{model}: kernel C did not run once per train step and "
                                 f"eval batch")
        if launches["conv0_s2d_i8"] or launches["conv3x3_i8"]:
            raise AssertionError(f"the {model} float route ran an int8 kernel")
        ckpt3 = os.path.join(full["log_dir"], "model_3.ckpt")
        if not os.path.exists(ckpt3):
            raise AssertionError("model_3.ckpt was not written")
        sync = dict(full["sync_points"])       # {steps done: train seconds}
        steady = sync[6] - sync[2]
        print(f"train {model} float route ({mode_name}; {card}): steps 3-6 "
              f"{4 * BATCH / steady:.2f} QA/s, {1e3 * steady / 4:.2f} ms per step of {BATCH} "
              f"(host clock, validation and checkpoint time taken out); peak device memory "
              f"{peak_gib:.2f} GiB (max_memory_allocated)", flush=True)

        resumed, launches = run(model, "train resume", "train", "float_resumed", *flags,
                                "--model_ckpt", ckpt3)
        rel = max(abs(a - b) / abs(b) for a, b in zip(resumed["losses"], losses[3:]))
        print(f"train {model} resume from step 3: losses {resumed['losses']} vs {losses[3:]}, "
              f"max relative difference {rel} (tolerance {RESUME_RTOL})", flush=True)
        if resumed["first_step"] != 3 or resumed["steps"] != 3 or not rel <= RESUME_RTOL:
            raise AssertionError(f"the resumed {model} run does not repeat steps 4-6")

        res, launches = run(model, "test", "test", "float", *flags, "--model_ckpt",
                            os.path.join(full["log_dir"], "model_6.ckpt"))
        print(f"test mode {model}: {res}", flush=True)
        if res["samples"] != N_VAL or not res["loss"] == res["loss"] \
                or launches["conv0_f"] != N_VAL // BATCH:
            raise AssertionError(f"{model} test mode did not evaluate the val file through "
                                 f"kernel C")
        shutil.rmtree(full["log_dir"])
        shutil.rmtree(resumed["log_dir"])

    def int8_route(model):
        out, launches = run(model, "train int8", "train", "int8", "--opt_lvl", "1",
                            "--int8_calib", "1", train_file=train_int8)
        # one VGG forward per calibration batch (--int8_calib 1), train step and
        # eval batch: kernel A once in each, kernel B for conv1-7
        forwards = 1 + out["steps"] + out["eval_batches"]
        print(f"train {model} int8 route: {out['steps']} steps, {out['eval_batches']} eval "
              f"batches, 1 calibration batch, losses {out['losses']}", flush=True)
        finite = all(v == v and abs(v) != float("inf") for v in out["losses"])
        if out["steps"] != 2 or not finite:
            raise AssertionError(f"the {model} int8-route run did not train 2 finite steps")
        if launches["conv0_s2d_i8"] != forwards or launches["conv3x3_i8"] != 7 * forwards \
                or launches["conv0_f"]:
            raise AssertionError(f"the {model} int8 route did not run kernel A once and "
                                 f"kernel B 7 times per forward, and nothing else")
        if not os.path.exists(os.path.join(out["log_dir"], "int8_calib.json")):
            raise AssertionError("int8_calib.json was not written")
        shutil.rmtree(out["log_dir"])

    float_route("attention", ("--opt_lvl", "1", "--int8_backbone", "false"), "bf16")
    int8_route("attention")
    float_route("baseline", ("--opt_lvl", "0"), "f32, --opt_lvl 0")
    int8_route("bert")
    return path_launches


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

    sass_counts()
    dev = torch.device("cuda")
    # the attention model's shapes (448²), then the baseline and bert models' (224²)
    rows = {image: kernel_phase(dev, image) for image in (IMAGE, IMAGE_224)}
    vocab_file, pairs = write_requests()
    serve_launches = {}
    for model_name in ("attention", "baseline", "bert"):
        predictor, serve_launches[model_name] = serve_phase(vocab_file, pairs, model_name)
        if model_name != "bert":
            cross_device_phase(predictor, pairs)
        del predictor
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    train_launches = train_phase(vocab_file, card)
    print(f"train phase: {time.perf_counter() - t0:.2f} s", flush=True)

    def kernel_fields(image, k, mode):
        r = rows[image][(k.symbol, mode)]
        return {"name": k.symbol, "route": "cuda",
                "source": os.path.relpath(os.path.join(_build.CSRC, k.source), ROOT),
                "replaces": k.replaces,
                "max_abs_err": max(v["max_abs_err"] for rs in rows.values()
                                   for (name, _), v in rs.items() if name == k.symbol),
                **{f: r[f] for f in ("ms", "launch_ms", "plain_ms", "bound_ms", "bound_by",
                                     "library_ms")}}

    # the JSON line's modes: kernel A's requant, kernel B's conv1-7 static
    # path summed, kernel C in bf16; every mode at 224² on the line above it
    json_modes = {"conv0_s2d_i8": "static requant", "conv3x3_i8": "static", "conv0_f": "bf16"}
    print("kernels at 224² (b32; baseline and bert): " + json.dumps([
        {**kernel_fields(IMAGE_224, k, mode), "mode": mode}
        for k in _build.KERNELS for (name, mode) in rows[IMAGE_224] if name == k.symbol]),
        flush=True)
    by_path = {**{f"serve {m}": v for m, v in serve_launches.items()}, **train_launches}
    print("launches by path: " + json.dumps(by_path), flush=True)
    # launches: kernels A and B from the attention model's serving path,
    # kernel C from its float-route training run (each read just after its
    # own run)
    path_launches = {**serve_launches["attention"],
                     "conv0_f": train_launches["train float attention"]["conv0_f"]}
    print(card, flush=True)
    print(json.dumps({"kernels": [
        {**kernel_fields(IMAGE, k, json_modes[k.symbol]), "launches": path_launches[k.symbol]}
        for k in _build.KERNELS]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
