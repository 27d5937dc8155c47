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
   every function of kernels A and B must hold integer ones, every function
   of kernel C float ones (HMMA or HGMMA), every function of kernel D
   warpgroup MMAs (HGMMA), kernel E's GEMM bodies HGMMA and its phase-(ii)
   body tensor-core ones (HMMA or HGMMA), kernel F's two s8 bodies (128-
   and 64-byte K chunks) IGMMA and its two bf16 bodies HGMMA), and print
   each of D's, E's and F's functions' registers, stack and local bytes
   (``cuobjdump -res-usage``): a stack frame or local memory in a function
   of kernel D or F (a spill) fails;
3. kernel phase, at the attention model's 448² shapes and again at the
   baseline and bert models' 224² (conv0 224 -> 112, conv1 at 112, conv2-3
   at 56, conv4-5 at 28, conv6-7 at 14): each kernel mode of the serving and
   training paths against its plain PyTorch version on the card, at 2
   samples and at batch 32: bit for bit, except kernel C, which sums on the
   tensor cores in another order (in f32 through 3xTF32) and must lie within
   ``conv_stage1.conv0_f_bound`` (the worst diff / bound and the share of
   elements that differ are printed). Then, at batch 32, each mode's time
   twice, the wrapper as the paths call it (weight packing included; the
   JSON line's ``ms``) and the launch alone (operands packed outside the
   timed call; ``launch_ms``), beside the plain version's time, its bound
   (the least time the card could take: bytes over the memory rate or
   operations over the peak rate for their type, whichever is larger;
   kernel C's f32 mode counts its 3xTF32 operations, and its CUDA-core bound
   of earlier slices is printed beside it) and a library yardstick: for
   kernels A and B ``torch._int_mm`` on the im2col matrix (A: its 27 taps
   zero-padded to 32; B: each layer's; the GEMM alone, its second operand
   column-major as cuBLASLt's int8 tensor-core GEMM takes it), for kernel C
   ``F.conv2d`` (cuDNN, the conv alone; in f32 with TF32 off), and the host
   time of a call through the kernel's registered operator against a direct
   call of the operator's CUDA implementation (the operator's dispatch;
   JSON ``dispatch_us``). The JSON line
   carries the 448² numbers of kernel A's requant mode, kernel B's conv1-7
   summed (static path) and kernel C in bf16; lines before it carry every
   mode at 448² and at 224²;
   Then kernels D and E (``last_kernels_phase``): their paths first, with
   the counts zeroed just before and read just after:
   ``conv_hpack.conv_bn_relu_pool`` with its default float route on VGG
   conv1's input (x [32, 224, 224, 64] at 448², [32, 112, 112, 64] at 224²),
   bf16 and f32 (D 4 launches), and ``coattention_fused`` forward and
   backward at the attention model's shape (b32, S 196, L = the vocab's
   max_seq_length, D 512), bf16 and f32 (E 2). Then D within
   ``conv3x3_f_bound`` and E within ``coattention_bound`` of their plain
   versions, E's gradients equal (1e-6 of the largest) to autograd through
   ``coattention_reference`` for the same cotangent, and each mode timed as
   above (D's yardstick ``F.conv2d``, TF32 off in f32; E has none: one
   PyTorch call does not compute its function), with the device time of
   each of their CUDA kernels (D's one, E's GEMM, phase (ii) and pooling
   launches) from ``torch.profiler``;
   Then the probes phase (``probes_phase``): every timing probe of
   ``vqa_tpu_torch.tools`` (the port of the TPU probes ``tools/exp_*.py``,
   rows 6a-6k of PERF.md's table) at its default shapes and b160: each
   variant's kernel held against its plain version (A, B and F bit-equal;
   C within ``conv0_f_bound``, D within ``conv3x3_f_bound``): the
   wrapper's b160 output, its first and last 2 samples against the plain
   version on those samples (D and F every sample), F also on random small
   integers at its full grid; then timed with PROBE_STEPS calls (wrapper,
   launch alone, yardstick over the whole batch (the int8 im2col GEMMs in
   b32 slices, summed, where b160's operands pass 8 GB), plain where it
   fits, bound), the counts zeroed just before each variant's timed calls
   and read just after, and the last timed wrapper call's and launch's
   outputs held as before; kernel F's rate against the published peaks,
   against one GEMM of its operations and against the library's large
   GEMMs (M = N = 8,192, K 4,096-16,384). Kernel F's and kernel D's
   unpooled rows of the JSON lines come from here;
   Then the moe phase (``moe_phase``): the ``kimi_vl`` head at the
   registry's sizes takes one b160 training step on random tower features,
   its grouped-GEMM launches counted (24: 3 a product, 2 products, 4
   expert layers), and the first expert layer's operands of that step (its
   own router's routing) check both products' forward and gradients row by
   row against the plain per-expert version, then time them beside their
   bound; its row ends the ``kernels`` line;
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
6. export phase: the serve phase's calibrated attention predictor (int8,
   448², b32) answers the 96 requests live, exports with
   ``vqa_tpu_torch.export.export_predictor`` (seconds and MB printed; no
   kernel may launch while it exports), and a fresh process
   (``exported_serve``) loads the artifact with ``ExportedPredictor`` on the
   card, imports no model module and no JAX, and answers the same requests:
   probabilities bit-equal to the live ones, kernel A 3 and B 21 launches;
   then the same for the baseline at 224² and ``--opt_lvl 0`` (f32, seeded
   weights): kernel C 3 launches. Each side then serves the requests again,
   bit for bit; exported and live QA/s over batches 2-3 of that warm pass
   and the load seconds are printed;
7. train phase: ``vqa_tpu_torch.main.main`` trains at batch 32 on 192
   synthetic (image, question, answer) lines with 64 validation lines:
   the attention model's float route (``--opt_lvl 1 --int8_backbone false``:
   kernel C in bf16) and the baseline's at ``--opt_lvl 0`` (kernel C in
   f32, dropout live), each launching kernel C once per train step and per
   eval batch and A and B never, each resumed from its step-3 checkpoint with
   losses within RESUME_RTOL of the uninterrupted run's, each through
   ``--mode test``; then 2 steps of the default int8 route (calibration,
   kernels A and B) for the attention and bert models. Each run zeroes the
   counts just before and reads them just after;
8. the slice's training paths, on the same 192 and 64 lines at batch 32:
   the attention model with ``--vgg_train true --opt_lvl 1`` at 448² (the
   VGG trains through cuDNN with batch-stats BatchNorm and remat, Adam over
   every parameter; no kernel launches), 6 finite steps with a VGG conv
   weight moved off its initial value, steps 3-6 QA/s and the peak device
   memory, its resume from step 3 within VGG_RESUME_RTOL, then ``--mode
   test``; the baseline with ``--bn_mode batch`` on the default int8 route
   at 224² and ``--profile_steps 2``: kernels A and B launched by the
   calibration and the eval batches only (train steps take batch statistics
   and bypass them), the running stats moved and every VGG parameter not,
   and a non-empty trace in the run directory; 2 steps of the attention
   model with ``--grad_accum 2`` on the int8 route: kernel A once per
   calibration batch, microbatch and eval batch, kernel B 7 times as often.

9. ETL phase: a synthetic VQA-v2 annotations/questions JSON pair with COCO
   image ids (96 train images and 32 val images, two questions each: 192
   and 64 lines) through ``python -m vqa_tpu_torch.prepare_data
   --balanced_real_images`` (``-s train`` with ``-v``, then ``-s val``), as
   a user runs it; then one 640x480 JPEG (quality 90, seeded smooth
   gradient plus noise) per image under the COCO name the ETL wrote;
10. decode phase at 448² and 224² over those JPEGs: ``pil`` on 8 threads,
   ``native`` on 8 threads and ``native_mp`` on 8 worker processes, with
   images/s and ``os.cpu_count()``; ``native_mp`` equal to ``native`` byte
   for byte, ``native`` within a mean absolute difference of 12 of ``pil``.
   The native decoder needs libjpeg's headers: the script checks for them
   first (``<cstdio>`` then ``<jpeglib.h>`` through ``g++ -fsyntax-only``) and,
   where they are missing, says so on a line of its own and runs ``pil``
   alone, here and in the cache phases;
11. cache phases, on the ETL's files and JPEGs at batch 32: the attention
   model at 448² on the int8 route (``--opt_lvl 1 --int8_calib 1``): an
   uncached run (whose ``auto`` decode engine resolves to ``native_mp``, or
   ``pil`` without the native decoder), a ``--cache_features true`` run
   that builds the train and val caches, and the same again, which reuses
   them; kernel A launched exactly once per calibration batch and build
   batch and kernel B 7 times as often, none from train steps or eval
   batches; the baseline at 224² on the float route (``--opt_lvl 0``,
   dropout live) uncached, then cached: kernel C once per build batch, A
   and B never, the classifier head's dropouts run in every cached step.
   The cached losses must equal the uncached ones within RESUME_RTOL (the
   cache stores exactly what the head receives, so they are expected
   bit-equal); build seconds, images/s, cache MB, QA/s over steps 3-6 and
   the peak device memory are printed beside the card.

12. multi-device phase (``vqa_tpu_torch.parallel``): the attention model at
   448² on the int8 route (b32, 6 steps) through ``--force_mesh true`` (a
   NCCL group of one: DDP) and ``--force_mesh true --fsdp true`` (FSDP2),
   losses bit-equal to the same command without a mesh (FSDP within
   FSDP_RTOL) and kernels A and B launched as that run's, and ``--mode
   test`` on the checkpoint the FSDP run gathered, on the mesh and off it
   (equal results, A 1 and B 7 for its one batch); then
   ``multichip.dryrun_multichip(1)``: a DP step and the tp+sp+fsdp step on the
   degenerate (1, 1) ``("data", "model")`` mesh, losses within DRYRUN_TOL, A 3
   and B 21 launches (calibration and two steps); then two ranks through
   the user's entry point (``main.main`` with torchrun's environment), NCCL
   over two cards where there are two, else gloo with both ranks on this
   card (it prints which), 16 rows a rank, 3 steps: the ranks' trainable
   parameters bit-equal after every step (an exact checksum), the losses
   within TWO_RANK_RTOL of world 1, and every rank's launches summed (each
   calibrates on the full batch); then the baseline's float route at 224²
   (``--opt_lvl 0``, kernel C in f32, dropout live) through DDP at world 1,
   bit-equal to the run without a mesh. QA/s, the step time over the run
   without a mesh, the peak device memory of each rank and the phase's
   seconds are printed beside the card.

13. tools phase (``tools_phase``, after the cache phase; ``vqa_tpu_torch.tools.
   TOOLS``, the port of the JAX repo's run tools), each step with its
   seconds: (a) BASELINE.md round 2's dataset from the port's generator
   (redblue, K = 2, 10,000 train and 2,000 val pairs of 224² JPEGs, seed 0)
   and ``run_accuracy`` on it: the baseline, b32, one epoch, Adam 1e-4, the
   generated random-init ``.pth``, frozen VGG, on the f32 float route
   (``--opt_lvl 0``: kernel C once a train step and eval batch), the int8
   route (``--opt_lvl 1``: 8 calibration batches, then A once and B 7 times
   a forward) and ``--opt_lvl 0 --bn_mode batch`` (C in the eval batches
   only): each at least ACC_MIN % validation accuracy, its launches exact,
   its loss, QA/s and seconds printed; (b) the dress rehearsal (prepare_data,
   JPEGs, train, test with VQA-format output, ``loadRes``, serve; attention
   at 448², b8, in fresh processes on the card); (c) the serving latency at
   b1, b8 and b32 (a forward: A once, B 7 times); (d) ``mem_report``'s four
   b160 configurations (one real step each, after a warm-up: peak allocated
   and reserved memory, the b32 point and the batch headroom; A once and B
   7 times a forward, C once on the float route); (e) ``profile_headline``
   (attention int8 b160 448² train step, 3 traced steps: the op groups, A's
   and B's device ms a step, the idle share); (f) ``profile_vgg`` (the 8
   stages at b160 on both routes, bit-equal to the model's forward).

Per-path launch counts go on a line of their own. The line before the last
is a JSON object of per-kernel launches (kernels A and B: the attention
model's serving path; kernel C: its float-route training run; kernels D and
E: their paths in ``last_kernels_phase``; kernel F: the probes phase),
errors, times and bounds, then the grouped expert products' row (route
``library``, from the moe phase); the last is ``{"ok": true, "device":
{...}}``.
"""

from __future__ import annotations

import json
import os
import pickle
import re
import subprocess
import sys
import time

# the card's peaks, the bound rule and the timers, shared with the probes
from vqa_tpu_torch.tools._probe import (BF16_FLOPS, F32_FLOPS, INT8_OPS, TF32_FLOPS, bound,
                                        card_line, cuda_ms, cudnn_conv, nbytes)

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
# the trainable VGG's resume (--vgg_train true): its losses were bit-equal in
# two runs on an H100 80GB HBM3 at 700 W, but cuDNN's weight-gradient
# algorithms may sum with atomics, and in a trainable batch-stats tower fp32
# summation-order differences grew to 2.5e-5 relative within 3 Adam steps
# (the CPU parity runs of tests/test_torch_vgg_train.py): 1e-4 holds that
# with a margin of 4
VGG_RESUME_RTOL = 1e-4
# the ETL and cache phases: COCO-named JPEGs, two questions an image
N_CACHE_TRAIN_IMAGES, N_CACHE_VAL_IMAGES, QUESTIONS_PER_IMAGE = 96, 32, 2
JPEG_W, JPEG_H, JPEG_QUALITY = 640, 480, 90
DECODE_THREADS = 8
# vqa_tpu's bound on the native decoder's distance from PIL (another DCT
# method and resampler): mean absolute difference per channel value
NATIVE_PIL_MEAN_ABS = 12.0
# the timing probes (vqa_tpu_torch.tools): bench.py's default batch, as the
# TPU probes' BENCH_BATCH, and timed calls a variant
PROBE_BATCH, PROBE_STEPS = 160, 4
# the grouped expert products against their plain version, row by row: bf16
# operands and output round to 2^-9, and a row sums 1,408-2,816 products
MOE_ROW_TOL = 1e-2


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


def host_us(fn, n=50) -> float:
    """Mean host microseconds for a call to return (its enqueue), between
    synchronizations."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * t / n


def dispatch_pair(op_fn, direct_fn, rounds=6):
    """Host µs a call through the registered operator and a direct call of
    its CUDA implementation take: the least of ``rounds`` runs of each, in
    turns (op, direct, direct, op, ...; after a warm-up), as a shared host's
    interruptions only ever add time."""
    op_fn(), direct_fn()
    ops, directs = [], []
    for i in range(rounds):
        pair = (op_fn, direct_fn) if i % 2 == 0 else (direct_fn, op_fn)
        t = [host_us(fn) for fn in pair]
        ops.append(t[0] if i % 2 == 0 else t[1])
        directs.append(t[1] if i % 2 == 0 else t[0])
    return min(ops), min(directs)


def sass_counts():
    """Tensor-core instructions in each kernel's SASS (``cuobjdump -sass``),
    by function: {source: {function: {opcode: count}}}; checks them, and
    prints kernels D's, E's and F's registers, stack and local bytes (a
    spill in kernel D or F fails)."""
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
    c_funcs = counts["conv0_f.cu"]
    if not set(b_ops) & {"IMMA", "IGMMA"} or len(c_funcs) < 2 \
            or not all(set(ops) & {"HMMA", "HGMMA"} for ops in c_funcs.values()):
        raise AssertionError("kernel B lacks integer tensor-core instructions, or a "
                             "function of kernel C float ones")
    # kernel D: wgmma in each of its 6 functions (pooled for bf16 and f32,
    # unpooled for bf16 and f32 with 1 and 2 streams); kernel E: wgmma in its
    # GEMM (phase (i)) bodies, tensor-core MMAs in its phase-(ii) body
    d_funcs = counts["conv3x3_f.cu"]
    d_pooled = [fn for fn in d_funcs if "conv3x3_f_kernelI" in fn]
    d_unpooled = [fn for fn in d_funcs if "conv3x3_f_kernel_unpooledI" in fn]
    e_funcs = counts["coattention_fwd.cu"]
    e_gemms = [ops for fn, ops in e_funcs.items() if "coatt_gemm_kernel" in fn]
    e_slices = [ops for fn, ops in e_funcs.items() if "coatt_slice_kernel" in fn]
    if len(d_pooled) != 2 or len(d_unpooled) != 4 or len(d_funcs) != 6 \
            or not all("HGMMA" in ops for ops in d_funcs.values()):
        raise AssertionError("kernel D lacks one of its 2 pooled and 4 unpooled functions, or "
                             f"one lacks warpgroup MMAs (HGMMA): {d_funcs}")
    if len(e_gemms) < 2 or not all("HGMMA" in ops for ops in e_gemms) or not e_slices \
            or not all(set(ops) & {"HMMA", "HGMMA"} for ops in e_slices):
        raise AssertionError("kernel E's GEMM bodies lack HGMMA, or its phase-(ii) body "
                             "tensor-core instructions")
    a_funcs = counts["conv0_s2d_i8.cu"]
    if not a_funcs or not all(set(ops) & {"IMMA", "IGMMA"} for ops in a_funcs.values()):
        raise AssertionError("a function of kernel A lacks integer tensor-core instructions")
    # kernel F: s8 and bf16 bodies, each with 128- and 64-byte K chunks
    f_funcs = counts["mma_rate.cu"]
    f_s8 = [ops for ops in f_funcs.values() if "IGMMA" in ops]
    f_bf16 = [ops for ops in f_funcs.values() if "IGMMA" not in ops]
    if len(f_funcs) != 4 or len(f_s8) != 2 or len(f_bf16) != 2 \
            or not all("HGMMA" in ops for ops in f_bf16):
        raise AssertionError("kernel F lacks its s8 (IGMMA) or bf16 (HGMMA) warpgroup MMAs")
    for source, name in (("conv3x3_f.cu", "D"), ("coattention_fwd.cu", "E"),
                         ("mma_rate.cu", "F")):
        usage = resource_usage(tool, _build._lib_path(source))
        for fn, res in usage.items():
            print(f"resources {source} {fn}: registers {res['REG']}, stack {res['STACK']} B, "
                  f"local {res['LOCAL']} B", flush=True)
        if name in "DF" and (set(usage) != set(counts[source]) or any(
                res["STACK"] or res["LOCAL"] for res in usage.values())):
            raise AssertionError(f"kernel {name} spills (stack or local bytes), or its "
                                 f"resource report misses a function: {usage}")
    return counts


def resource_usage(tool: str, lib: str):
    """{function: {"REG": n, "STACK": bytes, "LOCAL": bytes, ...}} from
    ``cuobjdump -res-usage``."""
    out = subprocess.run([tool, "-res-usage", lib], capture_output=True, text=True, timeout=120,
                         check=True).stdout
    usage, name = {}, None
    for line in out.splitlines():
        m = re.search(r"Function (\S+):", line)
        if m:
            name = m.group(1)
            continue
        if name and "REG:" in line:
            usage[name] = {k: int(v) for k, v in re.findall(r"(\w+):(\d+)", line)}
            name = None
    return usage


def device_ms_by_kernel(fn, names, n=10):
    """Mean device ms a call of ``fn`` spends in each CUDA kernel whose name
    contains one of ``names``, from ``torch.profiler`` over ``n`` calls
    (after a warm-up); None where the profiler saw no device time."""
    import torch
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    avgs = prof.key_averages()
    key = "self_device_time_total" if avgs and hasattr(avgs[0], "self_device_time_total") \
        else "self_cuda_time_total"
    found = {}
    for name in names:
        us = sum(getattr(a, key) for a in avgs if name in a.key)
        found[name] = us / 1e3 / n if us > 0 else None
    return found


def profile_line(label, times):
    return f"device time by kernel {label}: " + ", ".join(
        f"{name} {'not measured' if ms is None else f'{ms:.4f} ms'}"
        for name, ms in times.items())


class KernelRows:
    """The JSON lines' rows, one per (kernel, mode): the worst error over its
    checks, and its times and bounds summed over its timed calls."""

    def __init__(self):
        self.rows = {}

    def row(self, name, mode):
        return self.rows.setdefault((name, mode), {
            "max_abs_err": 0.0, "ms": 0.0, "launch_ms": 0.0, "plain_ms": 0.0,
            "bound_ms": 0.0, "bound_by": "bytes", "library_ms": None,
            "op_host_us": 0.0, "direct_host_us": 0.0, "calls": 0})

    def record(self, name, mode, ms, lms, pms, bms, by, lib=None, disp=(0.0, 0.0)):
        r = self.row(name, mode)
        r["ms"] += ms
        r["launch_ms"] += lms
        r["plain_ms"] += pms
        r["bound_ms"] += bms
        r["bound_by"] = by
        r["op_host_us"] += disp[0]
        r["direct_host_us"] += disp[1]
        r["calls"] += 1
        if lib is not None:
            r["library_ms"] = (r["library_ms"] or 0.0) + lib

    def check(self, name, mode, label, out, ref, tol=None):
        """Bit-equal, or within the per-element bound ``tol``; raises if not."""
        import torch
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
        print(f"kernel {name} {label}: shape {tuple(out.shape)} {out.dtype} {what} "
              f"max_abs_err {err}", flush=True)
        if not ok:
            raise AssertionError(f"{name} {label}: kernel differs from its plain version")
        r = self.row(name, mode)
        r["max_abs_err"] = max(r["max_abs_err"], err)


def cudnn_conv_ms(x, w) -> float:
    """ms of ``_probe.cudnn_conv``'s ``F.conv2d`` (cuDNN, pad 1: the conv
    alone, no bias, ReLU or pool) in full f32 for f32 (TF32 off: with TF32
    on, cuDNN computes a less accurate function). A yardstick, never called
    by the port."""
    import torch
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        lib = cudnn_conv(x, w)[0]
        return timed_pair(lib, lib, n_plain=20)[0]
    finally:
        torch.backends.cudnn.allow_tf32 = tf32


def dispatch_line(disp):
    return (f"host per call through the operator {disp[0]:.1f} us, its CUDA implementation "
            f"called directly {disp[1]:.1f} us (dispatch {disp[0] - disp[1]:.1f} us)")


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
    from vqa_tpu_torch.ops import conv_hpack, conv_stage1, library

    g = torch.Generator().manual_seed(0)
    tag = f"{image}²"

    def ri(*shape):
        return torch.randint(-127, 128, shape, generator=g, dtype=torch.int8).to(dev)

    def rs(n, lo, hi):
        return (torch.rand(n, generator=g) * (hi - lo) + lo).to(dev)

    kr = KernelRows()
    row, record = kr.row, kr.record

    def check(name, mode, label, out, ref, tol=None):
        kr.check(name, mode, f"{tag} {label}", out, ref, tol)

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
            disp = dispatch_pair(k, lambda: library.CUDA_IMPLS["conv0_i8"](  # noqa: B023
                x, w, sc, bias, kw.get("out_dtype", torch.float32), kw.get("s1")))
            out = k()
            bms, by = bound(nbytes(x, w, sc, bias, out) + (nbytes(s1) if "s1" in kw else 0),
                            2.0 * b * image * image * 27 * 64, INT8_OPS)
            record("conv0_s2d_i8", label, ms, lms, pms, bms, by, ims, disp)
            print(f"time conv0_s2d_i8 {tag} b{b} {label}: wrapper {ms:.4f} ms "
                  f"({100 * bms / ms:.1f}% of bound), launch {lms:.4f} ms ({100 * bms / lms:.1f}% of bound), plain "
                  f"{pms:.4f} ms, bound {bms:.4f} ms ({by}); {dispatch_line(disp)}", flush=True)
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
                disp = dispatch_pair(k, lambda: library.CUDA_IMPLS["int8_conv3x3"](  # noqa: B023
                    x, w, sc, bias, pool, kw.get("s_next"), kw.get("out_dtype", torch.float32)))
                out = k()
                ops = 2.0 * b * hw * hw * c * o * 9
                bms, by = bound(nbytes(x, w, sc, bias, out)
                                + (nbytes(sn) if "s_next" in kw else 0), ops, INT8_OPS)
                del out
                record("conv3x3_i8", label, ms, lms, pms, bms, by, ims, disp)
                print(f"time conv3x3_i8 {tag} {name} b{b} {label}: wrapper {ms:.4f} ms, launch "
                      f"{lms:.4f} ms ({ops / (lms * 1e-3) / 1e12:.1f} int8 TOP/s, "
                      f"{100 * bms / lms:.1f}% of bound), plain {pms:.4f} ms, bound {bms:.4f} ms "
                      f"({by}); {dispatch_line(disp)}", flush=True)
            del x
    r = kr.rows[("conv3x3_i8", "static")]
    print(f"time conv3x3_i8 {tag} conv1-7 static b{BATCH}: wrapper {r['ms']:.4f} ms "
          f"({100 * r['bound_ms'] / r['ms']:.1f}% of bound), launch {r['launch_ms']:.4f} ms "
          f"({100 * r['bound_ms'] / r['launch_ms']:.1f}% of bound), plain {r['plain_ms']:.4f} ms, "
          f"torch._int_mm {r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms; "
          f"{dispatch_line((r['op_host_us'], r['direct_host_us']))} for the 7 calls", flush=True)

    # kernel C: float conv0 (int8 off), bf16 (the training route at
    # --opt_lvl >= 1) and f32 (--opt_lvl 0; 3xTF32), both on the tensor
    # cores and held within conv0_f_bound; the library yardstick is cuDNN's
    # conv alone (no bias, ReLU or pool), in full f32 for f32 (TF32 off:
    # with TF32 on, cuDNN computes a less accurate function)
    for dt, label in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        for b in (2, BATCH):
            x = (torch.randn((b, image, image, 3), generator=g) * 1.5).to(dev, dt)
            w = (torch.randn((3, 3, 3, 64), generator=g) * 0.2).to(dev, dt)
            bias = (torch.randn(64, generator=g) * 0.1).to(dev, dt)
            k = lambda: conv_stage1.conv0_f(x, w, bias)          # noqa: E731
            p = lambda: conv_stage1.conv0_f_plain(x, w, bias)    # noqa: E731
            ref = p()
            tol = conv_stage1.conv0_f_bound(x, w, ref)
            check("conv0_f", label, f"b{b} {label}", k(), ref, tol)
            del ref, tol
            if b == 2:
                continue
            ms, pms = timed_pair(k, p)
            disp = dispatch_pair(k, lambda: library.CUDA_IMPLS["conv0_f"](x, w, bias))  # noqa: B023
            w32, b32 = conv_stage1.conv0_f_operands(x, w, bias)
            wk = conv_stage1.conv0_f_kernel_weights(x, w32)
            lms = timed(lambda: conv_stage1.launch_conv0_f(x, wk, b32))
            cms = cudnn_conv_ms(x, w)
            out = k()
            moved, macs = nbytes(x, w, bias, out), b * image * image * 27 * 64
            if dt == torch.bfloat16:
                bms, by = bound(moved, 2.0 * macs, BF16_FLOPS)
                old = ""
            else:
                bms, by = bound(moved, 3 * 2.0 * macs, TF32_FLOPS)
                cc_ms, cc_by = bound(moved, 2.0 * macs, F32_FLOPS)
                row("conv0_f", label)["cuda_core_bound_ms"] = cc_ms
                old = (f"; CUDA-core f32 bound of earlier slices {cc_ms:.4f} ms ({cc_by}, "
                       f"{100 * cc_ms / lms:.1f}% of it at launch)")
            del out
            record("conv0_f", label, ms, lms, pms, bms, by, cms, disp)
            print(f"time conv0_f {tag} b{b} {label}: wrapper {ms:.4f} ms, launch {lms:.4f} ms, "
                  f"plain {pms:.4f} ms, F.conv2d (conv only) {cms:.4f} ms, bound {bms:.4f} ms "
                  f"({by}, {100 * bms / ms:.1f}% of bound, {100 * bms / lms:.1f}% at launch)"
                  f"{old}; {dispatch_line(disp)}", flush=True)
            del x
    return kr.rows


def last_kernels_phase(dev, seq_len: int, card: str):
    """Kernels D (the pooled conv's float route) and E (the fused
    co-attention forward): first their paths, with the counts zeroed just
    before and read just after: ``conv_bn_relu_pool`` with its default
    ``int8=False`` on VGG conv1's input at 448² and at 224², b32, bf16 and
    f32, and ``coattention_fused`` forward and backward at the attention
    model's shape (b32, S 196, L = the vocab's max_seq_length, D 512), bf16
    and f32. Then each against its plain version (D within
    ``conv3x3_f_bound``, E within ``coattention_bound``; E's gradients
    against autograd through ``coattention_reference`` for one cotangent)
    and timed as kernel_phase times A-C. Returns ({image: {(kernel, mode):
    row}}, {kernel: launches on the paths})."""
    import torch
    from vqa_tpu_torch import _build
    from vqa_tpu_torch.ops import coattention_kernel as ck
    from vqa_tpu_torch.ops import conv_hpack, library

    g = torch.Generator().manual_seed(13)
    dts = {"bf16": torch.bfloat16, "f32": torch.float32}
    convs = {}
    for image in (IMAGE, IMAGE_224):
        for label, dt in dts.items():
            x = (torch.relu(torch.randn((BATCH, image // 2, image // 2, 64), generator=g))
                 * 1.5).to(dev, dt)
            w = (torch.randn((3, 3, 64, 128), generator=g) * 0.05).to(dev, dt)
            convs[(image, label)] = (x, w, (torch.randn(128, generator=g) * 0.1).to(dev))
    s, d, lim = (IMAGE // 32) ** 2, 512, 512 ** -0.5
    base = [((torch.rand(sh, generator=g) * 2 - 1) * lim).to(dev)
            for sh in ((d, d), (d,), (d, d), (d,), (d, 1), (1,), (d, 1), (1,))]
    v32 = (torch.relu(torch.randn((BATCH, s, d), generator=g)) * 2).to(dev)
    q32 = torch.randn((BATCH, 3, seq_len, d), generator=g).to(dev)
    cot = torch.randn((2, BATCH, 3, d), generator=g).to(dev)
    attn = {label: (v32.to(dt), q32.to(dt), [p.to(dt) for p in base]) for label, dt in dts.items()}

    def stacked(img, ques):
        return torch.stack([torch.stack(img, 1), torch.stack(ques, 1)])

    # the paths
    t0 = time.perf_counter()
    _build.reset_counts()
    for x, w, b in convs.values():
        conv_hpack.conv_bn_relu_pool(x, w, b)
    fused_grads = {}
    for label, (v, q, params) in attn.items():
        leaves = [t.clone().requires_grad_() for t in (v, q, *params)]
        stacked(*ck.coattention_fused(leaves[2:], leaves[0], list(leaves[1].unbind(1)))).backward(
            cot.to(v.dtype))
        fused_grads[label] = [t.grad for t in leaves]
    torch.cuda.synchronize()
    launches = {k.symbol: k.launches for k in _build.KERNELS}
    plain = {k.symbol: k.plain_on_cuda for k in _build.KERNELS}
    print(f"launches path=conv_bn_relu_pool_float_and_coattention_fused: {json.dumps(launches)} "
          f"({time.perf_counter() - t0:.2f} s)", flush=True)
    if launches != {"conv0_s2d_i8": 0, "conv3x3_i8": 0, "conv0_f": 0, "conv3x3_f": len(convs),
                    "coattention_fwd": len(attn), "mma_rate": 0} or any(plain.values()):
        raise AssertionError(f"the float pooled conv and co-attention paths: launches "
                             f"{launches}, plain versions on CUDA tensors {plain}")

    rows = {IMAGE: KernelRows(), IMAGE_224: KernelRows()}

    def timings(k, p, launch, direct):
        ms, pms = timed_pair(k, p)
        lms = timed(launch)
        disp = dispatch_pair(k, direct)
        return ms, lms, pms, disp

    # kernel D; the library yardstick is cuDNN's conv alone (cudnn_conv_ms)
    for (image, label), (x, w, b) in convs.items():
        tag = f"{image}² b{BATCH} {label}"
        k = lambda: conv_hpack.conv_bn_relu_pool(x, w, b)            # noqa: E731
        p = lambda: conv_hpack.conv3x3_f_plain(x, w, b)             # noqa: E731
        ref = p()
        rows[image].check("conv3x3_f", label, tag, k(), ref, conv_hpack.conv3x3_f_bound(x, w, ref))
        del ref
        wp, b32 = conv_hpack.conv3x3_f_operands(x, w, b)
        ms, lms, pms, disp = timings(
            k, p, lambda: conv_hpack.launch_conv3x3_f(x, wp, b32),  # noqa: B023
            lambda: library.CUDA_IMPLS["conv3x3_f"](x, w, b))       # noqa: B023
        cms = cudnn_conv_ms(x, w)
        out = k()
        bsz, h, wd, c = x.shape
        moved, macs = nbytes(x, w, b32, out), bsz * h * wd * 9 * c * w.shape[-1]
        if label == "bf16":
            bms, by = bound(moved, 2.0 * macs, BF16_FLOPS)
            cc = ""
        else:
            bms, by = bound(moved, 3 * 2.0 * macs, TF32_FLOPS)
            cc_ms, cc_by = bound(moved, 2.0 * macs, F32_FLOPS)
            cc = f"; CUDA-core f32 bound {cc_ms:.4f} ms ({cc_by})"
        del out
        prof = device_ms_by_kernel(lambda: conv_hpack.launch_conv3x3_f(x, wp, b32),  # noqa: B023
                                   ["conv3x3_f_kernel"])
        print(profile_line(f"conv3x3_f {tag}", prof), flush=True)
        rows[image].record("conv3x3_f", label, ms, lms, pms, bms, by, cms, disp)
        print(f"time conv3x3_f {tag}: wrapper {ms:.4f} ms, launch {lms:.4f} ms "
              f"({2.0 * macs / (lms * 1e-3) / 1e12:.1f} TFLOP/s), plain {pms:.4f} ms, F.conv2d "
              f"(conv only) {cms:.4f} ms, bound {bms:.4f} ms ({by}, {100 * bms / ms:.1f}% of "
              f"bound, {100 * bms / lms:.1f}% at launch){cc}; {dispatch_line(disp)} ({card})",
              flush=True)
    del convs

    # kernel E: forward vs the plain version, the gradients of the path's
    # backward vs autograd through the reference; no single PyTorch call
    # computes this function (library_ms null)
    for label, (v, q, params) in attn.items():
        tag = f"b{BATCH} S{s} L{seq_len} D{d} {label}"
        kp = [params[i] for i in (0, 1, 2, 3, 4, 6)]                 # no c_v, c_q
        k = lambda: ck.coattention_fwd(v, q, *kp)                   # noqa: E731
        p = lambda: ck.coattention_plain(v, q, *kp)                 # noqa: E731
        ref = p()
        for name, o, r, tol in zip(("out_v", "out_q"), k(), ref, ck.coattention_bound(v, q, *ref)):
            rows[IMAGE].check("coattention_fwd", label, f"{tag} {name}", o, r, tol)
        leaves = [t.clone().requires_grad_() for t in (v, q, *params)]
        stacked(*ck.coattention_reference(leaves[2:], leaves[0],
                                          list(leaves[1].unbind(1)))).backward(cot.to(v.dtype))
        gerr = max(((a.float() - t.grad.float()).abs().max() / t.grad.float().abs().max().clamp_min(
            1e-30)).item() for a, t in zip(fused_grads[label], leaves))
        print(f"kernel coattention_fwd {tag} backward: gradients of V, Q and the 8 parameters "
              f"vs autograd through coattention_reference, max |diff| / max |grad| {gerr}",
              flush=True)
        if not gerr <= 1e-6:
            raise AssertionError(f"coattention_fused {tag}: gradients differ from the "
                                 f"reference's autograd")
        ops_k = ck.coattention_kernel_operands(v, *kp)
        ms, lms, pms, disp = timings(
            k, p, lambda: ck.launch_coattention_fwd(v, q, *ops_k),  # noqa: B023
            lambda: library.CUDA_IMPLS["coattention_fwd"](v, q, *kp))  # noqa: B023
        bsz, l = v.shape[0], q.shape[2]
        # operations on input-type operands (the projections and Q V^T) and on
        # f32 intermediates (H_v, H_q, the scores and the pooled sums); f32
        # ones count as 3 TF32 operations (3xTF32), put in bf16-peak units
        in_ops = 2.0 * (bsz * s + 3 * bsz * l) * d * d + 2.0 * bsz * 3 * l * s * d
        f32_ops = 2.0 * bsz * 3 * (2 * l * s * d + 2 * (s + l) * d)
        if label == "bf16":
            ops = in_ops + f32_ops * 3 * BF16_FLOPS / TF32_FLOPS
        else:
            ops = (in_ops + f32_ops) * 3 * BF16_FLOPS / TF32_FLOPS
        outs = k()
        prof = device_ms_by_kernel(lambda: ck.launch_coattention_fwd(v, q, *ops_k),  # noqa: B023
                                   ["coatt_gemm_kernel", "coatt_slice_kernel",
                                    "coatt_pool_kernel"])
        print(profile_line(f"coattention_fwd {tag}", prof), flush=True)
        bms, by = bound(nbytes(v, q, *ops_k, *outs), ops, BF16_FLOPS)
        rows[IMAGE].record("coattention_fwd", label, ms, lms, pms, bms, by, None, disp)
        print(f"time coattention_fwd {tag}: wrapper {ms:.4f} ms, launch {lms:.4f} ms, plain "
              f"{pms:.4f} ms, library call: none, bound {bms:.4f} ms ({by}, "
              f"{(in_ops + f32_ops) / 1e9:.3f} GFLOP, {nbytes(v, q, *ops_k, *outs) / 1e6:.2f} MB; "
              f"{100 * bms / ms:.1f}% of bound, {100 * bms / lms:.1f}% at launch); "
              f"{dispatch_line(disp)} ({card})", flush=True)
    return ({image: kr.rows for image, kr in rows.items()},
            {"conv3x3_f": launches["conv3x3_f"], "coattention_fwd": launches["coattention_fwd"]})


def probes_phase(dev, card: str):
    """The port's timing probes (``vqa_tpu_torch.tools``, rows 6a-6k of
    PERF.md's table of TPU kernels) at their default shapes and b160: each
    variant checked against its plain version, then timed (``_probe.run``:
    the kernel's counts zeroed just before its timed calls and read just
    after, and held to the number of calls). Returns the rows, and the
    kernels' launches summed over the timed calls."""
    import importlib

    import torch
    from vqa_tpu_torch.tools import PROBES, _probe

    t0 = time.perf_counter()
    rows, launches = [], {}
    for name in PROBES:
        mod = importlib.import_module(f"vqa_tpu_torch.tools.{name}")
        got = _probe.run(mod.variants(dev, PROBE_BATCH), PROBE_STEPS, card)
        if name == "exp_r5_mosaic_dot":
            mod.run_rates(got)
        for r in got:
            launches[r["kernel"]] = launches.get(r["kernel"], 0) + r["launches"]
            plain = "not timed" if r["plain_ms"] is None else f"{r['plain_ms']:.4f} ms"
            at = "" if r["library_slice_ms"] is None else \
                f" (its first b{r['library_slice_batch']} slice {r['library_slice_ms']:.4f} ms)"
            print(f"probe {r['row']} {name} {r['variant']} ({r['kernel']}, {r['mode']}; "
                  f"{r['shape']}): wrapper {r['ms']:.4f} ms, launch {r['launch_ms']:.4f} ms "
                  f"({100 * r['share_of_bound']:.1f}% of its bound {r['bound_ms']:.4f} ms, "
                  f"{r['bound_by']}), {r['library']} {r['library_ms']:.4f} ms{at}, plain "
                  f"{plain}; max_abs_err {r['max_abs_err']} ({card})", flush=True)
        rows += got
        torch.cuda.empty_cache()
    print(f"launches path=probes: {json.dumps(launches)}", flush=True)
    print(f"probes phase: {time.perf_counter() - t0:.2f} s ({card})", flush=True)
    return rows, launches


MOE_BATCH, MOE_QUESTION = 160, 23      # the kimi_vl.train.b160 cell: T = 196 + 23


def moe_phase(card: str) -> dict:
    """The ``kimi_vl`` head's grouped expert products (``ops.moe_gmm``:
    ``torch._grouped_mm``, the library's grouped GEMM, in bf16) at the
    training cell's shapes. First the path: the model at the registry's
    sizes (5 layers, 32 of 64 experts held) takes one training step of
    ``make_train_step(image_is_features=True)`` on random b160 tower
    features and full-length questions, with ``moe_gmm.LAUNCHES`` zeroed
    just before and read just after: 3 launches a product a layer (4 expert
    layers, 2 products: 24). The first expert layer's operands of that step
    (its rows, weights and plan, from its own router) are kept; each
    product's forward and both gradients are held row by row (within
    MOE_ROW_TOL of each row's norm: a wrong tile of 128 columns moves its
    rows by a fifth) against the plain version (one float32 ``torch.mm`` an
    expert) on the same bf16 operands; then timed (CUDA events): forward,
    and forward plus backward, beside the plain version in bf16 (one
    launch an expert) and the bound (bf16 operations at 989 TFLOP/s or
    bytes at 3.35 TB/s). Returns the ``kernels`` line's row."""
    import torch
    from vqa_tpu_torch.config import build_model
    from vqa_tpu_torch.ops import moe_gmm
    from vqa_tpu_torch.train.state import create_train_state
    from vqa_tpu_torch.train.steps import make_train_step

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(7)
    model, _ = build_model("kimi_vl", VOCAB_WORDS, ANSWERS + 1, device=dev, opt_lvl=1,
                           generator=torch.Generator().manual_seed(7))
    state = create_train_state(model, 1e-4)
    step = make_train_step(image_is_features=True)
    s = (IMAGE // 32) ** 2
    batch = {"image": torch.randn((MOE_BATCH, s, 512), generator=g, device=dev).relu(),
             "question": torch.randint(1, VOCAB_WORDS, (MOE_BATCH, MOE_QUESTION), generator=g,
                                       device=dev),
             "ques_len": torch.full((MOE_BATCH,), MOE_QUESTION, device=dev),
             "label": torch.randint(0, ANSWERS + 1, (MOE_BATCH,), generator=g, device=dev)}
    kept = []
    grouped = moe_gmm.grouped_mm

    def keep(x, w, p):
        if len(kept) < 2:
            kept.append((x.detach(), w.detach(), p))
        return grouped(x, w, p)

    moe_gmm.grouped_mm = keep
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        moe_gmm.LAUNCHES = 0
        out = step(state, batch)
        float(out["loss"])
        launches = moe_gmm.LAUNCHES
    finally:
        moe_gmm.grouped_mm = grouped
    layers = len(model.moe_layers())
    print(f"launches path=kimi_vl train step b{MOE_BATCH}: grouped_mm {launches} "
          f"({time.perf_counter() - t0:.2f} s; {layers} expert layers)", flush=True)
    if launches != 6 * layers:
        raise AssertionError(f"kimi_vl's train step: {launches} grouped-GEMM launches, "
                             f"want {6 * layers} (3 a product a layer)")
    del state, step, out
    torch.cuda.empty_cache()

    row = {"name": "grouped_mm", "route": "library", "source": "vqa_tpu_torch/ops/moe_gmm.py",
           "replaces": None, "launches": launches, "max_row_err": 0.0, "ms": 0.0,
           "fwd_ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "bound_by": "operations"}
    for label, (x, w, p) in zip(("gate_up", "down"), kept):
        wc = w.bfloat16()
        xf, wf = x.float(), wc.float()
        x = x.clone().requires_grad_()
        wp = w.clone().requires_grad_()
        y = moe_gmm.grouped_mm(x, wp, p)
        gy = torch.randn(y.shape, generator=g, device=dev).bfloat16()
        y.backward(gy)
        errs = {"y": _worst_row(y, moe_gmm._rows(xf, wf, p, transposed=True)),
                "dx": _worst_row(x.grad, moe_gmm._rows(gy.float(), wf, p, transposed=False)),
                "dw": _worst_row(wp.grad, moe_gmm._wgrad(gy.float(), xf, p))}
        held = [int(c) for c in p.counts.tolist()]
        print(f"grouped_mm {label}: rows {p.rows} of {sum(held)} pairs held "
              f"({p.rows / sum(held):.4f}), busiest held expert {max(held[:-1])} rows "
              f"(mean {p.rows / (len(held) - 1):.1f}); worst row error {json.dumps(errs)}",
              flush=True)
        if max(errs.values()) > MOE_ROW_TOL:
            raise AssertionError(f"grouped_mm {label}: rows off the plain version: {errs}")
        row["max_row_err"] = max(row["max_row_err"], *errs.values())
        x = x.detach().requires_grad_()

        def fwd():
            return moe_gmm.grouped_mm(x, wp, p)

        def fwd_bwd():
            fwd().backward(gy)

        def plain():
            for e in range(len(p.bounds) - 1):
                a, b = p.bounds[e], p.bounds[e + 1]
                x[a:b].detach() @ wc[e].t()

        fwd_bwd()
        fms, ms, pms = cuda_ms(fwd, 10), cuda_ms(fwd_bwd, 10), cuda_ms(plain, 3)
        n, k = wc.shape[1], wc.shape[2]
        ops = 3 * 2.0 * p.rows * n * k
        moved = 3 * nbytes(x, wc, y) + nbytes(wp)      # three passes; dw stored in f32
        bms, by = bound(moved, ops, BF16_FLOPS)
        print(f"grouped_mm {label} ({card}): forward {fms:.4f} ms, forward + backward "
              f"{ms:.4f} ms, bound {bms:.4f} ms ({by}; {100 * bms / ms:.1f}%), plain forward "
              f"(an expert a launch) {pms:.4f} ms", flush=True)
        row["ms"] += ms
        row["fwd_ms"] += fms
        row["plain_ms"] += pms
        row["bound_ms"] += bms
        row["bound_by"] = by
        del x, wp, y, gy
    del model, kept
    torch.cuda.empty_cache()
    return row


def _worst_row(a, b) -> float:
    """The largest relative distance of a row of ``a`` from ``b``'s."""
    a, b = a.detach().double().flatten(0, -2), b.double().flatten(0, -2)
    return float(((a - b).norm(dim=-1) / b.norm(dim=-1).clamp_min(1e-30)).max())


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


def read_pairs(pairs):
    """The request file's image paths (under WORK, as ``serve --img_dir``
    joins them) and questions."""
    with open(pairs) as f:
        rows = [ln.split("\t") for ln in f.read().splitlines() if ln.strip()]
    return [os.path.join(WORK, r[0]) for r in rows], [r[1] for r in rows]


def exported_serve(art, vocab_file, pairs, out, device="cuda") -> int:
    """The export phase's fresh process: load the artifact with
    ``ExportedPredictor`` on ``device``, check that no model module (nor JAX)
    was imported, serve the requests twice (the first pass is held to the
    live predictor and counted; the second, warm, is timed and must repeat
    the first bit for bit), write the probabilities to ``out``.npy and the
    launches, load and batch seconds to ``out``.json."""
    import numpy as np
    from vqa_tpu_torch import _build
    from vqa_tpu_torch.export import ExportedPredictor
    from vqa_tpu_torch.vocab import Vocab

    t0 = time.perf_counter()
    predictor = ExportedPredictor(art, Vocab.load(vocab_file), vocab_path=vocab_file,
                                  synthetic_images=True, device=device)
    load_s = time.perf_counter() - t0
    bad = sorted(m for m in sys.modules if m.startswith("vqa_tpu_torch.models")
                 or m.split(".")[0] in ("jax", "jaxlib", "flax", "vqa_tpu"))
    if bad:
        raise AssertionError(f"the artifact's server imported {bad}")
    paths, questions = read_pairs(pairs)
    _build.reset_counts()
    probs = predictor.predict_probs(paths, questions)
    launches, plain = counts()
    first_s, predictor.batch_seconds = predictor.batch_seconds, []
    if not np.array_equal(predictor.predict_probs(paths, questions), probs):
        raise AssertionError("the artifact's second pass differs from its first")
    np.save(f"{out}.npy", probs)
    with open(f"{out}.json", "w") as f:
        json.dump({"launches": launches, "plain_on_cuda": plain, "load_seconds": load_s,
                   "first_batch_seconds": first_s, "batch_seconds": predictor.batch_seconds,
                   "library_loaded": "vqa_tpu_torch.ops.library" in sys.modules}, f)
    return 0


def export_phase(predictor, vocab_file, pairs, expect: dict, card: str,
                 device="cuda") -> dict:
    """Export the live ``predictor`` (calibrated when int8), serve the
    requests from the artifact in a fresh process, and hold its
    probabilities to the live predictor's bit for bit and its launches to
    ``expect`` ({kernel: launches for the requests}). Export itself launches
    nothing. Returns {path: launches}."""
    import shutil

    import numpy as np
    from vqa_tpu_torch import _build
    from vqa_tpu_torch.export import export_predictor

    tag = f"export {predictor.model_name} b{BATCH}@{predictor.image_size}²"
    paths, questions = read_pairs(pairs)
    _build.reset_counts()
    live = predictor.predict_probs(paths, questions)
    live_launches, plain = counts()
    predictor.batch_seconds = []         # a second, warm pass is timed
    if not np.array_equal(predictor.predict_probs(paths, questions), live):
        raise AssertionError(f"{tag}: the live predictor's second pass differs")
    live_s = predictor.batch_seconds
    art = os.path.join(WORK, f"export_{predictor.model_name}")
    shutil.rmtree(art, ignore_errors=True)
    _build.reset_counts()
    t0 = time.perf_counter()
    manifest = export_predictor(predictor, art, vocab_path=vocab_file)
    export_s = time.perf_counter() - t0
    export_launches, _ = counts()
    mb = manifest["artifact_bytes"] / 1e6
    print(f"{tag}: exported in {export_s:.2f} s, {mb:.2f} MB, platforms "
          f"{manifest['platforms']}, operators in the program {manifest['kernels']}, "
          f"launches while exporting {json.dumps(export_launches)}", flush=True)
    out = os.path.join(WORK, f"exported_{predictor.model_name}")
    child = subprocess.run(
        [sys.executable, "-c", "import sys, chip_smoke; sys.exit(chip_smoke.exported_serve("
         f"{art!r}, {vocab_file!r}, {pairs!r}, {out!r}, {device!r}))"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    if child.returncode != 0:
        print(child.stdout[-4000:], child.stderr[-8000:], flush=True)
        raise AssertionError(f"{tag}: the fresh process serving the artifact exited "
                             f"{child.returncode}")
    got = np.load(f"{out}.npy")
    with open(f"{out}.json") as f:
        res = json.load(f)
    equal = got.shape == live.shape and np.array_equal(got, live)
    aot_s = res["batch_seconds"]
    print(f"{tag}: a fresh process loaded the artifact in {res['load_seconds']:.2f} s (operator "
          f"library loaded {res['library_loaded']}, no model module), answered {len(got)} "
          f"requests, probabilities {got.shape} bit-equal to the live predictor's {equal} (max "
          f"diff {np.abs(got - live).max() if got.shape == live.shape else 'shape'}); "
          f"second pass, batches 2-3: exported {2 * BATCH / sum(aot_s[1:3]):.2f} QA/s, live "
          f"{2 * BATCH / sum(live_s[1:3]):.2f} QA/s ({card}); batch seconds exported "
          f"{[round(t, 4) for t in aot_s]} (first pass "
          f"{[round(t, 4) for t in res['first_batch_seconds']]}), live "
          f"{[round(t, 4) for t in live_s]}", flush=True)
    print(f"launches path=exported model={predictor.model_name}: "
          f"{json.dumps(res['launches'])}", flush=True)
    want = {k.symbol: expect.get(k.symbol, 0) for k in _build.KERNELS}
    if not equal:
        raise AssertionError(f"{tag}: the artifact's probabilities differ from the live ones")
    if any(export_launches.values()) or res["launches"] != want or live_launches != want \
            or any(res["plain_on_cuda"].values()) or any(plain.values()):
        raise AssertionError(f"{tag}: launches exported {res['launches']}, live "
                             f"{live_launches}, while exporting {export_launches}; expected "
                             f"{want} and none while exporting")
    shutil.rmtree(art)
    return {f"export {predictor.model_name}": export_launches,
            f"exported {predictor.model_name}": res["launches"]}


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

    def initial_state(model):
        """The model's weights as ``main`` initializes them (``--seed 0``)."""
        from vqa_tpu_torch.config import build_model
        from vqa_tpu_torch.vocab import Vocab
        init, _ = build_model(model, Vocab.load(vocab_file).size, ANSWERS + 1, device="cpu",
                              max_seq_length=SEQ_LEN, generator=torch.Generator().manual_seed(0))
        return init.state_dict()

    def vgg_train_route(model):
        from vqa_tpu_torch.train.checkpoint import load_params_only
        flags = ("--vgg_train", "true", "--opt_lvl", "1")
        torch.cuda.reset_peak_memory_stats()
        full, launches = run(model, "train vgg_train", "train", "vgg", *flags)
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        losses = full["losses"]
        print(f"train {model} --vgg_train true: {full['steps']} steps, losses {losses}, "
              f"eval batches {full['eval_batches']}", flush=True)
        finite = all(v == v and abs(v) != float("inf") for v in losses)
        if full["steps"] != N_TRAIN // BATCH or not finite:
            raise AssertionError(f"the {model} --vgg_train run did not train 6 finite steps")
        if any(launches.values()):
            raise AssertionError(f"the {model} --vgg_train run launched a kernel: {launches}")
        sync = dict(full["sync_points"])
        steady = sync[6] - sync[2]
        print(f"train {model} --vgg_train true ({card}): steps 3-6 {4 * BATCH / steady:.2f} "
              f"QA/s, {1e3 * steady / 4:.2f} ms per step of {BATCH} (host clock, validation "
              f"and checkpoint time taken out); peak device memory {peak_gib:.2f} GiB "
              f"(max_memory_allocated)", flush=True)
        key = "image_encoder.vgg11_encoder.0.weight"
        moved = (load_params_only(os.path.join(full["log_dir"], "model_6.ckpt"))[key]
                 - initial_state(model)[key]).abs().max().item()
        print(f"train {model} --vgg_train true: {key} moved by up to {moved}", flush=True)
        if not moved > 0:
            raise AssertionError("the VGG did not train")

        resumed, launches = run(model, "train vgg_train resume", "train", "vgg_resumed", *flags,
                                "--model_ckpt", os.path.join(full["log_dir"], "model_3.ckpt"))
        rel = max(abs(a - b) / abs(b) for a, b in zip(resumed["losses"], losses[3:]))
        print(f"train {model} --vgg_train resume from step 3: losses {resumed['losses']} vs "
              f"{losses[3:]}, max relative difference {rel} (tolerance {VGG_RESUME_RTOL})",
              flush=True)
        if resumed["first_step"] != 3 or resumed["steps"] != 3 or not rel <= VGG_RESUME_RTOL \
                or any(launches.values()):
            raise AssertionError(f"the resumed {model} --vgg_train run does not repeat steps 4-6")

        res, launches = run(model, "test vgg_train", "test", "vgg", *flags, "--model_ckpt",
                            os.path.join(full["log_dir"], "model_6.ckpt"))
        print(f"test mode {model} --vgg_train true: {res}", flush=True)
        if res["samples"] != N_VAL or not res["loss"] == res["loss"] or any(launches.values()):
            raise AssertionError(f"{model} --vgg_train test mode failed")
        shutil.rmtree(full["log_dir"])
        shutil.rmtree(resumed["log_dir"])

    def batch_stats_route(model):
        from vqa_tpu_torch.train.checkpoint import load_params_only
        out, launches = run(model, "train bn_batch", "train", "bn_batch", "--bn_mode", "batch",
                            "--opt_lvl", "1", "--int8_calib", "1", "--profile_steps", "2")
        # train steps take batch statistics (no int8 stage, no kernel); the
        # calibration batch and the eval batches run the running-stats tower
        forwards = 1 + out["eval_batches"]
        print(f"train {model} --bn_mode batch: {out['steps']} steps, {out['eval_batches']} eval "
              f"batches, 1 calibration batch, losses {out['losses']}", flush=True)
        finite = all(v == v and abs(v) != float("inf") for v in out["losses"])
        if out["steps"] != N_TRAIN // BATCH or not finite:
            raise AssertionError(f"the {model} --bn_mode batch run did not train 6 finite steps")
        sync = dict(out["sync_points"])
        print(f"train {model} --bn_mode batch ({card}): steps 3-6 "
              f"{4 * BATCH / (sync[6] - sync[2]):.2f} QA/s (host clock; the trace window "
              f"included)", flush=True)
        if launches["conv0_s2d_i8"] != forwards or launches["conv3x3_i8"] != 7 * forwards \
                or launches["conv0_f"]:
            raise AssertionError(f"{model} --bn_mode batch: kernels A and B did not run once "
                                 f"and 7 times per calibration and eval forward only")
        trained = load_params_only(os.path.join(out["log_dir"], "model_6.ckpt"))
        init = initial_state(model)
        vgg = [k for k in init if k.startswith("image_encoder.vgg11_encoder.")]
        stats = [k for k in vgg if k.endswith(("running_mean", "running_var"))]
        moved = [k for k in vgg if not torch.equal(trained[k], init[k])]
        print(f"train {model} --bn_mode batch: {len(moved)} of {len(vgg)} VGG tensors moved, "
              f"the {len(stats)} running stats among them: {sorted(moved) == sorted(stats)}",
              flush=True)
        if sorted(moved) != sorted(stats):
            raise AssertionError("--bn_mode batch: the running stats did not move alone")
        traces = [f for f in os.listdir(out["log_dir"]) if f.endswith(".pt.trace.json")]
        sizes = [os.path.getsize(os.path.join(out["log_dir"], f)) for f in traces]
        print(f"train {model} --profile_steps 2: traces {dict(zip(traces, sizes))}", flush=True)
        if len(traces) != 1 or not sizes[0] > 0:
            raise AssertionError("--profile_steps wrote no trace")
        shutil.rmtree(out["log_dir"])

    def grad_accum_route(model):
        out, launches = run(model, "train grad_accum", "train", "accum", "--opt_lvl", "1",
                            "--int8_calib", "1", "--grad_accum", "2", train_file=train_int8)
        # one VGG forward per calibration batch, microbatch and eval batch
        forwards = 1 + 2 * out["steps"] + out["eval_batches"]
        print(f"train {model} --grad_accum 2: {out['steps']} steps, {out['eval_batches']} eval "
              f"batches, losses {out['losses']}", flush=True)
        finite = all(v == v and abs(v) != float("inf") for v in out["losses"])
        if out["steps"] != 2 or not finite:
            raise AssertionError(f"the {model} --grad_accum run did not train 2 finite steps")
        if launches["conv0_s2d_i8"] != forwards or launches["conv3x3_i8"] != 7 * forwards \
                or launches["conv0_f"]:
            raise AssertionError(f"{model} --grad_accum 2: kernels A and B did not run once and "
                                 f"7 times per forward")
        shutil.rmtree(out["log_dir"])

    float_route("attention", ("--opt_lvl", "1", "--int8_backbone", "false"), "bf16")
    int8_route("attention")
    float_route("baseline", ("--opt_lvl", "0"), "f32, --opt_lvl 0")
    int8_route("bert")
    vgg_train_route("attention")
    batch_stats_route("baseline")
    grad_accum_route("attention")
    return path_launches


def etl_phase(card: str) -> dict:
    """Synthetic VQA-v2 JSON -> ``python -m vqa_tpu_torch.prepare_data`` for
    train (with the vocab) and val, then one JPEG per image of the ETL's
    files. Returns the files, image directories and image paths."""
    import numpy as np
    from PIL import Image

    etl = os.path.join(WORK, "etl")
    os.makedirs(etl, exist_ok=True)
    rng = np.random.default_rng(5)
    ids = rng.choice(581_000, N_CACHE_TRAIN_IMAGES + N_CACHE_VAL_IMAGES, replace=False) + 1
    words = ["what", "is", "the", "color", "of", "how", "many", "are", "there", "on",
             "in", "this", "a", "man", "woman", "dog", "cat", "table", "car", "sky"]
    words += [f"thing{i}" for i in range(200)]
    answers = ["yes", "no", "2", "red", "blue", "white"] + [f"ans{i}" for i in range(60)]
    out = {"dirs": {}, "files": {}, "images": []}
    t0 = time.perf_counter()
    for split, img_ids in (("train", ids[:N_CACHE_TRAIN_IMAGES]),
                           ("val", ids[N_CACHE_TRAIN_IMAGES:])):
        anns, ques = [], []
        for img in img_ids:
            for _ in range(QUESTIONS_PER_IMAGE):
                qid = len(anns) + 1
                n = int(rng.integers(4, 12))
                question = " ".join(words[int(j)] for j in rng.integers(0, len(words), n)) + "?"
                ans = answers[int(rng.integers(len(answers)))]
                anns.append({"image_id": int(img), "question_id": qid, "question_type": "what",
                             "answer_type": "other", "multiple_choice_answer": ans,
                             "answers": [{"answer": ans, "answer_id": 1}]})
                ques.append({"image_id": int(img), "question_id": qid, "question": question})
        a, q = os.path.join(etl, f"ann_{split}.json"), os.path.join(etl, f"ques_{split}.json")
        with open(a, "w") as f:
            json.dump({"info": {"version": "2.0"}, "annotations": anns}, f)
        with open(q, "w") as f:
            json.dump({"info": {"version": "2.0"}, "questions": ques}, f)
        txt = os.path.join(etl, f"{split}.txt")
        cmd = [sys.executable, "-m", "vqa_tpu_torch.prepare_data", "--balanced_real_images",
               "-s", split, "-a", a, "-q", q, "-o", txt]
        if split == "train":
            cmd += ["-v", os.path.join(etl, "vocab.pkl"), "-c", "1", "-K", str(ANSWERS)]
        subprocess.run(cmd, cwd=ROOT, check=True, capture_output=True, text=True, timeout=300,
                       env={**os.environ, "PYTHONPATH": ROOT})
        with open(txt) as f:
            lines = f.read().splitlines()
        names = sorted({ln.split("\t")[0] for ln in lines})
        want = sorted(f"COCO_{split}2014_{int(i):012d}.jpg" for i in img_ids)
        if len(lines) != QUESTIONS_PER_IMAGE * len(img_ids) or names != want:
            raise AssertionError(f"prepare_data -s {split}: {len(lines)} lines, image names "
                                 f"{names[:2]}... do not match the annotations")
        img_dir = os.path.join(etl, f"{split}2014")
        os.makedirs(img_dir, exist_ok=True)
        for name in names:
            g = np.linspace(0, 255, JPEG_W, dtype=np.uint8)
            img = np.stack([np.tile(g, (JPEG_H, 1))] * 3, axis=-1).astype(int)
            img = np.clip(img + rng.integers(-20, 20, img.shape), 0, 255).astype(np.uint8)
            Image.fromarray(img).save(os.path.join(img_dir, name), quality=JPEG_QUALITY)
            out["images"].append(os.path.join(img_dir, name))
        out["dirs"][split], out["files"][split] = img_dir, txt
    with open(os.path.join(etl, "vocab.pkl"), "rb") as f:
        vocab = pickle.load(f)
    out["vocab"] = os.path.join(etl, "vocab.pkl")
    print(f"etl: prepare_data wrote {QUESTIONS_PER_IMAGE * N_CACHE_TRAIN_IMAGES} train and "
          f"{QUESTIONS_PER_IMAGE * N_CACHE_VAL_IMAGES} val lines, vocab of "
          f"{len(vocab['word2idx'])} words and {len(vocab['label2idx'])} labels, "
          f"max_seq_length {vocab['max_seq_length']}; {len(out['images'])} JPEGs "
          f"{JPEG_W}x{JPEG_H} q{JPEG_QUALITY} in {time.perf_counter() - t0:.2f} s ({card})",
          flush=True)
    return out


def native_decoder_buildable() -> tuple[bool, str]:
    """Whether libjpeg's headers are there for the native decoder's build
    (jpeglib.h needs <cstdio> before it, as the decoder's source has it)."""
    try:
        proc = subprocess.run(["g++", "-fsyntax-only", "-x", "c++", "-"],
                              input="#include <cstdio>\n#include <jpeglib.h>\n",
                              capture_output=True, text=True, timeout=60)
    except FileNotFoundError:
        return False, "no g++"
    if proc.returncode != 0:
        errors = [ln for ln in proc.stderr.splitlines() if "error" in ln]
        return False, (errors or ["g++ exited " + str(proc.returncode)])[0].strip()
    return True, ""


def decode_phase(paths: list, native: bool, card: str) -> None:
    """Each engine over the JPEGs at 448² and 224², after a warm-up batch
    (it builds the library and spawns the pool): images/s, and the native
    engines' bytes against each other and against PIL."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    from vqa_tpu_torch.data.images import decode_batch

    engines = ("pil", "native", "native_mp") if native else ("pil",)
    with ThreadPoolExecutor(DECODE_THREADS) as pool:
        for size in (IMAGE, IMAGE_224):
            outs, rates = {}, {}
            for engine in engines:
                def run(batch_paths):
                    return decode_batch(batch_paths, size, pool=pool, backend=engine,
                                        native_threads=DECODE_THREADS)
                run(paths[:BATCH])
                t0 = time.perf_counter()
                out = np.concatenate([run(paths[i:i + BATCH])
                                      for i in range(0, len(paths), BATCH)])
                rates[engine] = len(paths) / (time.perf_counter() - t0)
                if out.shape != (len(paths), size, size, 3) or out.dtype != np.uint8 \
                        or not out.any(axis=(1, 2, 3)).all():
                    raise AssertionError(f"decode {engine} {size}²: shape {out.shape}, "
                                         f"{out.dtype}, or an empty image")
                outs[engine] = out
            line = ", ".join(f"{e} {r:.1f} images/s" for e, r in rates.items())
            print(f"decode {len(paths)} JPEGs {JPEG_W}x{JPEG_H} -> {size}², "
                  f"{DECODE_THREADS} threads/processes, os.cpu_count() {os.cpu_count()}: "
                  f"{line} ({card})", flush=True)
            if native:
                from vqa_tpu_torch.native import decode_batch_native
                _, ok = decode_batch_native(paths, size, threads=DECODE_THREADS)
                mad = np.abs(outs["native"].astype(int) - outs["pil"].astype(int)).mean()
                same = np.array_equal(outs["native_mp"], outs["native"])
                print(f"decode {size}²: native status all ok {bool(ok.all())}, native_mp == "
                      f"native {same}, mean |native - pil| {mad:.4f} (bound "
                      f"{NATIVE_PIL_MEAN_ABS})", flush=True)
                if not (ok.all() and same and mad < NATIVE_PIL_MEAN_ABS):
                    raise AssertionError(f"decode {size}²: the native engines disagree")


def cache_phase(etl: dict, native: bool, card: str, device="cuda") -> dict:
    """Cached against uncached training on the ETL's files and JPEGs:
    attention at 448² on the int8 route (uncached, cached with a build,
    cached with reuse), baseline at 224² at ``--opt_lvl 0`` (uncached,
    cached). Returns {path: launches}, each read just after its own run."""
    import shutil

    import torch
    from vqa_tpu_torch import _build
    from vqa_tpu_torch.main import main as vqa_main
    from vqa_tpu_torch.models import layers

    runs = os.path.join(WORK, "cache_runs")
    cache_root = os.path.join(WORK, "feature_cache")
    shutil.rmtree(runs, ignore_errors=True)
    shutil.rmtree(cache_root, ignore_errors=True)
    path_launches = {}
    build_batches = -(-N_CACHE_TRAIN_IMAGES // BATCH) + -(-N_CACHE_VAL_IMAGES // BATCH)
    engine = "native_mp" if native else "pil"

    def run(model, path, run_name, *extra):
        """One ``main`` train run; its launches, QA/s over steps 3-6, peak memory."""
        torch.cuda.reset_peak_memory_stats()
        _build.reset_counts()
        out = vqa_main(["--mode", "train", "--model", model, "--expt_dir", runs,
                        "--expt_name", "cache", "--run_name", run_name,
                        "--train_img", etl["dirs"]["train"], "--train_file", etl["files"]["train"],
                        "--val_img", etl["dirs"]["val"], "--val_file", etl["files"]["val"],
                        "--vocab_file", etl["vocab"], "--batch_size", str(BATCH),
                        "--num_epochs", "1", "--num_cls", str(ANSWERS), "--log_interval", "2",
                        "--save_interval", "1000",
                        "--val_size", str(QUESTIONS_PER_IMAGE * N_CACHE_VAL_IMAGES),
                        "--num_workers", str(DECODE_THREADS), "--device", device, *extra])
        launches, plain = counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        path_launches[path] = launches
        sync = dict(out["sync_points"])
        qa_s = 4 * BATCH / (sync[6] - sync[2])
        finite = all(v == v and abs(v) != float("inf") for v in out["losses"])
        print(f"launches path={path.replace(' ', '_')}: {json.dumps(launches)}", flush=True)
        print(f"{path}: {out['steps']} steps, {out['eval_batches']} eval batches, decode "
              f"{out['decode_backend']}, steps 3-6 {qa_s:.2f} QA/s, peak device memory "
              f"{peak:.2f} GiB, losses {out['losses']} ({card})", flush=True)
        if any(plain.values()) or out["steps"] != QUESTIONS_PER_IMAGE * N_CACHE_TRAIN_IMAGES \
                // BATCH or not finite:
            raise AssertionError(f"{path}: plain convs on the card {plain}, or not 6 finite "
                                 f"steps")
        shutil.rmtree(out["log_dir"])
        return out, launches

    def caches(out, built: bool):
        for c in out["feature_caches"]:
            mb = os.path.getsize(os.path.join(c.cache_dir, "features.bin")) / 1e6
            n = len(c.meta["names"])
            rate = f"{c.build_seconds:.2f} s, {n / c.build_seconds:.1f} images/s" \
                if c.build_seconds is not None else "reused"
            print(f"  cache {os.path.basename(c.cache_dir)}: {n} images, {c.meta['dtype']} "
                  f"{c.feature_shape}, {mb:.2f} MB, {rate} ({card})", flush=True)
        if len(out["feature_caches"]) != 2 or \
                any((c.build_seconds is not None) != built for c in out["feature_caches"]):
            raise AssertionError(f"expected both caches {'built' if built else 'reused'}")

    def same_losses(tag, cached, ref):
        diff = max(abs(a - b) / abs(b) for a, b in zip(cached["losses"], ref["losses"]))
        print(f"{tag}: cached vs uncached losses bit-equal "
              f"{cached['losses'] == ref['losses']}, max relative difference {diff} "
              f"(tolerance {RESUME_RTOL})", flush=True)
        if not diff <= RESUME_RTOL:
            raise AssertionError(f"{tag}: the cached losses differ from the uncached ones")

    # attention, 448², int8 route: one calibration batch
    flags = ("--opt_lvl", "1", "--int8_calib", "1")
    ref, launches = run("attention", "cache attention uncached", "att_uncached", *flags)
    forwards = 1 + ref["steps"] + ref["eval_batches"]
    if ref["decode_backend"] != engine or launches["conv0_s2d_i8"] != forwards \
            or launches["conv3x3_i8"] != 7 * forwards or launches["conv0_f"]:
        raise AssertionError(f"uncached attention: decode {ref['decode_backend']} (expected "
                             f"{engine}), or not A once and B 7 times a forward: {launches}")
    cached_flags = (*flags, "--cache_features", "true", "--cache_dir", cache_root)
    built, launches = run("attention", "cache attention build", "att_build", *cached_flags)
    caches(built, built=True)
    if launches["conv0_s2d_i8"] != 1 + build_batches \
            or launches["conv3x3_i8"] != 7 * (1 + build_batches) or launches["conv0_f"]:
        raise AssertionError(f"cached attention: A and B not exactly once and 7 times per "
                             f"calibration and build batch: {launches}")
    same_losses("cache attention 448² int8", built, ref)
    reused, launches = run("attention", "cache attention reuse", "att_reuse", *cached_flags)
    caches(reused, built=False)
    if launches["conv0_s2d_i8"] != 1 or launches["conv3x3_i8"] != 7 or launches["conv0_f"]:
        raise AssertionError(f"reused attention cache: A and B beyond the calibration "
                             f"batch: {launches}")
    same_losses("cache attention 448² int8, reused", reused, ref)

    # baseline, 224², float route at --opt_lvl 0 (kernel C in f32), dropout live
    flags = ("--opt_lvl", "0")
    ref, launches = run("baseline", "cache baseline uncached", "base_uncached", *flags)
    if launches["conv0_f"] != ref["steps"] + ref["eval_batches"] \
            or launches["conv0_s2d_i8"] or launches["conv3x3_i8"]:
        raise AssertionError(f"uncached baseline: not kernel C once a forward: {launches}")
    dropouts = []
    forward = layers.Dropout.forward

    def counted(self, x):
        if self.training:
            dropouts.append(1)
        return forward(self, x)

    layers.Dropout.forward = counted
    try:
        built, launches = run("baseline", "cache baseline build", "base_build", *flags,
                              "--cache_features", "true", "--cache_dir", cache_root)
    finally:
        layers.Dropout.forward = forward
    caches(built, built=True)
    print(f"cache baseline: {len(dropouts)} live dropout calls in {built['steps']} cached "
          f"steps", flush=True)
    if launches["conv0_f"] != build_batches or launches["conv0_s2d_i8"] \
            or launches["conv3x3_i8"] or len(dropouts) != 3 * built["steps"]:
        raise AssertionError(f"cached baseline: kernel C not once per build batch, or the "
                             f"head's three dropouts not in every step: {launches}")
    same_losses("cache baseline 224² f32", built, ref)
    shutil.rmtree(cache_root)
    return path_launches


# the tools phase: BASELINE.md round 2's dataset (the K = 2 redblue task,
# 10,000 train and 2,000 val pairs at 224², seed 0) and the least validation
# accuracy a route must reach on it in one epoch (chance is 50%)
ACC_N_TRAIN, ACC_N_VAL, ACC_SIZE, ACC_MIN = 10000, 2000, 224, 95.0
# the accuracy routes: (name, run_accuracy flags)
ACC_ROUTES = (("float f32 (kernel C)", ("--opt_lvl", "0")),
              ("int8 (kernels A, B)", ("--opt_lvl", "1")),
              ("float f32, --bn_mode batch", ("--opt_lvl", "0", "--bn_mode", "batch")))
DRESS_MODEL, DRESS_IMAGE, DRESS_BATCH = "attention", 448, 8
LATENCY_BATCHES, PROFILE_HEADLINE_STEPS = ("1", "8", "32"), 3


def tools_phase(card: str, device="cuda") -> dict:
    """The port's run tools (``vqa_tpu_torch.tools``, :data:`TOOLS`) on the
    card, each step timed: (a) BASELINE.md round 2's dataset from the port's
    generator and the baseline trained on it for one epoch on three routes
    (``run_accuracy``), each at least ACC_MIN % with its kernels' launches
    exact; (b) the dress rehearsal (attention at 448²); (c) the serving
    latency at b1, b8 and b32; (d) the four b160 configurations' peak memory
    (``mem_report``, which checks A once and B 7 times a forward); (e) the
    headline step's trace (``profile_headline``); (f) the VGG stages at b160
    (``profile_vgg``). Returns {path: launches}, each read just after its run."""
    import shutil
    from unittest import mock

    import torch
    from vqa_tpu_torch import _build
    from vqa_tpu_torch.tools import (dress_rehearsal, latency_report, make_synth_dataset,
                                     mem_report, profile_headline, profile_vgg, run_accuracy)

    work = os.path.join(WORK, "tools")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    path_launches = {}
    seconds = {}

    def timed_step(name, fn):
        if device == "cuda":
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        out = fn()
        seconds[name] = time.perf_counter() - t0
        print(f"tools step {name}: {seconds[name]:.2f} s ({card})", flush=True)
        return out

    # (a) the round-2 dataset, then one epoch of the baseline on three routes
    data = os.path.join(work, "redblue")
    synth = timed_step("a: make_synth_dataset", lambda: make_synth_dataset.main(
        ["--out_dir", data, "--task", "redblue", "--n_train", str(ACC_N_TRAIN), "--n_val",
         str(ACC_N_VAL), "--size", str(ACC_SIZE), "--seed", "0"]))
    if (synth["n_train"], synth["n_val"]) != (ACC_N_TRAIN, ACC_N_VAL):
        raise AssertionError(f"the generator wrote {synth['n_train']} / {synth['n_val']} pairs")
    for route, flags in ACC_ROUTES:
        args = run_accuracy.build_parser().parse_args(
            ["--data_dir", data, "--model", "baseline", "--num_cls", "2", "--epochs", "1",
             "--batch_size", str(BATCH), "--lr", "1e-4", "--num_workers", str(DECODE_THREADS),
             "--expt_dir", os.path.join(work, "acc"), "--device", device, *flags])
        _build.reset_counts()
        rec = timed_step(f"a: run_accuracy {route}", lambda: run_accuracy.run(args))
        launches, plain = counts()
        summary = rec.pop("summary")
        path_launches[f"accuracy {route}"] = launches
        print(f"launches path=accuracy_{re.sub(r'[^a-z0-9]+', '_', route).strip('_')}: "
              f"{json.dumps(launches)}", flush=True)
        print(f"accuracy baseline {route}: val accuracy {rec['val_accuracy']} %, val loss "
              f"{rec['val_loss']}, {rec['train_qa_per_s']:.2f} QA/s (the epoch's train loop, "
              f"validation taken out), {rec['seconds']:.2f} s, decode {rec['decode_backend']}, "
              f"{summary['steps']} steps, {summary['eval_batches']} eval batches ({card})",
              flush=True)
        print("accuracy json: " + json.dumps(rec), flush=True)
        steps, evals = summary["steps"], summary["eval_batches"]
        if "--bn_mode" in flags:        # train steps take batch statistics: no kernel
            expect = {"conv0_f": evals}
        elif flags[1] == "0":
            expect = {"conv0_f": steps + evals}
        else:                           # 8 calibration batches, then every forward
            forwards = 8 + steps + evals
            expect = {"conv0_s2d_i8": forwards, "conv3x3_i8": 7 * forwards}
        got = {k: v for k, v in launches.items() if v}
        if device == "cuda" and (got != expect or any(plain.values())):
            raise AssertionError(f"accuracy {route}: launches {got}, expected {expect}; plain "
                                 f"convs on the card {plain}")
        if not (rec["val_accuracy"] or 0) >= ACC_MIN:
            raise AssertionError(f"accuracy {route}: {rec['val_accuracy']} % < {ACC_MIN} %")
        shutil.rmtree(summary["log_dir"])

    # (b) the dress rehearsal through the CLIs
    dress = timed_step("b: dress_rehearsal", lambda: dress_rehearsal.main(
        ["--device", device, "--model", DRESS_MODEL, "--image_size", str(DRESS_IMAGE),
         "--batch_size", str(DRESS_BATCH), "--work_dir", os.path.join(work, "dress")]))
    print(f"dress rehearsal: {json.dumps(dress)} ({card})", flush=True)

    # (c) serving latency
    latency = timed_step("c: latency_report", lambda: latency_report.main(
        [*LATENCY_BATCHES, "--device", device]))
    for r in latency:
        path_launches[f"latency b{r['batch']}"] = r["forward_launches"]
        print(f"latency b{r['batch']}: device busy {r['device_ms']} ms "
              f"({r['device_ms_per_sample']} a sample), forward {r['forward_ms']:.3f} ms "
              f"(CUDA events, dispatch included), e2e {r['e2e_ms']:.3f} ms "
              f"({r['e2e_ms_per_sample']:.3f} a sample), {r['route']} ({card})", flush=True)
        if device == "cuda" and r["forward_launches"] != {"conv0_s2d_i8": 1, "conv3x3_i8": 7}:
            raise AssertionError(f"latency b{r['batch']}: a forward launched "
                                 f"{r['forward_launches']}, not A once and B 7 times")

    # (d) device memory at b160
    mem = timed_step("d: mem_report", lambda: mem_report.main(["--device", device]))
    for r in mem:
        path_launches[f"mem {r['config']}"] = r["launches"]
        print(f"mem {r['config']} ({r['mode']}, b{r['batch']}): " + json.dumps(
            {k: v for k, v in r.items() if k not in ("config", "mode", "batch", "card")})
            + f" ({card})", flush=True)

    # (e) the headline step's trace
    with mock.patch.dict(os.environ, {
            "PROFILE_STEPS": str(PROFILE_HEADLINE_STEPS), "BENCH_MODE": "train",
            "PROFILE_OUT": os.path.join(work, "profile"),
            "BENCH_BATCH": str(PROBE_BATCH if device == "cuda" else BATCH)}):
        prof = timed_step("e: profile_headline", lambda: profile_headline.main(
            ["--device", device]))
    path_launches["profile_headline (a step)"] = prof["launches_per_step"]
    groups = {r["group"]: r for r in prof["groups"]}
    for r in prof["groups"][:6]:
        print(f"profile_headline {r['group']}: {r['ms']:.3f} ms a step, {r['calls']:.1f} calls, "
              f"{r['gflop']:.1f} GFLOP, {r['mb']:.1f} MB, {r['verdict']} ({card})", flush=True)
    print(f"profile_headline: wall {prof['wall_ms_per_step']:.3f} ms a step "
          f"({prof['profiled_ms_per_step']:.3f} ms under the profiler), device busy "
          f"{prof['device_busy_ms_per_step']:.3f} ms, idle share "
          f"{prof['device_idle_share']:.4f} ({card})", flush=True)
    if device == "cuda":
        a, b = (groups.get(k) for k in ("kernel A (conv0_s2d_i8)", "kernel B (conv3x3_i8)"))
        if a is None or b is None or a["calls"] != 1 or b["calls"] != 7:
            raise AssertionError("the headline trace lacks kernel A once or B 7 times a step")
        print(f"profile_headline kernels: A {a['ms']:.4f} ms, B {b['ms']:.4f} ms a step "
              f"({card})", flush=True)

    # (f) the VGG's stages at b160
    with mock.patch.dict(os.environ, {"BENCH_BATCH": str(PROBE_BATCH if device == "cuda" else 2),
                                      "BENCH_STEPS": "10"}):
        vgg = timed_step("f: profile_vgg", lambda: profile_vgg.main(["--device", device]))
    print(f"profile_vgg: {json.dumps(vgg['summary'])}", flush=True)
    shutil.rmtree(work)
    print(f"tools phase: {sum(seconds.values()):.2f} s ({card})", flush=True)
    return path_launches


# the multi-device phase: its DP runs at world 1 must equal the run without a
# mesh bit for bit, FSDP within FSDP_RTOL; the (1, 1)-mesh dry run's two legs
# within DRYRUN_TOL (vqa_tpu's bound, __graft_entry__.py:192-193); two ranks'
# losses within TWO_RANK_RTOL of world 1: the head runs in bf16 at --opt_lvl 1,
# and 16-row products reduce in another order than 32-row ones
# (tests/test_torch_train.py's trajectory tolerance)
FSDP_RTOL, DRYRUN_TOL, TWO_RANK_RTOL = 1e-5, 1e-2, 2e-3
PARAM_CHECKSUMS: list = []


def param_checksum(model) -> int:
    """An exact fingerprint of the trainable parameters' bits (int64 sums of
    their 32-bit patterns under position weights, wrapping)."""
    import torch
    total = torch.zeros((), dtype=torch.int64, device=next(model.parameters()).device)
    for p in model.parameters():
        if p.requires_grad:
            bits = p.detach().float().contiguous().view(torch.int32).reshape(-1).long()
            w = torch.arange(1, bits.numel() + 1, device=bits.device, dtype=torch.int64) % 65521
            total += (bits * (w + 1)).sum()
    return int(total)


def _checksummed_make_train_step(make):
    """``main.make_train_step`` with a parameter checksum after every step."""
    def wrapped(*a, **kw):
        step = make(*a, **kw)

        def train_step(state, batch):
            out = step(state, batch)
            PARAM_CHECKSUMS.append(param_checksum(state.model))
            return out
        return train_step
    return wrapped


def _two_rank(argv: list, share: bool) -> dict:
    """One rank of the two-rank leg (torchrun's environment is set): the
    user's entry point, ``vqa_tpu_torch.main.main``, with a parameter
    checksum after every train step."""
    if share:
        os.environ["VQA_SHARE_DEVICE"] = "1"
    sys.path.insert(0, ROOT)
    from vqa_tpu_torch import main as vqa
    vqa.make_train_step = _checksummed_make_train_step(vqa.make_train_step)
    if os.environ["RANK"] != "0":
        sys.stdout = open(os.devnull, "w")
    out = vqa.main(argv)
    out["checksums"] = list(PARAM_CHECKSUMS)
    out.pop("feature_caches", None)
    return out


def multidevice_phase(vocab_file, card: str, device="cuda") -> dict:
    """The mesh paths (vqa_tpu's --num_devices/--force_mesh/--fsdp/
    --model_parallel/--seq_parallel) on the card; returns {path: launches}."""
    import shutil

    import torch
    from vqa_tpu_torch import _build
    from vqa_tpu_torch.main import main as vqa_main
    from vqa_tpu_torch.multichip import dryrun_multichip

    t_phase = time.perf_counter()
    runs = os.path.join(WORK, "runs_mesh")
    shutil.rmtree(runs, ignore_errors=True)
    train6, train3 = write_dataset("mesh6", N_TRAIN, 5), write_dataset("mesh3", 3 * BATCH, 6)
    val = write_dataset("mesh_val", BATCH, 7)
    path_launches = {}

    def args(model, mode, run, train_file, *extra):
        return ["--mode", mode, "--model", model, "--expt_dir", runs, "--expt_name", "mesh",
                "--run_name", f"{model}_{run}", "--train_img", WORK, "--train_file",
                train_file, "--val_img", WORK, "--val_file", val, "--vocab_file", vocab_file,
                "--batch_size", str(BATCH), "--num_epochs", "1", "--num_cls", str(ANSWERS),
                "--synthetic_images", "true", "--log_interval", "2", "--save_interval", "100",
                "--val_size", str(BATCH), "--num_workers", "8", "--device", device, *extra]

    def run(path, model, mode, name, train_file, *extra):
        _build.reset_counts()
        torch.cuda.reset_peak_memory_stats()
        out = vqa_main(args(model, mode, name, train_file, *extra))
        launches = {k.symbol: k.launches for k in _build.KERNELS}
        plain = {k.symbol: k.plain_on_cuda for k in _build.KERNELS}
        if any(plain.values()):
            raise AssertionError(f"{path} ran a plain conv on a CUDA tensor: {plain}")
        path_launches[path] = launches
        print(f"launches path={path.replace(' ', '_')}: {json.dumps(launches)}", flush=True)
        return out, launches

    def qa_s(out, first, last):
        sync = dict(out["sync_points"])
        return (last - first) * BATCH / (sync[last] - sync[first])

    def rel(a, b):
        return max(abs(x - y) / abs(y) for x, y in zip(a, b))

    def int8_forwards(out, ranks=1):
        return ranks * (1 + out["steps"]) + out["eval_batches"] * ranks

    int8 = ("--opt_lvl", "1", "--int8_calib", "1")
    # 1. world 1 through the mesh code path: DDP, then FSDP, on NCCL
    ref, ref_l = run("mesh none attention", "attention", "train", "ref", train6, *int8)
    dp, dp_l = run("mesh dp1 attention", "attention", "train", "dp1", train6, *int8,
                   "--force_mesh", "true")
    fsdp, fsdp_l = run("mesh fsdp1 attention", "attention", "train", "fsdp1", train6, *int8,
                       "--force_mesh", "true", "--fsdp", "true", "--save_interval", "6")
    for name, out, launches in (("dp", dp, dp_l), ("fsdp", fsdp, fsdp_l)):
        extra_ms = 1e3 * BATCH * (1 / qa_s(out, 2, 6) - 1 / qa_s(ref, 2, 6))
        print(f"mesh world 1 {name} attention 448² int8 ({card}): losses {out['losses']} vs "
              f"no mesh {ref['losses']}; steps 3-6 {qa_s(out, 2, 6):.2f} QA/s (no mesh "
              f"{qa_s(ref, 2, 6):.2f}), {extra_ms:.2f} ms a step over the run without a "
              f"mesh; peak device memory "
              f"{out['peak_memory_bytes'] / 2 ** 30:.2f} GiB", flush=True)
        if launches != ref_l or launches["conv0_s2d_i8"] != int8_forwards(out):
            raise AssertionError(f"mesh world 1 {name}: launches {launches}, the run without "
                                 f"a mesh {ref_l}")
    if dp["losses"] != ref["losses"]:
        raise AssertionError("mesh world 1 DP: losses are not bit-equal to the run without "
                             "a mesh")
    if fsdp["steps"] != ref["steps"] or not rel(fsdp["losses"], ref["losses"]) <= FSDP_RTOL:
        raise AssertionError(f"mesh world 1 FSDP: losses beyond {FSDP_RTOL} relative")
    print(f"mesh world 1: DP bit-equal, FSDP max relative difference "
          f"{rel(fsdp['losses'], ref['losses'])} (tolerance {FSDP_RTOL})", flush=True)
    # --mode test on the checkpoint the FSDP run gathered and wrote, on the
    # mesh and without it
    ckpt = os.path.join(fsdp["log_dir"], "model_6.ckpt")
    tests = [run(f"mesh test{tag} attention", "attention", "test", "fsdp1", train6, *int8,
                 "--model_ckpt", ckpt, *flags)
             for tag, flags in (("1", ("--force_mesh", "true")), ("", ()))]
    results = [{k: out[k] for k in ("accuracy", "loss", "samples")} for out, _ in tests]
    print(f"mesh world 1 --mode test on the FSDP run's model_6.ckpt: {results[0]} (no mesh "
          f"{results[1]})", flush=True)
    if results[0] != results[1] or results[0]["samples"] != BATCH \
            or {k: n for k, n in tests[0][1].items() if n} != {"conv0_s2d_i8": 1,
                                                                "conv3x3_i8": 7}:
        raise AssertionError("mesh world 1 --mode test: not the run without a mesh's "
                             "result, or not A once and B 7 times for its one batch")

    # 2. the (1, 1) ('data', 'model') mesh: DP step, then tp+sp+fsdp
    t0 = time.perf_counter()
    dry = dryrun_multichip(1, device)
    path_launches["mesh dryrun 1x1 attention"] = dry["launches"]
    print(f"launches path=mesh_dryrun_1x1: {json.dumps(dry['launches'])}; "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    if not abs(dry["tp_loss"] - dry["loss"]) < DRYRUN_TOL or dry["mesh_2d"] != (1, 1) \
            or dry["launches"]["conv0_s2d_i8"] != 3 or dry["launches"]["conv3x3_i8"] != 21:
        raise AssertionError(f"dryrun_multichip(1): {dry}")

    # 3. two ranks: NCCL over two cards, or gloo with both ranks on this one
    two_cards = torch.cuda.device_count() >= 2
    how = "NCCL, two cards" if two_cards else "gloo, both ranks on one card"
    ref3, _ = run("mesh none3 attention", "attention", "train", "ref3", train3, *int8,
                  "--log_interval", "1")
    from vqa_tpu_torch.parallel.distributed import spawn
    argv = args("attention", "train", "dp2", train3, *int8, "--log_interval", "1")
    t0 = time.perf_counter()
    outs = spawn(_two_rank, 2, (argv, not two_cards))
    launches = {k: outs[0]["launches"][k] + outs[1]["launches"][k] for k in outs[0]["launches"]}
    path_launches["mesh dp2 attention"] = launches
    print(f"launches path=mesh_dp2 (summed over the 2 ranks): {json.dumps(launches)}",
          flush=True)
    print(f"mesh two ranks ({how}; {card}): losses {outs[0]['losses']} vs world 1 "
          f"{ref3['losses']}, max relative difference {rel(outs[0]['losses'], ref3['losses'])} "
          f"(tolerance {TWO_RANK_RTOL}); parameter checksums per step rank 0 "
          f"{outs[0]['checksums']} rank 1 {outs[1]['checksums']}; steps 2-3 "
          f"{qa_s(outs[0], 1, 3):.2f} QA/s (world 1 {qa_s(ref3, 1, 3):.2f}); peak device "
          f"memory per rank {[round(outs[i]['peak_memory_bytes'] / 2 ** 30, 2) for i in (0, 1)]}"
          f" GiB; {time.perf_counter() - t0:.2f} s", flush=True)
    if outs[0]["checksums"] != outs[1]["checksums"] or len(outs[0]["checksums"]) != 3:
        raise AssertionError("two ranks: the trainable parameters differ after a step")
    if not rel(outs[0]["losses"], ref3["losses"]) <= TWO_RANK_RTOL:
        raise AssertionError(f"two ranks: losses beyond {TWO_RANK_RTOL} of world 1")
    # every rank calibrates on the full batch and runs its 16 rows a forward
    need = int8_forwards(outs[0], ranks=2)
    if launches["conv0_s2d_i8"] != need or launches["conv3x3_i8"] != 7 * need \
            or launches["conv0_f"]:
        raise AssertionError(f"two ranks: launches {launches}, need A {need}, B {7 * need}")

    # 4. the float route (kernel C in f32, dropout live) through DDP at world 1
    f32 = ("--opt_lvl", "0", "--log_interval", "1")
    bref, bref_l = run("mesh none baseline", "baseline", "train", "ref", train3, *f32)
    bdp, bdp_l = run("mesh dp1 baseline", "baseline", "train", "dp1", train3, *f32,
                     "--force_mesh", "true")
    print(f"mesh world 1 dp baseline 224² f32 ({card}): losses {bdp['losses']} vs no mesh "
          f"{bref['losses']}; steps 2-3 {qa_s(bdp, 1, 3):.2f} QA/s (no mesh "
          f"{qa_s(bref, 1, 3):.2f}); peak device memory "
          f"{bdp['peak_memory_bytes'] / 2 ** 30:.2f} GiB", flush=True)
    if bdp["losses"] != bref["losses"] or bdp_l != bref_l \
            or bdp_l["conv0_f"] != bdp["steps"] + bdp["eval_batches"]:
        raise AssertionError("mesh world 1 DP baseline: not bit-equal to the run without a "
                             "mesh, or kernel C not once a forward")
    shutil.rmtree(runs, ignore_errors=True)
    print(f"multi-device phase: {time.perf_counter() - t_phase:.2f} s ({card})", flush=True)
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
        regs = [ln.strip() for ln in k.build_log.splitlines()
                if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
        print(f"build {k.source}: {regs}", flush=True)
    # ptxas -v: kernel C's bodies hold their fragments in registers, unspilled
    spills = re.findall(r"(\d+) bytes spill (?:stores|loads)", _build.CONV0_F.build_log)
    if any(int(n) for n in spills):
        raise AssertionError(f"kernel C spills registers: {spills}")

    sass_counts()
    dev = torch.device("cuda")
    # the attention model's shapes (448²), then the baseline and bert models' (224²)
    rows = {image: kernel_phase(dev, image) for image in (IMAGE, IMAGE_224)}
    vocab_file, pairs = write_requests()
    from vqa_tpu_torch.vocab import Vocab
    t0 = time.perf_counter()
    last_rows, last_launches = last_kernels_phase(dev, Vocab.load(vocab_file).max_seq_length,
                                                  card)
    for image, image_rows in last_rows.items():
        rows[image].update(image_rows)
    print(f"kernels D and E phase: {time.perf_counter() - t0:.2f} s ({card})", flush=True)
    torch.cuda.empty_cache()
    probe_rows, probe_launches = probes_phase(dev, card)
    # kernel F's rows and kernel D's unpooled mode (probe 6e) join the JSON
    # lines' rows; F's yardstick is one GEMM of its operations
    # (exp_r5_mosaic_dot.stacked_operands)
    for r in probe_rows:
        f_row = r["kernel"] == "mma_rate"
        if f_row or r["variant"] == "tap_bf16_nopool":
            rows[IMAGE][(r["kernel"], r["variant"] if f_row else "unpooled bf16")] = {
                **{f: r[f] for f in ("max_abs_err", "ms", "launch_ms", "plain_ms", "bound_ms",
                                     "bound_by")},
                "library_ms": r["library_ms"],
                **({} if f_row else {"batch": PROBE_BATCH})}
    del probe_rows
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    moe_row = moe_phase(card)
    print(f"moe phase: {time.perf_counter() - t0:.2f} s", flush=True)
    serve_launches, export_launches = {}, {}
    forwards = -(-N_REQUESTS // BATCH)
    for model_name in ("attention", "baseline", "bert"):
        predictor, serve_launches[model_name] = serve_phase(vocab_file, pairs, model_name)
        if model_name != "bert":
            cross_device_phase(predictor, pairs)
        if model_name == "attention":
            # the int8 artifact: kernel A once and B 7 times a request batch
            export_launches.update(export_phase(
                predictor, vocab_file, pairs,
                {"conv0_s2d_i8": forwards, "conv3x3_i8": 7 * forwards}, card))
        del predictor
        torch.cuda.empty_cache()
    # the f32 artifact: baseline at --opt_lvl 0, kernel C (3xTF32) once a batch
    from vqa_tpu_torch.serve import VQAPredictor
    predictor = VQAPredictor("baseline", Vocab.load(vocab_file), batch_size=BATCH, opt_lvl=0,
                             synthetic_images=True, device="cuda")
    export_launches.update({f"{k} f32": v for k, v in export_phase(
        predictor, vocab_file, pairs, {"conv0_f": forwards}, card).items()})
    del predictor
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    train_launches = train_phase(vocab_file, card)
    print(f"train phase: {time.perf_counter() - t0:.2f} s", flush=True)
    train_launches.update(multidevice_phase(vocab_file, card))
    etl = etl_phase(card)
    native, reason = native_decoder_buildable()
    if not native:
        print(f"native decoder: not buildable on this host ({reason})", flush=True)
    decode_phase(etl["images"], native, card)
    t0 = time.perf_counter()
    train_launches.update(cache_phase(etl, native, card))
    print(f"cache phase: {time.perf_counter() - t0:.2f} s", flush=True)
    torch.cuda.empty_cache()
    train_launches.update(tools_phase(card))

    def kernel_fields(image, k, mode):
        r = rows[image][(k.symbol, mode)]
        return {"name": k.symbol, "route": "cuda",
                "source": os.path.relpath(os.path.join(_build.CSRC, k.source), ROOT),
                "replaces": k.replaces,
                "max_abs_err": max(v["max_abs_err"] for rs in rows.values()
                                   for (name, _), v in rs.items() if name == k.symbol),
                **{f: r[f] for f in ("ms", "launch_ms", "plain_ms", "bound_ms", "bound_by",
                                     "library_ms", "cuda_core_bound_ms", "batch") if f in r},
                **({"dispatch_us": (r["op_host_us"] - r["direct_host_us"]) / r["calls"]}
                   if "calls" in r else {})}

    # the JSON line's modes: kernel A's requant, kernel B's conv1-7 static
    # path summed, kernel C in bf16; every mode at 448² and at 224² on the
    # lines above it
    json_modes = {"conv0_s2d_i8": "static requant", "conv3x3_i8": "static", "conv0_f": "bf16",
                  "conv3x3_f": "bf16", "coattention_fwd": "bf16", "mma_rate": "s8 K=128 ndots=12"}
    for image, models in ((IMAGE, "attention"), (IMAGE_224, "baseline and bert")):
        print(f"kernels at {image}² (b32 unless a row names its batch; {models}): " + json.dumps([
            {**kernel_fields(image, k, mode), "mode": mode}
            for k in _build.KERNELS for (name, mode) in rows[image] if name == k.symbol]),
            flush=True)
    by_path = {**{f"serve {m}": v for m, v in serve_launches.items()}, **export_launches,
               **train_launches, "probes": probe_launches}
    print("launches by path: " + json.dumps(by_path), flush=True)
    # launches: kernels A and B from the attention model's serving path,
    # kernel C from its float-route training run, D and E from their paths,
    # F from the probes (each read just after its own run)
    path_launches = {**serve_launches["attention"],
                     "conv0_f": train_launches["train float attention"]["conv0_f"],
                     **last_launches, "mma_rate": probe_launches["mma_rate"]}
    print(card, flush=True)
    print(json.dumps({"kernels": [
        {**kernel_fields(IMAGE, k, json_modes[k.symbol]), "launches": path_launches[k.symbol]}
        for k in _build.KERNELS] + [moe_row]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
