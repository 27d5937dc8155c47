"""Train/eval CLI (port of vqa_tpu/main.py), flag-compatible with it.

    python -m vqa_tpu_torch.main --mode train --model attention|baseline|bert \\
        --expt_dir runs --expt_name e --run_name r --train_img imgs \\
        --train_file train.txt --val_img imgs --val_file val.txt \\
        --vocab_file vocab.pkl --batch_size 32 [--int8_backbone false]

The flags are vqa_tpu.main's (names, types, defaults), plus ``--device``
(default ``cuda``; exits non-zero without a card, never falls back to the
CPU). The run layout, logs, TensorBoard tags, ``model_<step>.ckpt``
checkpoints, the periodic and epoch-end validation with the reference's
metric, exact resume (``--model_ckpt`` or ``latest``: optimizer, step,
generator and the data order's intra-epoch position) and ``--mode test``
are vqa_tpu's.

Routes: at the default ``--opt_lvl 1`` on the card the int8 backbone
auto-enables and calibrates static scales over ``--int8_calib`` train
batches (reusing the run's ``int8_calib.json``); conv0-7 then run kernels A
and B. With ``--int8_backbone false`` (or ``--opt_lvl 0``) conv0 runs kernel
C and conv1-7 ``F.conv2d``. ``--vgg_train true`` trains the VGG (batch-stats
BatchNorm, the conv stack recomputed in backward, Adam over every
parameter; cuDNN convs, no kernel; ``--int8_backbone true`` then fails).
``--bn_mode batch`` trains a frozen VGG with batch statistics, the
reference's quirk: train steps bypass the int8 stages, while calibration and
evaluation keep the running stats. ``--grad_accum N`` accumulates N
microbatches a step; ``--profile_steps N`` writes a ``torch.profiler``
trace of N steps into the run directory, the program's spans in it. Each
log line adds the median host ms, since the last line, of the step's
phases (``HOST_PHASES``: the wait for the loader, forward, backward, Adam),
also as TensorBoard's ``Train/HostMs/<phase>``.

``--cache_features true`` runs the frozen tower once per unique image
(``data.feature_cache``): after the checkpoint loads and the int8 stages
calibrate, a build pass writes (or a later run reuses) one cache per
dataset under ``--cache_dir`` (default ``<run dir>/feature_cache``), and
every train step and eval batch then reads cached rows: no VGG forward runs
in them. It needs a frozen VGG with running statistics (``--vgg_train
true`` and ``--bn_mode batch`` exit). ``--decode_backend`` takes vqa_tpu's
engines: ``auto`` (a process pool of native decoders for real data with
``--num_workers > 1``), ``native``, ``native_mp`` and ``pil``.

Several devices (``parallel``): ``--num_devices N`` spawns N local ranks,
one device each (under ``torchrun`` the launcher's world is the mesh, and
``--force_mesh true`` runs the mesh code path in a process group of one),
with vqa_tpu's start-up checks and messages. Every rank trains on its block
of each batch: data parallel (``DistributedDataParallel``), or with
``--model_parallel m`` / ``--fsdp true`` the trainable head placed on the
``("data", "model")`` mesh (TP and FSDP2, ``parallel.sharding``) and, with
``--seq_parallel true``, the co-attention's image sequence sharded over
``model``. Rank 0 logs and writes the flat ``model_<step>.ckpt`` (the full
state, which resumes at any world size); ``--ckpt_backend orbax`` writes a
sharded ``torch.distributed.checkpoint`` directory ``model_<step>.orbax``.
``--gpu_id`` is accepted and ignored, as in vqa_tpu.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from .config import (MODEL_CONFIGS, build_model, compute_dtype_for_opt_lvl, int_min_two,
                     resolve_device, str2bool)
from .data.dataset import VQASamples
from .data.pipeline import DataLoader, device_batch, device_prefetch, make_image_preprocessor
from .models.vgg import VGG11HeadEncoder
from .parallel import distributed
from .train.checkpoint import (AsyncCheckpointer, latest_checkpoint, load_any,
                               load_params_only)
from .train.logging import ETAEstimator, make_summary_writer, print_and_log, setup_logs_file
from .train.profiling import ProfileWindow, SyncedRateTracker, summary
from .train.state import create_train_state
from .train.steps import compute_validation_metrics, make_eval_step, make_train_step
from .vocab import Vocab

# the host phases of a train step that each log line reports: (label, span)
HOST_PHASES = (("data.wait", "vqa.data.wait"), ("forward", "vqa.train.forward"),
               ("backward", "vqa.train.backward"), ("optimizer", "vqa.train.optimizer"))


def host_phase_ms(since: int) -> dict[str, float]:
    """{label: median host ms} of :data:`HOST_PHASES` over the spans that
    started at or after ``since`` (a ``perf_counter_ns`` reading)."""
    spans = summary(since)
    return {label: spans[name]["median_ms"] for label, name in HOST_PHASES if name in spans}


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Visual Question Answering (PyTorch/CUDA)")
    add = parser.add_argument
    # experiment (reference main.py:37-41)
    add("--mode", type=str, required=True, choices=["train", "test"])
    add("--expt_dir", type=str, required=True, help="root directory for models and summaries")
    add("--expt_name", type=str, required=True, help="expt_dir/expt_name")
    add("--run_name", type=str, required=True, help="expt_dir/expt_name/run_name")
    add("--model", type=str, required=True, choices=["baseline", "attention", "bert"])
    # data (main.py:44-51)
    add("--train_img", type=str, help="training images directory")
    add("--train_file", type=str, help="training dataset file")
    add("--val_img", type=str, help="validation images directory")
    add("--val_file", type=str, help="validation dataset file")
    add("--num_cls", "-K", type=int_min_two, default=1000, help="top K answers; min=2")
    add("--vocab_file", type=str, help="vocabulary pickle (prepare_data.py)")
    # training (main.py:54-62)
    add("--batch_size", "-bs", type=int, default=8)
    add("--num_epochs", "-ep", type=int, default=50)
    add("--learning_rate", "-lr", type=float, default=1e-4)
    add("--log_interval", type=int, default=100, help="steps between training summaries")
    add("--save_interval", type=int, default=3000, help="steps between checkpoints")
    add("--val_size", type=int, default=10000, help="validation samples per periodic eval")
    add("--K_eval", type=int, default=1000, help="top-K labels at evaluation (unused)")
    # model (main.py:65-67)
    add("--model_ckpt", type=str, help="resume / evaluate: model_<step>.ckpt, 'latest' or a .pth")
    add("--vgg_wts_path", type=str, help="torchvision VGG-11-bn weights (.pth)")
    add("--vgg_train", type=str2bool, default="false",
        help="train the VGG (batch-stats BatchNorm, no int8)")
    # device (main.py:72-73)
    add("--gpu_id", type=int, default=0, help="accepted for script compatibility, ignored")
    add("--opt_lvl", type=int, default=1, choices=[0, 1, 2, 3],
        help="precision: 0 = fp32, 1-3 = bf16 compute with fp32 params")
    add("--device", type=str, default="cuda",
        help="torch device; 'cuda' (the default) fails without a card")
    # input pipeline (main.py:76)
    add("--num_workers", type=int, default=6,
        help="host image-decode threads (native_mp: processes)")
    add("--decode_backend", type=str, default="auto",
        choices=["auto", "native", "pil", "native_mp"],
        help="host decode engine: auto = native_mp for real data with --num_workers > 1 "
             "when the native decoder builds, else native for JPEGs, else pil")
    # vqa_tpu extensions
    add("--num_devices", type=int, default=1,
        help="devices (one process each): > 1 spawns the local ranks "
             "(under torchrun the launcher's world is the mesh)")
    add("--model_parallel", type=int, default=1,
        help="tensor-parallel ways: a (N // m, m) ('data', 'model') mesh")
    add("--fsdp", type=str2bool, default="false",
        help="shard the trainable parameters and Adam's moments over the data axis (FSDP2)")
    add("--ckpt_backend", type=str, default="flax", choices=["flax", "orbax"],
        help="'flax' = one model_<step>.ckpt file (a torch.save of the full state, "
             "rank 0); 'orbax' = a sharded torch.distributed.checkpoint directory "
             "model_<step>.orbax, each rank writing its shards")
    add("--grad_accum", type=int, default=1,
        help="microbatches per step, one optimizer update (must divide --batch_size)")
    add("--seq_parallel", type=str2bool, default="false",
        help="shard the image feature sequence over the model axis in the co-attention "
             "(attention; needs --model_parallel > 1)")
    add("--preempt_save", type=str2bool, default="true",
        help="on SIGTERM, save a checkpoint at the next step boundary and exit")
    add("--force_mesh", type=str2bool, default="false",
        help="the mesh code path even at --num_devices 1 (a process group of one)")
    add("--use_pallas", type=str2bool, default="false",
        help="retired in vqa_tpu (PARITY.md M8); 'true' fails")
    add("--synthetic_images", type=str2bool, default="false",
        help="deterministic synthetic images when files are missing")
    add("--host_size", type=int, default=0, help="host-side decode size (0 = image size)")
    add("--seed", type=int, default=0, help="global seed (init, data order, state RNG)")
    add("--image_size", type=int, default=0, help="model input resolution (0 = per-model)")
    add("--test_out", type=str, help="test mode: write predictions here")
    add("--test_out_format", type=str, default="plain", choices=["plain", "vqa"],
        help="plain = one answer per line; vqa = [{question_id, answer}] JSON")
    add("--profile_steps", type=int, default=0,
        help="write a torch.profiler trace of N train steps into the run dir")
    add("--bn_mode", type=str, default="auto", choices=["auto", "batch", "running"],
        help="BatchNorm in training: auto = batch stats iff --vgg_train; batch = "
             "batch stats even when frozen (the reference's quirk); running = "
             "always running stats")
    add("--prefetch_batches", type=int, default=2,
        help="device batches enqueued ahead of the train step (<=1 disables)")
    add("--cache_features", type=str2bool, default="false",
        help="run the frozen image tower once per image into an on-disk cache and "
             "train the head on it (needs --vgg_train false and running-stats BN)")
    add("--int8_backbone", type=str, default="auto", choices=["auto", "true", "false"],
        help="int8-PTQ frozen VGG; auto = on at --opt_lvl >= 1 on a CUDA device")
    add("--hpack_pool", type=str2bool, default="true",
        help="pooled int8 stages with C_in <= 64 in one fused pass")
    add("--fused_stem", type=str2bool, default="true",
        help="conv0 -> conv1 int8 hand-off once static calibration exists")
    add("--int8_handoff", type=str2bool, default="true",
        help="int8 stage outputs quantized for the next stage in the epilogue")
    add("--int8_stages", type=str, default="auto",
        help="comma-separated conv indices (0-7) to int8-quantize")
    add("--int8_calib", type=int, default=8,
        help="train batches for static int8 calibration (0 = dynamic scales)")
    add("--cache_dir", type=str, default="",
        help="feature-cache root (default: <run dir>/feature_cache); a cache is "
             "keyed by the weights, calibration, dataset and input pipeline")
    return parser


def mesh_requested(args) -> bool:
    """A device mesh runs: several devices, ``--force_mesh``, or a launcher's
    world of more than one process."""
    return (args.num_devices > 1 or args.force_mesh
            or (distributed.launched() and int(os.environ["WORLD_SIZE"]) > 1))


def check_mesh_flags(args) -> None:
    """vqa_tpu's start-up checks of the mesh flags (vqa_tpu/main.py:432-450),
    with its messages."""
    on_mesh = mesh_requested(args)
    if not on_mesh and (args.model_parallel > 1 or args.fsdp):
        raise SystemExit("--model_parallel/--fsdp need a device mesh: set "
                         "--num_devices > 1 (or --force_mesh true)")
    if args.seq_parallel:
        if not on_mesh or args.model_parallel <= 1:
            raise SystemExit("--seq_parallel requires --model_parallel > 1")
        if args.model != "attention":
            raise SystemExit(f"--seq_parallel is attention-family only "
                             f"(got --model {args.model})")
        image_size = args.image_size or MODEL_CONFIGS[args.model].image_size
        seq_len_s = (image_size // 32) ** 2  # VGG downsamples 32x
        if seq_len_s % args.model_parallel:
            raise SystemExit(
                f"--seq_parallel: the image feature sequence S={seq_len_s} "
                f"(image_size {image_size}) is not divisible by "
                f"--model_parallel {args.model_parallel}; the constraint "
                f"would silently no-op")


def _resolve_ckpt(model_ckpt: str, log_dir: str) -> str:
    """``latest`` -> the run's highest-step checkpoint; a bare name is
    looked up in the run directory."""
    if model_ckpt == "latest":
        path = latest_checkpoint(log_dir)
        if path is None:
            raise SystemExit(f"--model_ckpt latest: no model_<step>.ckpt in {log_dir}")
        return path
    return model_ckpt if os.path.exists(model_ckpt) else os.path.join(log_dir, model_ckpt)


def _load_vgg_weights(model, path: str) -> None:
    """torchvision ``vgg11_bn`` weights into the VGG: ``features.*`` into the
    conv stack and, where the model has the classifier head (baseline,
    bert), ``classifier.0`` and ``classifier.3`` into its two layers
    (vqa_tpu/models/convert.py:85-97; both layouts are torchvision's)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    feats = {k[len("features."):]: v for k, v in sd.items() if k.startswith("features.")}
    model.vgg.load_state_dict(feats, strict=True)
    tower = model.image_encoder.vgg11_encoder
    if isinstance(tower, VGG11HeadEncoder):
        tower.fc_layers.load_state_dict({f"{j}.{p}": sd[f"classifier.{i}.{p}"]
                                         for i, j in ((0, 1), (3, 4))
                                         for p in ("weight", "bias")}, strict=True)


def _make_feature_encoder(model_name: str, model, preprocess):
    """``(encode_fn, fingerprint, boundary)`` of the feature cache's build
    (vqa_tpu/main.py:330-384): ``encode_fn`` maps host uint8 images to the
    model's cacheable frozen values (``VQANet.cache_features``); the
    fingerprint covers exactly the tensors that encoder reads (the conv
    stack's parameters and BatchNorm buffers: a head-only change keeps the
    cache); the boundary names it, with the int8 routing and the calibrated
    scales, which change the values, so int8, float and differently
    calibrated caches never share a directory."""
    from .data.feature_cache import variables_fingerprint

    vgg = model.vgg
    stages = vgg.int8_stages
    int8_tag = ""
    if stages:
        int8_tag = f"|i8{','.join(map(str, stages))}"
        if vgg.hpack_pool:
            int8_tag += "|hp"
        if vgg.fused_stem and vgg.int8_amax and 0 in stages and 1 in stages:
            int8_tag += "|fs"       # conv1's input quantized from conv0's epilogue
        if vgg.int8_handoff and vgg.int8_amax and any((i + 1) in stages for i in stages):
            int8_tag += "|ho"       # stage outputs quantized in the epilogue
        if vgg.int8_amax:
            int8_tag += "@" + ",".join(
                f"{v:.8g}" for a in vgg.int8_amax
                for v in (a if isinstance(a, (tuple, list)) else (a,)))
    boundary = ("coattn_image_encoder" if model_name == "attention"
                else "vgg11_features") + int8_tag

    def encode(images_u8):
        with torch.no_grad():
            return model.cache_features(preprocess(images_u8))

    return encode, variables_fingerprint(vgg.state_dict()), boundary


def _pad_to_multiple(batch: dict, multiple: int):
    """A host batch's rows padded to a multiple by repeating the last row
    (vqa_tpu/main.py:289-306); returns ``(padded, n_valid)``."""
    n = len(batch["label"])
    pad = (-n) % multiple
    if pad == 0:
        return batch, n

    def p(a):
        a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        return np.concatenate([a, np.repeat(a[-1:], pad, axis=0)])

    return {k: p(v) for k, v in batch.items()}, n


def _host_images(loader, n: int):
    """The first ``n`` image batches of ``loader``, streamed."""
    it = iter(loader)
    try:
        for _ in range(n):
            try:
                yield next(it)["image"]
            except StopIteration:
                return
    finally:
        it.close()


def main(argv=None):
    """Run ``--mode train`` or ``--mode test``; returns that mode's summary
    dict (rank 0's, with every rank's in ``ranks``, when it spawned ranks)."""
    parser = build_parser()
    args = parser.parse_args(argv)
    check_mesh_flags(args)
    if args.num_devices > 1 and not distributed.launched() and not dist.is_initialized():
        return _spawn_ranks(args, list(sys.argv[1:] if argv is None else argv))
    return _run(args)


def _spawn_ranks(args, argv: list) -> dict:
    """``--num_devices N`` on one host: N local ranks, one device each; the
    kernels are built here first, so the ranks only load them."""
    if torch.device(args.device).type == "cuda":
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have == 0:
            resolve_device(args.device)      # raises: no card
        if args.num_devices > have and not distributed.share_device():
            raise ValueError(f"requested {args.num_devices} devices, have {have}")
        from . import _build
        _build.build_all()
    try:
        ranks = distributed.spawn(_rank_main, args.num_devices, (argv,))
    except RuntimeError as e:
        raise SystemExit(str(e)) from e
    return {**ranks[0], "ranks": ranks}


def _rank_main(argv: list) -> dict:
    """One spawned rank: :func:`main` under torchrun's environment; rank 0
    logs. Returns its summary, with the feature caches as paths."""
    if os.environ["RANK"] != "0":
        sys.stdout = open(os.devnull, "w")
    summary = main(argv)
    summary["feature_caches"] = [c.cache_dir for c in summary.get("feature_caches", [])]
    return summary


def _run(args) -> dict:
    device_type = torch.device(args.device).type
    owns_group = False
    if mesh_requested(args) and not dist.is_initialized():
        resolve_device(args.device)
        if distributed.launched():
            distributed.initialize_distributed(device_type)
        else:   # --force_mesh on one device: a group of one
            distributed.initialize_distributed(
                device_type, init_method=f"tcp://localhost:{distributed.free_port()}",
                world=1, rank_=0)
        owns_group = True
    try:
        return _run_in_group(args)
    finally:
        if owns_group:
            distributed.shutdown()


def _run_in_group(args) -> dict:
    device = (distributed.device_for(args.device) if dist.is_initialized()
              else resolve_device(args.device))
    main_rank = distributed.is_main()
    print(f"Selected Device(s): "
          f"{torch.cuda.get_device_name(device) if device.type == 'cuda' else device}"
          + (f" (rank {distributed.rank()} of {distributed.world_size()})"
             if dist.is_initialized() else ""))

    vocab = Vocab.load(args.vocab_file)
    print(f"Vocabulary loaded from {args.vocab_file}")
    num_classes = args.num_cls + 1  # +1 for UNKNOWN (reference main.py:155)
    if vocab.num_labels > num_classes:
        raise SystemExit(
            f"--num_cls {args.num_cls} is smaller than the vocab's answer set "
            f"({vocab.num_labels - 1} labels + UNKNOWN). Rebuild the vocab with "
            f"-K {args.num_cls} or pass --num_cls {vocab.num_labels - 1}.")
    model, cfg = build_model(
        args.model, vocab.size, num_classes, device=device, vgg_trainable=args.vgg_train,
        opt_lvl=args.opt_lvl, use_pallas=args.use_pallas,
        int8_backbone={"auto": None, "true": True, "false": False}[args.int8_backbone],
        hpack_pool=args.hpack_pool, fused_stem=args.fused_stem,
        int8_handoff=args.int8_handoff,
        int8_stages_override=(None if args.int8_stages == "auto" else
                              tuple(int(i) for i in args.int8_stages.split(",") if i)),
        max_seq_length=vocab.max_seq_length,
        generator=torch.Generator().manual_seed(args.seed))
    image_size = args.image_size or cfg.image_size
    host_size = args.host_size or image_size
    preprocess = make_image_preprocessor(image_size, compute_dtype_for_opt_lvl(args.opt_lvl),
                                         device)
    log_dir = os.path.join(args.expt_dir, args.expt_name, args.run_name)
    if main_rank:
        os.makedirs(log_dir, exist_ok=True)

    mesh = None
    if mesh_requested(args):
        from .parallel.mesh import get_mesh
        mesh = get_mesh(None if args.num_devices == 1 else args.num_devices,
                        model_parallel=args.model_parallel, device_type=device.type)
        if args.seq_parallel:
            model.act_mesh = mesh
        if main_rank:
            print(f"device mesh: {dict(zip(mesh.mesh_dim_names, mesh.shape))}"
                  + (" (tensor parallel)" if args.model_parallel > 1 else "")
                  + (" (FSDP)" if args.fsdp else ""))
        dist.barrier()                   # rank 0 made the run directory
    shard_index, num_shards = distributed.host_shard()

    def make_loader(samples, shuffle=True, drop_last=True, feature_cache=None,
                    rows=(0, 1), sharded=True):
        return DataLoader(samples, args.batch_size, host_size=host_size, shuffle=shuffle,
                          drop_last=drop_last, num_workers=args.num_workers, seed=args.seed,
                          synthetic_images=args.synthetic_images,
                          decode_backend=args.decode_backend, feature_cache=feature_cache,
                          pin_memory=device.type == "cuda", rows=rows,
                          shard_index=shard_index if sharded else 0,
                          num_shards=num_shards if sharded else 1)

    def samples_of(data_file, img_dir):
        return VQASamples(data_file, img_dir, vocab.word2idx, vocab.label2idx,
                          vocab.max_seq_length)

    if args.mode == "train":
        summary = train(args, model, vocab, preprocess, make_loader, samples_of, log_dir,
                        device, image_size, host_size, mesh)
    else:
        summary = test(args, model, vocab, preprocess, make_loader, samples_of, log_dir,
                       device, mesh)
    from . import _build
    summary["launches"] = {k.symbol: k.launches for k in _build.KERNELS}
    if device.type == "cuda":
        summary["peak_memory_bytes"] = torch.cuda.max_memory_allocated(device)
    return summary


def train(args, model, vocab, preprocess, make_loader, samples_of, log_dir, device,
          image_size: int, host_size: int, mesh=None) -> dict:
    """The training loop of vqa_tpu/main.py:478-773. Returns a summary:
    per-step losses, host-clock train seconds at each sync point and at the
    loop's end (with validation and checkpoint time taken out), eval
    batches run, the train
    loader's decode engine and the feature caches opened (train, val).

    On a mesh every rank runs this loop on its rows: the calibration on the
    same full batches everywhere (rank 0 writes the sidecar), the feature
    cache built by rank 0 and read by all, the state replicated (DDP) or
    sharded (``--model_parallel``, ``--fsdp``), losses and metrics global;
    rank 0 logs and writes the flat checkpoints."""
    if args.cache_features and args.vgg_train:
        raise SystemExit("--cache_features requires a frozen VGG (--vgg_train false)")
    if args.cache_features and args.bn_mode == "batch":
        raise SystemExit("--cache_features requires running-stats BN: batch-stats "
                         "features depend on the batch and cannot be cached "
                         "(--bn_mode auto|running)")
    main_rank = distributed.is_main()
    model_sharded = mesh is not None and (args.model_parallel > 1 or args.fsdp)
    if model_sharded and distributed.host_shard()[1] > 1 and args.ckpt_backend == "flax":
        raise SystemExit("multi-host TP/FSDP states are not fully "
                         "addressable: the flax checkpoint backend "
                         "cannot gather them — use --ckpt_backend orbax")
    print(f"Training Log Directory: {log_dir}\n")
    if main_rank:
        writer = make_summary_writer(log_dir)
        log_file = setup_logs_file(vars(args), log_dir)
    else:                   # rank 0 logs and writes TensorBoard
        from .train.logging import _NullWriter
        writer, log_file = _NullWriter(), open(os.devnull, "w")

    train_dataset = samples_of(args.train_file, args.train_img)
    print(f"Question Vocabulary Size: {vocab.size} \n\n")
    print(f"Train Data Size: {len(train_dataset)}")
    val_dataset = val_loader = None
    if args.val_file:
        val_dataset = samples_of(args.val_file, args.val_img)
        print_and_log(f"Validation Data Size: {len(val_dataset)}\n"
                      f"Validation Accuracy is computed using {args.val_size} samples. "
                      f"See --val_size\n", log_file)

    if args.vgg_wts_path:
        _load_vgg_weights(model, args.vgg_wts_path)
        print_and_log(f"Loaded VGG weights from {args.vgg_wts_path}", log_file)
    else:
        print_and_log("NOTE: no --vgg_wts_path given; VGG starts from random init",
                      log_file)

    state = create_train_state(model, args.learning_rate, seed=args.seed)
    ckpt_path = None
    if args.model_ckpt:
        ckpt_path = _resolve_ckpt(args.model_ckpt, log_dir)
        if not ckpt_path.endswith(".orbax"):    # a sharded directory loads once placed
            state = load_any(ckpt_path, state)
            print_and_log(f"Model successfully loaded from {ckpt_path}"
                          "\nResuming Training...", log_file)

    # int8 static scales, after the weights load (they depend on them): the
    # run's int8_calib.json when present, else --int8_calib batches of the
    # epoch-0 order
    if model.int8_stages and args.int8_calib > 0:
        from .train.calibrate import calibrate_model, load_calib
        amax = load_calib(log_dir, model.int8_stages)
        if amax is not None:
            model.int8_amax = amax
            print_and_log("int8 calibration: reusing "
                          f"{os.path.join(log_dir, 'int8_calib.json')}", log_file)
        else:
            # every rank calibrates on the same full batches of the
            # unsharded epoch-0 order: the same scales everywhere, bit for
            # bit, and the world-1 run's
            calib_loader = make_loader(train_dataset, sharded=False)
            calibrate_model(args.model, model, preprocess,
                            _host_images(calib_loader, args.int8_calib),
                            log_dir=log_dir if main_rank else None,
                            log=lambda s: print_and_log(s, log_file))
            calib_loader.close()

    # the feature cache, after the weights load and the calibration, which
    # both change the cached values (vqa_tpu/main.py:555-610)
    image_is_features = bool(args.cache_features)
    train_cache = val_cache = None
    if image_is_features:
        from .data.feature_cache import build_or_open
        encode, fingerprint, boundary = _make_feature_encoder(args.model, model, preprocess)
        cache_root = args.cache_dir or os.path.join(log_dir, "feature_cache")

        def build_cache(samples):
            return build_or_open(
                cache_root, samples, encode, fingerprint=fingerprint, image_size=image_size,
                dtype=model.dtype, boundary=boundary, batch_size=args.batch_size,
                host_size=host_size, num_workers=args.num_workers,
                synthetic_images=args.synthetic_images, decode_backend=args.decode_backend,
                log=lambda s: print_and_log(s, log_file))

        def build_caches():
            return (build_cache(train_dataset),
                    build_cache(val_dataset) if val_dataset is not None else None)

        if mesh is None:
            train_cache, val_cache = build_caches()
        else:               # rank 0 builds; the others then open what it wrote
            if main_rank:
                train_cache, val_cache = build_caches()
            dist.barrier()
            if not main_rank:
                train_cache, val_cache = build_caches()

    rows = (0, 1)
    if mesh is not None:
        from .parallel.mesh import local_rows
        from .train.state import place_on_mesh
        rows = local_rows(mesh, distributed.host_shard()[1])
        state = place_on_mesh(state, mesh, device, tp=args.model_parallel > 1,
                              fsdp=args.fsdp)
    if ckpt_path is not None and ckpt_path.endswith(".orbax"):
        state = load_any(ckpt_path, state)
        print_and_log(f"Model successfully loaded from {ckpt_path}"
                      "\nResuming Training...", log_file)
    train_loader = make_loader(train_dataset, feature_cache=train_cache, rows=rows)
    if val_dataset is not None:
        val_loader = make_loader(val_dataset, feature_cache=val_cache, rows=rows)
    if args.grad_accum > 1 and args.batch_size % args.grad_accum:
        raise SystemExit(f"--grad_accum {args.grad_accum} must divide "
                         f"--batch_size {args.batch_size}")
    train_step = make_train_step(vgg_trainable=args.vgg_train,
                                 bn_batch_stats={"auto": None, "batch": True,
                                                 "running": False}[args.bn_mode],
                                 grad_accum=args.grad_accum,
                                 image_is_features=image_is_features)
    eval_step = make_eval_step(image_is_features=image_is_features)

    steps_per_epoch = len(train_loader)
    curr_step = state.step
    # resume at the exact batch the restored step points at
    train_loader.set_epoch(curr_step // max(steps_per_epoch, 1),
                           skip_batches=curr_step % max(steps_per_epoch, 1))
    eta = ETAEstimator(steps_per_epoch, args.num_epochs, start_step=curr_step)
    timer = SyncedRateTracker(args.batch_size)
    checkpointer = AsyncCheckpointer(backend=args.ckpt_backend)
    profile = ProfileWindow(log_dir, args.profile_steps if main_rank else 0)
    guard = None
    if args.preempt_save:
        from .train.preemption import PreemptionGuard
        guard = PreemptionGuard().install()
    preempted = False

    def prepare_batch(b):
        return device_batch(b, None if image_is_features else preprocess, device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    losses, sync_points = [], []
    eval_batches = 0
    excluded = 0.0          # host seconds in validation, logging and saves
    train_seconds = None    # the whole loop's, once it ends
    t_loop = time.perf_counter()
    span_mark = time.perf_counter_ns()    # host phases since the last log line

    def validate(size):
        nonlocal eval_batches
        model.eval()            # dropout off, as vqa_tpu's eval step (train=False)
        vm = compute_validation_metrics(eval_step, model, iter(val_loader), prepare_batch,
                                        args.batch_size, size, mesh=mesh)
        model.train()
        eval_batches += vm["batches"]
        return vm

    def save(step):
        nonlocal excluded
        sync()
        t0 = time.perf_counter()
        checkpointer.save(state, log_dir, step)
        excluded += time.perf_counter() - t0

    def preempt_now() -> bool:
        """The guard fired on any rank: all of them save at this step."""
        hit = guard is not None and guard.triggered
        if mesh is None:
            return hit
        flag = torch.tensor([float(hit)], device=device)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX)
        return bool(flag.item())

    def preemption_save():
        print_and_log(f"SIGTERM received: saving checkpoint at step {curr_step} to "
                      f"{log_dir} and exiting; resume with --model_ckpt latest", log_file)
        save(curr_step)

    try:
        for epoch in range(args.num_epochs):
            batches = device_prefetch(train_loader, prepare_batch,
                                      depth=args.prefetch_batches)
            for dbatch in batches:
                if profile.before_step(curr_step):
                    print_and_log(f"profiler trace written to {log_dir}", log_file)
                metrics = train_step(state, dbatch)
                losses.append(metrics["loss"])

                if (curr_step + 1) % args.log_interval == 0 or curr_step == 1:
                    loss_val = float(metrics["loss"])   # device sync point
                    timer.mark(curr_step)
                    host_ms = host_phase_ms(span_mark)
                    sync_points.append((curr_step + 1,
                                        time.perf_counter() - t_loop - excluded))
                    t0 = time.perf_counter()
                    if val_loader is not None:
                        vm = validate(args.val_size)
                        print_and_log("Validation Accuracy: {:.2f} %  || Validation Loss: "
                                      "{:.4f}".format(vm["accuracy"], vm["loss"]), log_file)
                        writer.add_scalar("Val/Accuracy", vm["accuracy"], curr_step)
                        writer.add_scalar("Val/Loss", vm["loss"], curr_step)
                    writer.add_scalar("Train/Loss", loss_val, curr_step)
                    writer.add_scalar("Train/QAPairsPerSec", timer.qa_pairs_per_sec, curr_step)
                    for label, ms in host_ms.items():
                        writer.add_scalar(f"Train/HostMs/{label}", ms, curr_step)
                    elapsed, left = eta(curr_step)
                    print_and_log(
                        "Epoch [{}/{}], Step [{}/{}], Loss: {:.4f} | time elapsed: "
                        "{:.2f}h | time left: {:.2f}h | {} | host ms {}".format(
                            epoch + 1, args.num_epochs, curr_step + 1, steps_per_epoch,
                            loss_val, elapsed, left, timer.summary(),
                            " ".join(f"{k} {v:.2f}" for k, v in host_ms.items())), log_file)
                    excluded += time.perf_counter() - t0
                    span_mark = time.perf_counter_ns()

                if (curr_step + 1) % args.save_interval == 0:
                    print(f"Saving the model at the {curr_step + 1} step to "
                          f"directory:{log_dir}")
                    save(curr_step + 1)

                curr_step += 1
                if preempt_now():
                    preemption_save()
                    preempted = True
                    batches.close()     # stops the loader's producer thread
                    break
            if preempted:
                break
            if preempt_now():
                preemption_save()
                preempted = True
                break
            if val_loader is not None:
                sync()
                t0 = time.perf_counter()
                vm = validate(len(val_dataset))
                print_and_log("\nAfter {} epoch:\nValidation Accuracy: {:.2f} %  || "
                              "Validation Loss: {:.4f}\n".format(epoch + 1, vm["accuracy"],
                                                                vm["loss"]), log_file)
                excluded += time.perf_counter() - t0
        sync()
        train_seconds = time.perf_counter() - t_loop - excluded
    except Exception:
        # a SIGTERM to the whole process group can break the loader before
        # the step-boundary poll: the guard's contract is still a checkpoint
        if guard is not None and guard.triggered and not preempted:
            preemption_save()
            preempted = True
        else:
            raise
    finally:
        if profile.close():
            print_and_log(f"profiler trace written to {log_dir}", log_file)
        checkpointer.wait()
        if guard is not None:
            guard.uninstall()
        train_loader.close()
        if val_loader is not None:
            val_loader.close()
        writer.close()
        log_file.close()
    return {"losses": [float(v) for v in losses], "first_step": curr_step - len(losses),
            "steps": len(losses), "sync_points": sync_points, "train_seconds": train_seconds,
            "eval_batches": eval_batches, "preempted": preempted, "log_dir": log_dir,
            "decode_backend": train_loader.decode_backend,
            "feature_caches": [c for c in (train_cache, val_cache) if c is not None]}


def test(args, model, vocab, preprocess, make_loader, samples_of, log_dir, device,
         mesh=None) -> dict:
    """Evaluate ``--model_ckpt`` on ``--val_file`` (vqa_tpu/main.py:776-895).

    On a mesh the weights are replicated and every rank evaluates its block
    of each batch; the last partial batch is padded to a multiple of the
    ``data`` axis (vqa_tpu's ``_pad_to_multiple``) and only its valid rows
    count. Correct counts and loss sums are all-reduced over ``data``, and
    rank 0 writes the predictions in file order."""
    if not args.val_file:
        raise SystemExit("--mode test requires --val_file")
    if args.cache_features:
        print("NOTE: --cache_features is a training-loop feature; test mode "
              "evaluates each image once and ignores it")
    needs_calib = False
    if model.int8_stages:
        from .train.calibrate import load_calib
        amax = load_calib(log_dir, model.int8_stages)
        if amax is not None:
            model.int8_amax = amax
            print(f"int8 calibration: loaded static scales from {log_dir}")
        elif args.int8_calib > 0:
            needs_calib = True
        else:
            print("NOTE: no int8_calib.json in the run dir; int8 stages use "
                  "dynamic per-batch activation scales (batch-dependent)")
    samples = samples_of(args.val_file, args.val_img)
    loader = make_loader(samples, shuffle=False, drop_last=False)

    if args.model_ckpt:
        ckpt_path = _resolve_ckpt(args.model_ckpt, log_dir)
        model.load_state_dict(load_params_only(ckpt_path), strict=True)
        print(f"Model loaded from {ckpt_path}")
    else:
        print("WARNING: no --model_ckpt given; evaluating a randomly initialized model")

    if needs_calib:
        # post-training quantization of a checkpoint trained without int8:
        # calibrate on the eval data, not persisted (the sidecar belongs to
        # the training run)
        from .train.calibrate import calibrate_model
        calib_loader = make_loader(samples, shuffle=False, drop_last=False, sharded=False)
        calibrate_model(args.model, model, preprocess,
                        _host_images(calib_loader, args.int8_calib), log_dir=None)
        calib_loader.close()

    eval_step = make_eval_step()
    model.eval()
    from .parallel.mesh import DATA_AXIS, all_reduce_sum, axis_size, local_rows, row_block
    index, count = local_rows(mesh, distributed.host_shard()[1])
    n_data = axis_size(mesh, DATA_AXIS) if mesh is not None else 1
    num_correct = total = 0
    loss_sum = 0.0
    predictions = []
    try:
        for batch in loader:
            padded, n = _pad_to_multiple(batch, n_data)
            rows = row_block(len(padded["label"]), index, count)
            mine = {k: v[rows] for k, v in padded.items()}
            m = eval_step(model, device_batch(mine, preprocess, device))
            # the rows of this block that are real samples, not padding
            valid = max(0, min(n, rows.stop) - rows.start)
            preds = m["pred"].cpu().numpy()[:valid]
            num_correct += int((preds == np.asarray(mine["label"])[:valid]).sum())
            loss_sum += float(m["loss_per"][:valid].double().sum())
            total += valid
            if args.test_out:
                predictions.append(preds)
    finally:
        loader.close()
    if mesh is not None:
        num_correct, loss_sum, total = all_reduce_sum([num_correct, loss_sum, total], mesh,
                                                      device)
        num_correct, loss_sum, total = int(num_correct), float(loss_sum), int(total)
        if args.test_out:           # every rank's blocks, back in file order
            from .parallel.mesh import data_group
            blocks = [None] * n_data
            dist.all_gather_object(blocks, predictions, group=data_group(mesh))
            predictions = [p for b in range(len(predictions)) for r in range(n_data)
                           for p in blocks[r][b]] if distributed.is_main() else []
    else:
        predictions = [p for b in predictions for p in b]
    predictions = [vocab.idx2label[int(p)] for p in predictions]
    accuracy = 100.0 * num_correct / max(total, 1)
    loss = loss_sum / max(total, 1)
    print(f"Test Accuracy: {accuracy:.2f} %  || Test Loss: {loss:.4f} ({total} samples)")

    if args.test_out and distributed.is_main():
        with open(args.test_out, "w") as f:
            if args.test_out_format == "vqa":
                # question_id = the 0-based line of --val_file (unshuffled,
                # drop_last=False: prediction order is file order)
                json.dump([{"question_id": i, "answer": p}
                           for i, p in enumerate(predictions)], f)
            else:
                for pred in predictions:
                    f.write(pred + "\n")
        print(f"Predictions written to {args.test_out}")
    return {"accuracy": accuracy, "loss": loss, "samples": total}


if __name__ == "__main__":
    main()
