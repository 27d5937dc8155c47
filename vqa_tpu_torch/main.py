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
C and conv1-7 ``F.conv2d``.

Not ported yet, each raising with its ROADMAP.md queue item:
``--num_devices > 1``, ``--model_parallel``, ``--fsdp``, ``--seq_parallel``,
``--force_mesh``, ``--cache_features``, ``--ckpt_backend orbax``,
``--profile_steps``, ``--vgg_train true``, ``--bn_mode batch``,
``--grad_accum > 1`` and the native decoders.
``--gpu_id`` is accepted and ignored, as in vqa_tpu.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from .config import (build_model, compute_dtype_for_opt_lvl, int_min_two,
                     resolve_device, str2bool)
from .data.dataset import VQASamples
from .data.pipeline import DataLoader, device_batch, device_prefetch, make_image_preprocessor
from .models.vgg import VGG11HeadEncoder
from .train.checkpoint import (AsyncCheckpointer, latest_checkpoint, load_any,
                               load_params_only)
from .train.logging import ETAEstimator, make_summary_writer, print_and_log, setup_logs_file
from .train.profiling import SyncedRateTracker
from .train.state import create_train_state
from .train.steps import compute_validation_metrics, make_eval_step, make_train_step
from .vocab import Vocab


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
    add("--vgg_train", type=str2bool, default="false", help="train the VGG (not ported yet)")
    # device (main.py:72-73)
    add("--gpu_id", type=int, default=0, help="accepted for script compatibility, ignored")
    add("--opt_lvl", type=int, default=1, choices=[0, 1, 2, 3],
        help="precision: 0 = fp32, 1-3 = bf16 compute with fp32 params")
    add("--device", type=str, default="cuda",
        help="torch device; 'cuda' (the default) fails without a card")
    # input pipeline (main.py:76)
    add("--num_workers", type=int, default=6, help="host image-decode threads")
    add("--decode_backend", type=str, default="auto",
        choices=["auto", "native", "pil", "native_mp"],
        help="host decode engine: auto = pil here (native, native_mp: not ported yet)")
    # vqa_tpu extensions
    add("--num_devices", type=int, default=1, help="data-parallel devices (not ported yet)")
    add("--model_parallel", type=int, default=1, help="tensor-parallel ways (not ported yet)")
    add("--fsdp", type=str2bool, default="false", help="not ported yet")
    add("--ckpt_backend", type=str, default="flax", choices=["flax", "orbax"],
        help="'flax' = one model_<step>.ckpt file (here a torch.save); orbax: not ported yet")
    add("--grad_accum", type=int, default=1, help="microbatches per step (not ported yet)")
    add("--seq_parallel", type=str2bool, default="false", help="not ported yet")
    add("--preempt_save", type=str2bool, default="true",
        help="on SIGTERM, save a checkpoint at the next step boundary and exit")
    add("--force_mesh", type=str2bool, default="false", help="not ported yet")
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
    add("--profile_steps", type=int, default=0, help="not ported yet")
    add("--bn_mode", type=str, default="auto", choices=["auto", "batch", "running"],
        help="frozen-VGG BatchNorm in training: auto/running = running stats "
             "(batch: not ported yet)")
    add("--prefetch_batches", type=int, default=2,
        help="device batches enqueued ahead of the train step (<=1 disables)")
    add("--cache_features", type=str2bool, default="false", help="not ported yet")
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
    add("--cache_dir", type=str, default="", help="feature-cache root (not ported yet)")
    return parser


def _reject_unported(args) -> None:
    """Flags whose vqa_tpu behaviour the port does not have yet raise."""
    checks = [
        (args.num_devices > 1, "--num_devices > 1", 8),
        (args.model_parallel > 1, "--model_parallel", 8),
        (args.fsdp, "--fsdp", 8),
        (args.seq_parallel, "--seq_parallel", 8),
        (args.force_mesh, "--force_mesh", 8),
        (args.cache_features, "--cache_features", 6),
        (args.ckpt_backend == "orbax", "--ckpt_backend orbax", 4),
        (args.profile_steps > 0, "--profile_steps", 4),
        (args.grad_accum > 1, "--grad_accum > 1", 4),
        (args.vgg_train, "--vgg_train true", 2),
        (args.bn_mode == "batch", "--bn_mode batch", 2),
        (args.decode_backend in ("native", "native_mp"),
         f"--decode_backend {args.decode_backend}", 3),
    ]
    for bad, flag, item in checks:
        if bad:
            raise NotImplementedError(f"{flag} is not ported yet (ROADMAP.md queue 1 "
                                      f"item {item})")


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
    """Run ``--mode train`` or ``--mode test``; returns that mode's summary dict."""
    parser = build_parser()
    args = parser.parse_args(argv)
    _reject_unported(args)
    device = resolve_device(args.device)
    print(f"Selected Device(s): "
          f"{torch.cuda.get_device_name(device) if device.type == 'cuda' else device}")

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
    os.makedirs(log_dir, exist_ok=True)

    def make_loader(samples, shuffle=True, drop_last=True):
        return DataLoader(samples, args.batch_size, host_size=host_size, shuffle=shuffle,
                          drop_last=drop_last, num_workers=args.num_workers, seed=args.seed,
                          synthetic_images=args.synthetic_images,
                          decode_backend=args.decode_backend,
                          pin_memory=device.type == "cuda")

    def samples_of(data_file, img_dir):
        return VQASamples(data_file, img_dir, vocab.word2idx, vocab.label2idx,
                          vocab.max_seq_length)

    if args.mode == "train":
        return train(args, model, vocab, preprocess, make_loader, samples_of, log_dir, device)
    return test(args, model, vocab, preprocess, make_loader, samples_of, log_dir, device)


def train(args, model, vocab, preprocess, make_loader, samples_of, log_dir, device) -> dict:
    """The training loop of vqa_tpu/main.py:478-773. Returns a summary:
    per-step losses, host-clock train seconds at each sync point (with
    validation and checkpoint time taken out), eval batches run."""
    print(f"Training Log Directory: {log_dir}\n")
    writer = make_summary_writer(log_dir)
    log_file = setup_logs_file(vars(args), log_dir)

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
    if args.model_ckpt:
        ckpt_path = _resolve_ckpt(args.model_ckpt, log_dir)
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
            calib_loader = make_loader(train_dataset)
            calibrate_model(args.model, model, preprocess,
                            _host_images(calib_loader, args.int8_calib), log_dir=log_dir,
                            log=lambda s: print_and_log(s, log_file))
            calib_loader.close()

    train_loader = make_loader(train_dataset)
    if val_dataset is not None:
        val_loader = make_loader(val_dataset)
    train_step = make_train_step(vgg_trainable=args.vgg_train,
                                 bn_batch_stats={"auto": None, "batch": True,
                                                 "running": False}[args.bn_mode],
                                 grad_accum=args.grad_accum)
    eval_step = make_eval_step()

    steps_per_epoch = len(train_loader)
    curr_step = state.step
    # resume at the exact batch the restored step points at
    train_loader.set_epoch(curr_step // max(steps_per_epoch, 1),
                           skip_batches=curr_step % max(steps_per_epoch, 1))
    eta = ETAEstimator(steps_per_epoch, args.num_epochs, start_step=curr_step)
    timer = SyncedRateTracker(args.batch_size)
    checkpointer = AsyncCheckpointer()
    guard = None
    if args.preempt_save:
        from .train.preemption import PreemptionGuard
        guard = PreemptionGuard().install()
    preempted = False

    def prepare_batch(b):
        return device_batch(b, preprocess, device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    losses, sync_points = [], []
    eval_batches = 0
    excluded = 0.0          # host seconds in validation, logging and saves
    t_loop = time.perf_counter()

    def validate(size):
        nonlocal eval_batches
        model.eval()            # dropout off, as vqa_tpu's eval step (train=False)
        vm = compute_validation_metrics(eval_step, model, iter(val_loader), prepare_batch,
                                        args.batch_size, size)
        model.train()
        eval_batches += vm["batches"]
        return vm

    def save(step):
        nonlocal excluded
        sync()
        t0 = time.perf_counter()
        checkpointer.save(state, log_dir, step)
        excluded += time.perf_counter() - t0

    def preemption_save():
        print_and_log(f"SIGTERM received: saving checkpoint at step {curr_step} to "
                      f"{log_dir} and exiting; resume with --model_ckpt latest", log_file)
        save(curr_step)

    try:
        for epoch in range(args.num_epochs):
            batches = device_prefetch(train_loader, prepare_batch,
                                      depth=args.prefetch_batches)
            for dbatch in batches:
                metrics = train_step(state, dbatch)
                losses.append(metrics["loss"])

                if (curr_step + 1) % args.log_interval == 0 or curr_step == 1:
                    loss_val = float(metrics["loss"])   # device sync point
                    timer.mark(curr_step)
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
                    elapsed, left = eta(curr_step)
                    print_and_log(
                        "Epoch [{}/{}], Step [{}/{}], Loss: {:.4f} | time elapsed: "
                        "{:.2f}h | time left: {:.2f}h | {}".format(
                            epoch + 1, args.num_epochs, curr_step + 1, steps_per_epoch,
                            loss_val, elapsed, left, timer.summary()), log_file)
                    excluded += time.perf_counter() - t0

                if (curr_step + 1) % args.save_interval == 0:
                    print(f"Saving the model at the {curr_step + 1} step to "
                          f"directory:{log_dir}")
                    save(curr_step + 1)

                curr_step += 1
                if guard is not None and guard.triggered:
                    preemption_save()
                    preempted = True
                    batches.close()     # stops the loader's producer thread
                    break
            if preempted:
                break
            if guard is not None and guard.triggered:
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
    except Exception:
        # a SIGTERM to the whole process group can break the loader before
        # the step-boundary poll: the guard's contract is still a checkpoint
        if guard is not None and guard.triggered and not preempted:
            preemption_save()
            preempted = True
        else:
            raise
    finally:
        checkpointer.wait()
        if guard is not None:
            guard.uninstall()
        train_loader.close()
        if val_loader is not None:
            val_loader.close()
        writer.close()
        log_file.close()
    return {"losses": [float(v) for v in losses], "first_step": curr_step - len(losses),
            "steps": len(losses), "sync_points": sync_points,
            "eval_batches": eval_batches, "preempted": preempted, "log_dir": log_dir}


def test(args, model, vocab, preprocess, make_loader, samples_of, log_dir, device) -> dict:
    """Evaluate ``--model_ckpt`` on ``--val_file`` (vqa_tpu/main.py:776-895)."""
    if not args.val_file:
        raise SystemExit("--mode test requires --val_file")
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
        calib_loader = make_loader(samples, shuffle=False, drop_last=False)
        calibrate_model(args.model, model, preprocess,
                        _host_images(calib_loader, args.int8_calib), log_dir=None)
        calib_loader.close()

    eval_step = make_eval_step()
    model.eval()
    num_correct = total = 0
    loss_sum = 0.0
    predictions = []
    try:
        for batch in loader:
            m = eval_step(model, device_batch(batch, preprocess, device))
            preds = m["pred"].cpu().numpy()
            num_correct += int((preds == np.asarray(batch["label"])).sum())
            loss_sum += float(m["loss_per"].double().sum())
            total += len(preds)
            if args.test_out:
                predictions.extend(vocab.idx2label[int(p)] for p in preds)
    finally:
        loader.close()
    accuracy = 100.0 * num_correct / max(total, 1)
    loss = loss_sum / max(total, 1)
    print(f"Test Accuracy: {accuracy:.2f} %  || Test Loss: {loss:.4f} ({total} samples)")

    if args.test_out:
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
