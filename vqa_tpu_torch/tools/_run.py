"""What the port's run tools share: the device rule, bench.py's sizes, a
seeded int8 calibration and a full-width step on random data."""

from __future__ import annotations

import numpy as np
import torch

from ._probe import card_line

# bench.py's full-width sizes: vocabulary, question length, answer classes
VOCAB_WORDS, SEQ_LEN, NUM_CLASSES = 10000, 23, 1001


def device_and_card(device: str) -> tuple[torch.device, str]:
    """The tool's device and what to print beside its numbers: the card's
    name and power limit, or "cpu". ``cuda`` without a card exits."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev, "cpu (no device numbers)"
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this tool runs on the card (pass --device cpu "
                         "to rehearse it on the CPU)")
    return dev, card_line()


def calibrate_on_random_images(model_name: str, model, preprocess, image_size: int,
                               n: int = 8, seed: int = 0) -> None:
    """Static int8 scales from ``n`` seeded random images (a zero image would
    floor every per-channel amax at 1e-12); no-op without int8 stages."""
    from ..train.calibrate import calibrate_model

    images = np.random.default_rng(seed).integers(0, 256, (n, image_size, image_size, 3),
                                                  dtype=np.uint8)
    calibrate_model(model_name, model, preprocess, [images], log=lambda s: None)


def full_width_model(model_name: str, image_size: int, device: torch.device,
                     int8_backbone: bool | None = None):
    """The model at full width and ``--opt_lvl 1`` (seed 0), its int8 stages,
    if any, calibrated by :func:`calibrate_on_random_images`."""
    from ..config import build_model, compute_dtype_for_opt_lvl
    from ..data.pipeline import make_image_preprocessor

    model, _ = build_model(model_name, VOCAB_WORDS, NUM_CLASSES, device=device, opt_lvl=1,
                           int8_backbone=int8_backbone, max_seq_length=SEQ_LEN,
                           generator=torch.Generator().manual_seed(0))
    calibrate_on_random_images(model_name, model, make_image_preprocessor(
        image_size, compute_dtype_for_opt_lvl(1), device), image_size)
    return model


def full_width_step(model_name: str, image_size: int, batch: int, mode: str,
                    device: torch.device, int8_backbone: bool | None = None):
    """(model, step): :func:`full_width_model` and a closure that runs one
    ``train`` step (forward, backward, Adam) or ``eval`` step on a seeded
    random batch and returns its loss tensor."""
    from ..train.state import create_train_state
    from ..train.steps import make_eval_step, make_train_step

    model = full_width_model(model_name, image_size, device, int8_backbone)
    g = torch.Generator(device=device).manual_seed(0)
    batch_d = {
        "image": torch.randn((batch, image_size, image_size, 3), generator=g,
                             device=device).to(model.dtype),
        "question": torch.randint(1, VOCAB_WORDS, (batch, SEQ_LEN), generator=g, device=device),
        "ques_len": torch.full((batch,), SEQ_LEN, dtype=torch.long, device=device),
        "label": torch.randint(0, NUM_CLASSES, (batch,), generator=g, device=device)}
    if mode == "eval":
        model.eval()
        eval_step = make_eval_step()
        return model, lambda: eval_step(model, batch_d)["loss"]
    state = create_train_state(model, 1e-4)
    train_step = make_train_step()
    return model, lambda: train_step(state, batch_d)["loss"]


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
