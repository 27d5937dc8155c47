"""Training state and optimizer (port of vqa_tpu/train/state.py).

The JAX package keeps the whole training state in one pytree (params,
batch_stats, opt_state, step, rng) so checkpoints resume exactly. Here the
state is :class:`TrainState`: the model (parameters and BatchNorm buffers),
the Adam optimizer, the step counter and an explicit ``torch.Generator``,
all of which ``train.checkpoint`` saves and restores.

Adam has the reference's torch defaults (``torch.optim.Adam(lr)``: b1 0.9,
b2 0.999, eps 1e-8) and covers the parameters that require a gradient
only: the frozen VGG's (and its classifier head's) are left out, the
counterpart of vqa_tpu's ``set_to_zero`` label for ``*/vgg11_encoder``
(state.py:48-55).

The generator lives on the model's device and is the one every dropout of
the model draws its masks from (``models.layers.set_dropout_generator``):
the baseline and bert models' three, vqa_tpu's ``dropout`` rng stream. The
checkpoint saves its state, so a resumed run draws the masks the
uninterrupted run would have drawn.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..models.layers import set_dropout_generator


@dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int
    generator: torch.Generator


def make_optimizer(learning_rate: float, model: torch.nn.Module) -> torch.optim.Adam:
    """Adam with torch-default hyperparameters over the trainable parameters."""
    params = [p for p in model.parameters() if p.requires_grad]
    return torch.optim.Adam(params, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)


def create_train_state(model: torch.nn.Module, learning_rate: float,
                       seed: int = 0) -> TrainState:
    """Wrap an initialized model with a fresh optimizer, step 0 and a
    generator on the model's device seeded from ``seed``, which the model's
    dropouts then draw from (the attention model has none)."""
    device = next(model.parameters()).device
    generator = torch.Generator(device=device).manual_seed(seed)
    set_dropout_generator(model, generator)
    return TrainState(model=model, optimizer=make_optimizer(learning_rate, model),
                      step=0, generator=generator)
