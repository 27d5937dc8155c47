"""Training state and optimizer (port of vqa_tpu/train/state.py).

The JAX package keeps the whole training state in one pytree (params,
batch_stats, opt_state, step, rng) so checkpoints resume exactly. Here the
state is :class:`TrainState`: the model (parameters and BatchNorm buffers),
the Adam optimizer, the step counter and an explicit ``torch.Generator``,
all of which ``train.checkpoint`` saves and restores.

Adam has the reference's torch defaults (``torch.optim.Adam(lr)``: b1 0.9,
b2 0.999, eps 1e-8) and covers the parameters that require a gradient:
all of them when the VGG trains (``--vgg_train true``), else all but the
frozen VGG's (and its classifier head's), the counterpart of vqa_tpu's
``set_to_zero`` label for ``*/vgg11_encoder`` (state.py:48-55).

The generator lives on the model's device and is the one every dropout of
the model draws its masks from (``models.layers.set_dropout_generator``):
the baseline and bert models' three, vqa_tpu's ``dropout`` rng stream. The
checkpoint saves its state, so a resumed run draws the masks the
uninterrupted run would have drawn.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from ..models.layers import set_dropout_generator, set_dropout_rows


@dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int
    generator: torch.Generator
    # on a device mesh (``place_on_mesh``): the module the train step calls
    # (``DistributedDataParallel`` over ``model``, or ``model`` itself once
    # sharded), the mesh, and the data-replicated parameters whose gradients
    # the step averages by hand (``parallel.sharding.all_reduce_grads``)
    runner: torch.nn.Module | None = None
    mesh: object = None
    replicated: list = field(default_factory=list)


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


def place_on_mesh(state: TrainState, mesh, device: torch.device, *, tp: bool = False,
                  fsdp: bool = False) -> TrainState:
    """Put ``state`` on ``mesh`` (vqa_tpu's ``replicate_to_mesh`` /
    ``shard_state_to_mesh``): ``DistributedDataParallel`` when neither ``tp``
    nor ``fsdp``, else the TP/FSDP placement of ``parallel.sharding`` with a
    new optimizer over the sharded parameters that takes over the old one's
    state (Adam's moments in their parameter's placement). Every dropout
    keeps this rank's rows of the global batch's mask, and batch-stats
    BatchNorm reduces over ``data``."""
    from ..models.vgg import VGGFeatures
    from ..parallel.mesh import DATA_AXIS, axis_size, data_group, data_index, \
        replicate_to_mesh
    from ..parallel.sharding import shard_model

    n_data = axis_size(mesh, DATA_AXIS)
    set_dropout_rows(state.model, data_index(mesh), n_data)
    for m in state.model.modules():
        if isinstance(m, VGGFeatures):
            m.stats_group = data_group(mesh) if n_data > 1 else None
    state.mesh = mesh
    if not (tp or fsdp):
        state.runner = replicate_to_mesh(state.model, mesh, device)
        return state
    names = {id(p): n for n, p in state.model.named_parameters()}
    old = {names[id(p)]: state.optimizer.state.get(p, {})
           for g in state.optimizer.param_groups for p in g["params"]}
    lr = state.optimizer.param_groups[0]["lr"]
    state.replicated = shard_model(state.model, mesh, tp=tp, fsdp=fsdp)
    state.optimizer = make_optimizer(lr, state.model)
    by_name = dict(state.model.named_parameters())
    for name, st in old.items():
        p = by_name[name]
        state.optimizer.state[p] = {k: like_param(v, p) for k, v in st.items()}
    state.runner = state.model
    return state


def like_param(value, p):
    """A full optimizer-state tensor in the placement of parameter ``p`` (a
    ``DTensor``'s local shard, cut locally: every rank holds the full value)."""
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(value, torch.Tensor) or value.dim() == 0 or not isinstance(p, DTensor):
        return value
    mesh = p.device_mesh
    full = DTensor.from_local(value.to(p.device, p.dtype), mesh,
                              [Replicate()] * mesh.ndim, run_check=False)
    return full.redistribute(mesh, p.placements)
