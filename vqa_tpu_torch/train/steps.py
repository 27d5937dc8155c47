"""Train and eval steps (port of vqa_tpu/train/steps.py:22-191).

One train step is forward (under the model's precision policy: bf16
autocast for the head at ``--opt_lvl >= 1``), mean softmax cross-entropy on
fp32 logits (``nn.CrossEntropyLoss``, reference main.py:179,214), backward
and one Adam step on the trainable parameters. The step puts the model in
train mode, so the baseline and bert models' dropouts (the VGG head's
included) are live; callers evaluate in eval mode, where BatchNorm always
uses the running stats.

BatchNorm in training follows vqa_tpu's policy (steps.py:62): batch
statistics when the VGG trains, running stats when it is frozen, unless
``bn_batch_stats`` says otherwise (``--bn_mode batch`` is the reference's
batch-stats quirk on a frozen VGG). Batch statistics bypass the int8 stages
and every kernel (``models.vgg``).

``grad_accum > 1`` splits the batch into equal microbatches, each a forward
and backward with its own dropout masks from the state's generator; the
gradients are summed and divided by ``grad_accum``, loss and accuracy are
the means of the microbatch means, and one Adam step follows (steps.py:
95-124). It needs running-stats BatchNorm.

On a device mesh (``TrainState.runner``, ``state.mesh``; vqa_tpu's GSPMD
step) the step calls the DDP- or TP/FSDP-wrapped model on this rank's rows;
the gradients are averaged over ``data`` once a step (DDP's ``no_sync`` and
FSDP2's ``set_requires_gradient_sync`` hold the microbatches' back under
``grad_accum``), and the returned loss and accuracy are the global batch's
means, all-reduced over ``data``.

``image_is_features`` (vqa_tpu's, steps.py:30,70,144-155): ``batch["image"]``
holds a feature cache's rows (``data.feature_cache``), so the step skips the
cached part of the frozen tower (``VQANet.forward``); a cached tower is
frozen with running statistics, so it does not combine with batch stats.

Models with routed experts (``kimi_vl``) define ``balance_loss()``, the
balance loss of the forward just run, which the step adds to the
cross-entropy before the backward (the step's ``loss`` stays the
cross-entropy), and ``update_router_bias()``, a step of the router's
selection bias without a gradient, which the step calls after Adam's. The
other models define neither, and their steps launch what they did before.

The host time of each phase goes to ``train.profiling``'s span log:
``vqa.train.step`` around a call, ``vqa.train.forward`` (the model and the
loss) and ``vqa.train.backward`` once a microbatch, ``vqa.train.optimizer``
around Adam's step.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from ..parallel.sharding import all_reduce_grads, head_context
from .profiling import span
from .state import TrainState


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax CE in fp32 (torch ``CrossEntropyLoss`` reduction)."""
    return F.cross_entropy(logits.float(), labels)


def make_train_step(vgg_trainable: bool = False, bn_batch_stats: bool | None = None,
                    grad_accum: int = 1, image_is_features: bool = False):
    """Build ``train_step(state, batch) -> {"loss", "accuracy"}`` (0-d
    device tensors, not synced). ``batch`` holds device tensors ``image``
    (preprocessed, or cached features with ``image_is_features``),
    ``question``, ``ques_len`` and ``label`` (int64)."""
    use_batch_stats_bn = vgg_trainable if bn_batch_stats is None else bn_batch_stats
    if grad_accum > 1 and use_batch_stats_bn:
        raise ValueError("grad_accum requires running-stats BN "
                         "(per-microbatch stat updates change semantics)")
    if image_is_features and use_batch_stats_bn:
        raise ValueError("cached features come from a frozen running-stats tower")

    def forward_backward(state, runner, batch):
        balance = getattr(state.model, "balance_loss", None)
        with span("vqa.train.forward"):
            logits = runner(batch["image"], batch["question"], batch["ques_len"],
                            use_running_stats=not use_batch_stats_bn,
                            image_is_features=image_is_features)
            loss = cross_entropy_loss(logits, batch["label"])
            aux = None if balance is None else balance()
        # backward of the DTensor head; the autograd engine launches the
        # backward's kernels from its own device thread while this span is open
        with span("vqa.train.backward"), head_context(state.model.tp_active):
            (loss if aux is None else loss + aux).backward()
        accuracy = (logits.detach().argmax(dim=-1) == batch["label"]).float().mean()
        return loss.detach(), accuracy

    def train_step(state: TrainState, batch: dict) -> dict:
        with span("vqa.train.step"):
            return _train_step(state, batch)

    def _train_step(state: TrainState, batch: dict) -> dict:
        runner = state.runner or state.model
        runner.train()
        state.optimizer.zero_grad(set_to_none=True)
        if grad_accum == 1:
            loss, accuracy = forward_backward(state, runner, batch)
        else:
            n = batch["label"].shape[0]
            if n % grad_accum:
                raise ValueError(f"grad_accum={grad_accum} must divide the batch size {n}")
            m = n // grad_accum
            loss = accuracy = 0.0
            for i in range(grad_accum):
                # one gradient reduction a step: after the last microbatch
                with _gradient_sync(state, i == grad_accum - 1):
                    mb_loss, mb_acc = forward_backward(
                        state, runner, {k: v[i * m:(i + 1) * m] for k, v in batch.items()})
                loss, accuracy = loss + mb_loss, accuracy + mb_acc
        all_reduce_grads(state.replicated, state.mesh)
        if grad_accum > 1:
            for group in state.optimizer.param_groups:
                for p in group["params"]:
                    if p.grad is not None:
                        p.grad.div_(grad_accum)
            loss, accuracy = loss / grad_accum, accuracy / grad_accum
        with span("vqa.train.optimizer"):
            state.optimizer.step()
            update_bias = getattr(state.model, "update_router_bias", None)
            if update_bias is not None:
                update_bias()
        state.step += 1
        if state.mesh is not None:      # the global batch's means, as vqa_tpu's metrics
            loss, accuracy = data_mean(torch.stack([loss, accuracy]), state.mesh)
        return {"loss": loss, "accuracy": accuracy}

    return train_step


@contextlib.contextmanager
def _gradient_sync(state: TrainState, sync: bool):
    """Hold back the data-parallel gradient reduction of a microbatch's
    backward unless ``sync`` (DDP's ``no_sync``; FSDP2's
    ``set_requires_gradient_sync``)."""
    from torch.nn.parallel import DistributedDataParallel

    if sync or state.mesh is None:
        yield
        return
    if isinstance(state.runner, DistributedDataParallel):
        with state.runner.no_sync():
            yield
        return
    fsdp = [m for m in state.model.modules() if hasattr(m, "set_requires_gradient_sync")]
    for m in fsdp:
        m.set_requires_gradient_sync(False)
    try:
        yield
    finally:
        for m in fsdp:
            m.set_requires_gradient_sync(True)


def data_mean(values: torch.Tensor, mesh) -> torch.Tensor:
    """The mean over ``data`` of each rank's values (equal blocks: the
    global batch's mean)."""
    from ..parallel.mesh import DATA_AXIS, axis_size, data_group

    n = axis_size(mesh, DATA_AXIS)
    if n > 1:
        values = values.clone()
        torch.distributed.all_reduce(values, group=data_group(mesh))
        values /= n
    return values


def make_eval_step(image_is_features: bool = False):
    """Build ``eval_step(model, batch)`` -> per-batch metrics: argmax
    correct count, mean CE, per-sample CE (so callers can weight out
    padding rows) and the predictions (reference main.py:301-335)."""

    # the plain call unless the batch holds cached features
    kwargs = {"image_is_features": True} if image_is_features else {}

    @torch.no_grad()
    def eval_step(model, batch: dict) -> dict:
        logits = model(batch["image"], batch["question"], batch["ques_len"], **kwargs)
        pred = logits.argmax(dim=-1)
        loss_per = F.cross_entropy(logits.float(), batch["label"], reduction="none")
        return {"num_correct": (pred == batch["label"]).sum(),
                "loss": loss_per.mean(), "loss_per": loss_per, "pred": pred}

    return eval_step


def compute_validation_metrics(eval_step, model, val_iter, prepare_batch,
                               batch_size: int, size: int, mesh=None) -> dict:
    """Accuracy + loss over ``size`` validation samples, with the
    reference's metric definition (main.py:290-351) and its off-by-one: the
    loop breaks *after* batch ``n_iters``, so ``n_iters + 1`` batches
    contribute while the totals divide by ``n_iters``.

    The per-batch values stay on the device until the loop ends and are
    then summed in order as Python numbers, as vqa_tpu sums them.
    """
    n_iters = size // batch_size
    per_batch = []
    for i, batch in enumerate(val_iter):
        m = eval_step(model, prepare_batch(batch))
        per_batch.append((m["num_correct"], m["loss"]))
        if i >= n_iters:
            break
    if mesh is not None and per_batch:
        # every rank holds a block of each batch: the global correct counts
        # and batch means (equal blocks)
        from ..parallel.mesh import DATA_AXIS, axis_size, data_group
        t = torch.stack([torch.stack([c.double(), b.double()]) for c, b in per_batch])
        if axis_size(mesh, DATA_AXIS) > 1:
            torch.distributed.all_reduce(t, group=data_group(mesh))
            t[:, 1] /= axis_size(mesh, DATA_AXIS)
        per_batch = [(c, b) for c, b in t.cpu().unbind(0)]
    num_correct = sum(int(c) for c, _ in per_batch)
    loss = 0.0
    for _, b_loss in per_batch:
        loss += float(b_loss)
    total = n_iters * batch_size
    return {"accuracy": 100.0 * num_correct / max(total, 1),
            "loss": loss / max(n_iters, 1), "batches": len(per_batch)}
