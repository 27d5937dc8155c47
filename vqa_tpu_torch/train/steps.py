"""Train and eval steps (port of vqa_tpu/train/steps.py:22-191).

One train step is forward (under the model's precision policy: bf16
autocast for the head at ``--opt_lvl >= 1``), mean softmax cross-entropy on
fp32 logits (``nn.CrossEntropyLoss``, reference main.py:179,214), backward
and one Adam step on the trainable parameters. The frozen VGG runs in
running-stats mode and without autograd (models/coattention.py).

Not ported yet: ``bn_batch_stats=True`` (the reference's batch-stats quirk,
``--bn_mode batch``), a trainable VGG and ``grad_accum > 1``; each raises.
The feature cache (vqa_tpu's ``image_is_features``) is not ported either.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .state import TrainState


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax CE in fp32 (torch ``CrossEntropyLoss`` reduction)."""
    return F.cross_entropy(logits.float(), labels)


def make_train_step(vgg_trainable: bool = False, bn_batch_stats: bool | None = None,
                    grad_accum: int = 1):
    """Build ``train_step(state, batch) -> {"loss", "accuracy"}`` (0-d
    device tensors, not synced). ``batch`` holds device tensors ``image``
    (preprocessed), ``question``, ``ques_len`` and ``label`` (int64)."""
    if vgg_trainable or bn_batch_stats:
        raise NotImplementedError("batch-stats BatchNorm and a trainable VGG are not "
                                  "ported yet (ROADMAP.md queue 1 item 2)")
    if grad_accum > 1:
        raise NotImplementedError("grad_accum > 1 is not ported yet "
                                  "(ROADMAP.md queue 1 item 4)")

    def train_step(state: TrainState, batch: dict) -> dict:
        logits = state.model(batch["image"], batch["question"], batch["ques_len"])
        loss = cross_entropy_loss(logits, batch["label"])
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        state.optimizer.step()
        state.step += 1
        accuracy = (logits.detach().argmax(dim=-1) == batch["label"]).float().mean()
        return {"loss": loss.detach(), "accuracy": accuracy}

    return train_step


def make_eval_step():
    """Build ``eval_step(model, batch)`` -> per-batch metrics: argmax
    correct count, mean CE, per-sample CE (so callers can weight out
    padding rows) and the predictions (reference main.py:301-335)."""

    @torch.no_grad()
    def eval_step(model, batch: dict) -> dict:
        logits = model(batch["image"], batch["question"], batch["ques_len"])
        pred = logits.argmax(dim=-1)
        loss_per = F.cross_entropy(logits.float(), batch["label"], reduction="none")
        return {"num_correct": (pred == batch["label"]).sum(),
                "loss": loss_per.mean(), "loss_per": loss_per, "pred": pred}

    return eval_step


def compute_validation_metrics(eval_step, model, val_iter, prepare_batch,
                               batch_size: int, size: int) -> dict:
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
    num_correct = sum(int(c) for c, _ in per_batch)
    loss = 0.0
    for _, b_loss in per_batch:
        loss += float(b_loss)
    total = n_iters * batch_size
    return {"accuracy": 100.0 * num_correct / max(total, 1),
            "loss": loss / max(n_iters, 1), "batches": len(per_batch)}
