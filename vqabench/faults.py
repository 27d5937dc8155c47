"""Faults planted in the timed path, to show that the check catches them.

Each takes ``patch(obj, name, value)`` (``setattr``, or pytest's
``monkeypatch.setattr``) and breaks the program underneath the harness:

- ``unchanged_state``: each train step runs the forward and the loss, and
  leaves the model and the optimizer as they were;
- ``half_batch``: each train step trains on the first half of its batch,
  the mean taken over that half;
- ``answer_altered``: the first answer of every served batch comes out with
  its classes' probabilities reversed.

No cell runs across chips, so none can lose an exchange between them.
"""

from __future__ import annotations

import torch


def unchanged_state(patch) -> None:
    from vqa_tpu_torch.train import steps

    def factory(*args, **kwargs):
        def step(state, batch):
            with torch.no_grad():
                logits = state.model(batch["image"], batch["question"], batch["ques_len"])
                loss = steps.cross_entropy_loss(logits, batch["label"])
            return {"loss": loss, "accuracy": loss}
        return step
    patch(steps, "make_train_step", factory)


def half_batch(patch) -> None:
    from vqa_tpu_torch.train import steps
    real = steps.make_train_step

    def factory(*args, **kwargs):
        inner = real(*args, **kwargs)

        def step(state, batch):
            n = batch["label"].shape[0] // 2
            return inner(state, {k: v[:n] for k, v in batch.items()})
        return step
    patch(steps, "make_train_step", factory)


def answer_altered(patch) -> None:
    from vqa_tpu_torch.serve import VQAPredictor
    real = VQAPredictor._probs

    def probs(self, images, ids, lens):
        out = real(self, images, ids, lens).copy()
        out[0] = out[0][::-1]
        return out
    patch(VQAPredictor, "_probs", probs)


TRAIN = (unchanged_state, half_batch)
SERVE = (answer_altered,)
