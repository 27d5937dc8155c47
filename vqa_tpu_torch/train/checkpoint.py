"""Full-state checkpoints with ``model_<step>.ckpt`` naming (port of
vqa_tpu/train/checkpoint.py).

A checkpoint is the whole :class:`~.state.TrainState`: the model's state
dict (reference names, so its ``model`` entry is also a reference ``.pth``
body), the Adam state, the step and the state's generator, written with
``torch.save`` to a temporary file and renamed into place, so a crash never
leaves a torn file. ``--model_ckpt`` resume from it is exact. The int8
calibration of a run lives beside its checkpoints as ``int8_calib.json``
(``train.calibrate``). Saves are synchronous (:class:`AsyncCheckpointer`
keeps vqa_tpu's interface and waits for each write).

``load_any`` also takes a ``.pth`` (weights only: the optimizer, step and
generator stay fresh, as the reference's resume does): the reference format,
or for bert vqa_tpu's flat dict (``models.convert.load_pth``);
:func:`export_pth` writes one. vqa_tpu's flax ``.ckpt`` files and its orbax
backend are not read.
"""

from __future__ import annotations

import os
import pickle

import torch

from ..models.convert import load_pth, pth_state_dict
from .state import TrainState

CKPT_PREFIX = "model_"
CKPT_SUFFIX = ".ckpt"
FORMAT = "vqa_tpu_torch.train_state/1"


def checkpoint_path(log_dir: str, step: int) -> str:
    return os.path.join(log_dir, f"{CKPT_PREFIX}{step}{CKPT_SUFFIX}")


def _atomic_save(obj, path: str) -> None:
    tmp = f"{path}.tmp.{os.getpid()}"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def save_checkpoint(state: TrainState, log_dir: str, step: int | None = None) -> str:
    step = state.step if step is None else step
    path = checkpoint_path(log_dir, step)
    _atomic_save({"format": FORMAT, "step": int(state.step),
                  "model": state.model.state_dict(),
                  "optimizer": state.optimizer.state_dict(),
                  "generator": state.generator.get_state()}, path)
    return path


class AsyncCheckpointer:
    """vqa_tpu's checkpointer interface (``save`` then ``wait`` before
    exit). Here ``save`` writes synchronously, so ``wait`` finds nothing in
    flight; a background writer is later work."""

    def save(self, state: TrainState, log_dir: str, step: int | None = None) -> str:
        return save_checkpoint(state, log_dir, step)

    def wait(self) -> None:
        pass


def _load(path: str) -> dict:
    message = (f"{path}: not a checkpoint of this package (a vqa_tpu flax .ckpt does "
               f"not load here; export it with vqa_tpu's save_pth and pass the .pth)")
    try:
        data = torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError as e:       # a flax msgpack file, or no pickle at all
        raise ValueError(message) from e
    if not (isinstance(data, dict) and data.get("format") == FORMAT):
        raise ValueError(message)
    return data


def restore_checkpoint(path: str, state: TrainState) -> TrainState:
    """Load a full checkpoint into ``state`` (in place) and return it."""
    data = _load(path)
    state.model.load_state_dict(data["model"], strict=True)
    state.optimizer.load_state_dict(data["optimizer"])
    state.step = int(data["step"])
    state.generator.set_state(data["generator"])
    return state


def load_any(path: str, state: TrainState) -> TrainState:
    """A full ``.ckpt`` (exact resume) or a reference ``.pth`` (weights only)."""
    if path.endswith(".pth"):
        state.model.load_state_dict(load_params_only(path), strict=True)
        return state
    return restore_checkpoint(path, state)


def load_params_only(path: str) -> dict:
    """The model state dict of a ``.ckpt`` or a ``.pth``, on the CPU."""
    if path.endswith(".pth"):
        return load_pth(path)
    return _load(path)["model"]


def export_pth(model: torch.nn.Module, path: str) -> str:
    """Write the model's ``.pth`` (``models.convert.pth_state_dict``: what
    ``serve --model_ckpt``, the reference and vqa_tpu's ``from_torch`` load)."""
    _atomic_save(pth_state_dict(model), path)
    return path


def latest_checkpoint(log_dir: str) -> str | None:
    """Highest-step ``model_<step>.ckpt`` in a run directory, if any."""
    best, best_step = None, -1
    for name in os.listdir(log_dir):
        if name.startswith(CKPT_PREFIX) and name.endswith(CKPT_SUFFIX):
            try:
                step = int(name[len(CKPT_PREFIX):-len(CKPT_SUFFIX)])
            except ValueError:
                continue
            if step > best_step:
                best, best_step = os.path.join(log_dir, name), step
    return best
