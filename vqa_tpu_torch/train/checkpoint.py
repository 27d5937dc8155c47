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
directories are not read.

On a device mesh the flat ``.ckpt`` holds the full state, gathered from
every rank's shards (:func:`full_state`) and written by rank 0 alone, in the
single-device format: it resumes at any world size. ``--ckpt_backend
orbax`` (vqa_tpu's flag and its ``model_<step>.orbax`` name) writes a
``torch.distributed.checkpoint`` directory instead, each rank its own
shards (:func:`save_dcp`), restored into the current placement
(:func:`load_dcp`).
"""

from __future__ import annotations

import os
import pickle

import torch

from ..models.convert import load_pth, pth_state_dict
from ..parallel.distributed import rank
from .state import TrainState

CKPT_PREFIX = "model_"
CKPT_SUFFIX = ".ckpt"
DCP_SUFFIX = ".orbax"
FORMAT = "vqa_tpu_torch.train_state/1"


def checkpoint_path(log_dir: str, step: int) -> str:
    return os.path.join(log_dir, f"{CKPT_PREFIX}{step}{CKPT_SUFFIX}")


def _atomic_save(obj, path: str) -> None:
    tmp = f"{path}.tmp.{os.getpid()}"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def _full(t):
    """A tensor's full value on the CPU (a ``DTensor`` gathered: collective)."""
    from torch.distributed.tensor import DTensor

    if isinstance(t, DTensor):
        t = t.full_tensor()
    return t.cpu() if isinstance(t, torch.Tensor) else t


def full_state(state: TrainState) -> dict:
    """The whole state with every ``DTensor`` gathered, in the format of a
    single-device run (so a ``.ckpt`` resumes at any world size). Every rank
    must call it on a sharded state."""
    osd = state.optimizer.state_dict()
    osd["state"] = {i: {k: _full(v) for k, v in st.items()} for i, st in osd["state"].items()}
    return {"format": FORMAT, "step": int(state.step),
            "model": {k: _full(v) for k, v in state.model.state_dict().items()},
            "optimizer": osd, "generator": state.generator.get_state()}


def save_checkpoint(state: TrainState, log_dir: str, step: int | None = None) -> str:
    """The flat ``model_<step>.ckpt``: gathered on every rank, written by rank 0."""
    step = state.step if step is None else step
    path = checkpoint_path(log_dir, step)
    data = full_state(state) if state.mesh is not None and _sharded(state) else None
    if rank() == 0:
        _atomic_save(data or {"format": FORMAT, "step": int(state.step),
                              "model": state.model.state_dict(),
                              "optimizer": state.optimizer.state_dict(),
                              "generator": state.generator.get_state()}, path)
    return path


def _sharded(state: TrainState) -> bool:
    return state.runner is not None and state.runner is state.model


def dcp_path(log_dir: str, step: int) -> str:
    return os.path.join(log_dir, f"{CKPT_PREFIX}{step}{DCP_SUFFIX}")


def save_dcp(state: TrainState, log_dir: str, step: int | None = None) -> str:
    """``--ckpt_backend orbax``: a ``torch.distributed.checkpoint`` directory
    ``model_<step>.orbax``, each rank writing its own shards (replicated
    values once), what vqa_tpu's orbax backend writes per host."""
    import torch.distributed.checkpoint as dcp
    from torch.distributed.checkpoint.state_dict import get_state_dict

    step = state.step if step is None else step
    path = dcp_path(log_dir, step)
    msd, osd = get_state_dict(state.model, state.optimizer)
    dcp.save({"model": msd, "optimizer": osd, "step": torch.tensor(int(state.step)),
              "generator": state.generator.get_state()}, checkpoint_id=path)
    return path


def load_dcp(path: str, state: TrainState) -> TrainState:
    """Restore a :func:`save_dcp` directory into ``state`` in its current
    placement (any mesh: the shards are redistributed on load)."""
    import torch.distributed.checkpoint as dcp
    from torch.distributed.checkpoint.state_dict import get_state_dict, set_state_dict

    msd, osd = get_state_dict(state.model, state.optimizer)
    data = {"model": msd, "optimizer": osd, "step": torch.tensor(0),
            "generator": state.generator.get_state()}
    # the template holds optimizer state for every parameter; a parameter
    # no forward reaches (co_attention.W_b) has none in the checkpoint
    dcp.load(data, checkpoint_id=path,
             planner=dcp.default_planner.DefaultLoadPlanner(allow_partial_load=True))
    set_state_dict(state.model, state.optimizer, model_state_dict=data["model"],
                   optim_state_dict=data["optimizer"])
    state.step = int(data["step"])
    state.generator.set_state(data["generator"])
    return state


class AsyncCheckpointer:
    """vqa_tpu's checkpointer interface (``save`` then ``wait`` before
    exit), with its ``backend``: ``flax`` writes the flat ``.ckpt``,
    ``orbax`` the sharded directory. Here ``save`` writes synchronously, so
    ``wait`` finds nothing in flight; a background writer is later work."""

    def __init__(self, backend: str = "flax"):
        self.backend = backend

    def save(self, state: TrainState, log_dir: str, step: int | None = None) -> str:
        if self.backend == "orbax":
            return save_dcp(state, log_dir, step)
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
    """A full ``.ckpt`` (exact resume) or a reference ``.pth`` (weights only).
    A ``.orbax`` directory loads with :func:`load_dcp`, once the state is
    placed on its mesh."""
    if path.endswith(DCP_SUFFIX):
        return load_dcp(path, state)
    if path.endswith(".pth"):
        state.model.load_state_dict(load_params_only(path), strict=True)
        return state
    return restore_checkpoint(path, state)


def load_params_only(path: str) -> dict:
    """The model state dict of a ``.ckpt``, a ``.pth`` or a ``.orbax``
    directory, on the CPU (a directory is read whole, without a process
    group)."""
    if path.endswith(".pth"):
        return load_pth(path)
    if path.endswith(DCP_SUFFIX):
        from torch.distributed.checkpoint.format_utils import dcp_to_torch_save
        import tempfile
        with tempfile.TemporaryDirectory() as tmp:
            flat = os.path.join(tmp, "ckpt.pt")
            dcp_to_torch_save(path, flat)
            return {k: v.cpu() for k, v in
                    torch.load(flat, map_location="cpu", weights_only=False)["model"].items()}
    return _load(path)["model"]


def export_pth(model: torch.nn.Module, path: str) -> str:
    """Write the model's ``.pth`` (``models.convert.pth_state_dict``: what
    ``serve --model_ckpt``, the reference and vqa_tpu's ``from_torch`` load)."""
    _atomic_save(pth_state_dict(model), path)
    return path


def latest_checkpoint(log_dir: str) -> str | None:
    """Highest-step ``model_<step>.ckpt`` or ``model_<step>.orbax`` in a run
    directory, if any."""
    best, best_step = None, -1
    for name in os.listdir(log_dir):
        suffix = next((x for x in (CKPT_SUFFIX, DCP_SUFFIX) if name.endswith(x)), None)
        if name.startswith(CKPT_PREFIX) and suffix:
            try:
                step = int(name[len(CKPT_PREFIX):-len(suffix)])
            except ValueError:
                continue
            if step > best_step:
                best, best_step = os.path.join(log_dir, name), step
    return best
