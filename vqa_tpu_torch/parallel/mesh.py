"""Device mesh and batch-parallel placement (port of vqa_tpu/parallel/mesh.py).

vqa_tpu shards a batch on its leading axis over a 1-D ``("data",)`` mesh
and replicates the TrainState; GSPMD inserts the gradient ``psum``. Here one
process drives one device, so the same design is: every rank keeps its
contiguous block of rows of its node's batch (:func:`local_rows`,
:func:`shard_batch`), the trainable modules are wrapped in
``DistributedDataParallel`` (:func:`replicate_to_mesh`: rank 0's weights
broadcast at wrap time, gradients averaged over ``data``), and the loss is
each rank's local mean, whose average over equal blocks is the global mean.

``model_parallel=m`` builds the 2-D ``("data", "model")`` mesh of shape
``(n // m, m)`` that ``parallel.sharding`` places tensor-parallel and FSDP
parameters on; the batch is split over ``data`` only, so the ranks of one
``model`` group hold the same rows. The global batch and its order are the
world-1 run's: the loader's ``(seed, epoch)`` order is untouched.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch
import torch.distributed as dist

from . import distributed

DATA_AXIS = "data"
MODEL_AXIS = "model"


def get_mesh(num_devices: int | None = None, model_parallel: int = 1,
             device_type: str = "cuda"):
    """The ``("data",)`` or ``("data", "model")`` ``DeviceMesh`` over the
    first ``num_devices`` ranks (default: the world). Raises ``ValueError``
    as vqa_tpu's does when more devices are asked for than exist, or when
    ``model_parallel`` does not divide the count. A mesh spans the whole
    world: fewer devices than ranks raises too."""
    from torch.distributed.device_mesh import init_device_mesh

    have = distributed.world_size()
    n = have if num_devices is None else num_devices
    if n > have:
        raise ValueError(f"requested {n} devices, have {have}")
    if n != have:
        raise ValueError(f"a mesh spans every rank: requested {n} devices of a "
                         f"world of {have}")
    if model_parallel > 1:
        return get_mesh_2d(device_type, model_parallel)
    return init_device_mesh(device_type, (n,), mesh_dim_names=(DATA_AXIS,))


def get_mesh_2d(device_type: str = "cuda", model_parallel: int = 1):
    """The ``(world // model_parallel, model_parallel)`` two-axis mesh, also
    where ``model_parallel`` is 1 (the degenerate ``(n, 1)`` and ``(1, 1)``
    meshes of ``dryrun_multichip``)."""
    from torch.distributed.device_mesh import init_device_mesh

    n = distributed.world_size()
    if n % model_parallel:
        raise ValueError(
            f"model_parallel={model_parallel} must divide the device count {n}")
    return init_device_mesh(device_type, (n // model_parallel, model_parallel),
                            mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def axis_size(mesh, axis: str) -> int:
    names = mesh.mesh_dim_names or ()
    return mesh.size(names.index(axis)) if axis in names else 1


def data_index(mesh) -> int:
    """This rank's coordinate on ``data``."""
    return mesh.get_local_rank(DATA_AXIS)


def data_group(mesh):
    """The process group of this rank's ``data`` axis (its gradient and
    metric reductions)."""
    return mesh.get_group(DATA_AXIS)


def local_rows(mesh, num_shards: int = 1) -> tuple[int, int]:
    """``(index, count)``: this rank keeps block ``index`` of ``count`` equal
    blocks of its node's batch. ``num_shards`` is the node count
    (``distributed.host_shard``); the ``data`` coordinates are laid out node
    by node."""
    if mesh is None:
        return 0, 1
    per_node = axis_size(mesh, DATA_AXIS) // max(num_shards, 1)
    return data_index(mesh) % per_node, per_node


def row_block(n: int, index: int, count: int) -> slice:
    if n % count:
        raise ValueError(f"a batch of {n} rows does not split into {count} equal "
                         f"blocks over the data axis (make --batch_size a multiple)")
    m = n // count
    return slice(index * m, (index + 1) * m)


def shard_batch(batch: dict, mesh, num_shards: int = 1) -> dict:
    """This rank's contiguous block of rows of a host batch (numpy arrays or
    tensors, leading axis = rows)."""
    index, count = local_rows(mesh, num_shards)
    if count == 1:
        return batch
    rows = row_block(len(batch["label"]), index, count)
    return {k: v[rows] for k, v in batch.items()}


def replicate_to_mesh(model: torch.nn.Module, mesh, device: torch.device):
    """``DistributedDataParallel`` over ``model``: replicated weights
    (broadcast from rank 0 when wrapped), gradients averaged over ``data``.
    Parameters that no forward reaches (the attention model's unused
    ``co_attention.W_b``) are left out of the reduction; frozen ones take no
    part in it anyway."""
    from torch.nn.parallel import DistributedDataParallel as DDP

    unused = [f"{n}" for n, p in model.named_parameters()
              if p.requires_grad and n.startswith("co_attention.W_b.")]
    if unused:
        DDP._set_params_and_buffers_to_ignore_for_model(model, unused)
    with warnings.catch_warnings():     # broadcast_buffers: deprecated in newer torch
        warnings.simplefilter("ignore", FutureWarning)
        return DDP(model, device_ids=[device.index] if device.type == "cuda" else None,
                   process_group=data_group(mesh), broadcast_buffers=False)


def all_reduce_sum(values, mesh, device) -> np.ndarray:
    """Sum a few float64 numbers over ``data`` (metric totals)."""
    t = torch.tensor(np.asarray(values, np.float64), device=device)
    if mesh is not None and axis_size(mesh, DATA_AXIS) > 1:
        dist.all_reduce(t, group=data_group(mesh))
    return t.cpu().numpy()
