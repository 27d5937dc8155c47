"""Process groups, ranks and per-host data sharding (port of
vqa_tpu/parallel/distributed.py).

One process drives one device. A JAX "host" (one process over several
devices) is a node here: :func:`host_shard` is ``(node index, node count)``,
so the loader keeps vqa_tpu's per-host meaning, and each rank then keeps its
block of rows of its node's batch (``parallel.mesh.local_rows``).

Launching:

- under ``torchrun`` (or any launcher that sets ``RANK``, ``WORLD_SIZE``,
  ``LOCAL_RANK`` and ``MASTER_ADDR``), :func:`initialize_distributed` joins
  the group from that environment;
- ``python -m vqa_tpu_torch.main --num_devices N`` on one host starts the N
  local ranks itself (:func:`spawn`), each with that environment set, and a
  ``localhost`` rendezvous;
- with none of these and one device, nothing is initialized (a no-op, as in
  vqa_tpu).

The backend is NCCL on ``cuda`` and gloo on ``cpu``. ``VQA_SHARE_DEVICE=1``
puts every rank on ``cuda:0`` over gloo (NCCL refuses two ranks on one
device; gloo's CUDA path has ``all_reduce`` and ``broadcast``, what data
parallelism needs): several ranks on one card, to run the code path there.
"""

from __future__ import annotations

import os
import socket
import time

import torch
import torch.distributed as dist


def launched() -> bool:
    """True when a launcher set this process's rank (torchrun, :func:`spawn`)."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def share_device() -> bool:
    return os.environ.get("VQA_SHARE_DEVICE") == "1"


def backend_for(device_type: str) -> str:
    return "nccl" if device_type == "cuda" and not share_device() else "gloo"


def local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", 0))


def local_world_size() -> int:
    return int(os.environ.get("LOCAL_WORLD_SIZE", world_size()))


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_main() -> bool:
    """Rank 0: the one process that logs, writes TensorBoard and flat checkpoints."""
    return rank() == 0


def device_for(device: str | torch.device) -> torch.device:
    """This rank's device: ``cuda:<LOCAL_RANK>`` for ``cuda`` (set as the
    current device before any allocation; ``cuda:0`` for every rank with
    ``VQA_SHARE_DEVICE=1``), ``device`` itself otherwise."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    index = 0 if share_device() else local_rank()
    if dev.index is not None and not launched():
        index = dev.index
    if index >= torch.cuda.device_count():
        raise ValueError(f"rank {rank()} needs cuda:{index}, have "
                         f"{torch.cuda.device_count()} CUDA device(s)")
    torch.cuda.set_device(index)
    return torch.device("cuda", index)


def initialize_distributed(device_type: str, init_method: str | None = None,
                           world: int | None = None, rank_: int | None = None) -> bool:
    """Join the process group; returns whether one is initialized.

    No-op (False) when no launcher set a rank and no ``init_method`` is
    given, or when a group already exists (True).
    """
    if dist.is_initialized():
        return True
    if init_method is None and not launched():
        return False
    kwargs = {}
    if init_method is not None:
        kwargs = {"init_method": init_method,
                  "world_size": int(os.environ["WORLD_SIZE"]) if world is None else world,
                  "rank": int(os.environ["RANK"]) if rank_ is None else rank_}
    backend = backend_for(device_type)
    if backend == "nccl":           # this rank's card, named before any collective
        kwargs["device_id"] = device_for(device_type)
    dist.init_process_group(backend, **kwargs)
    return True


def shutdown() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def host_shard() -> tuple[int, int]:
    """(shard_index, num_shards) for this node's data pipeline: the node's
    index and the node count (one process per device, so a node is what a
    JAX process over its local devices is)."""
    lws = local_world_size()
    return rank() // lws, max(world_size() // lws, 1)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawned(index: int, nprocs: int, port: int, fn, args, queue) -> None:
    os.environ.update({"RANK": str(index), "WORLD_SIZE": str(nprocs),
                       "LOCAL_RANK": str(index), "LOCAL_WORLD_SIZE": str(nprocs),
                       "MASTER_ADDR": "localhost", "MASTER_PORT": str(port)})
    if "OMP_NUM_THREADS" not in os.environ:     # the host's cores, shared
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // nprocs))
    queue.put((index, fn(*args)))


def spawn(fn, nprocs: int, args=()) -> list:
    """Run ``fn(*args)`` in ``nprocs`` local processes, each with torchrun's
    environment for its rank and a ``localhost`` rendezvous on a free port;
    returns their results in rank order. Raises if any process fails (the
    others are then stopped: they would wait on its collectives)."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    queue = ctx.SimpleQueue()
    port = free_port()
    procs = [ctx.Process(target=_spawned, args=(i, nprocs, port, fn, args, queue))
             for i in range(nprocs)]
    for p in procs:
        p.start()
    results = {}
    while len(results) < nprocs:
        if not queue.empty():
            i, out = queue.get()
            results[i] = out
        elif any(p.exitcode not in (None, 0) for p in procs):
            for p in procs:
                p.terminate()
            break
        elif all(p.exitcode is not None for p in procs) and queue.empty():
            break
        else:
            time.sleep(0.05)
    for p in procs:
        p.join()
    if len(results) < nprocs:
        raise RuntimeError(f"ranks {sorted(set(range(nprocs)) - set(results))} of {nprocs} "
                           f"failed (exit codes {[p.exitcode for p in procs]})")
    return [results[i] for i in range(nprocs)]
