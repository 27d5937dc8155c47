"""Multi-device dry run (port of ``__graft_entry__.dryrun_multichip``).

    python -m vqa_tpu_torch.multichip 2 [--device cpu]

``dryrun_multichip(n, device)`` runs ``n`` ranks (a process group of one
when ``n`` is 1) through one training step of the production attention
model at 64² (bf16 compute, the int8 backbone with static calibrated scales:
kernels A and B on the card), first data-parallel on the ``("data",)``
mesh, then tensor + sequence parallel + FSDP on the 2-D ``("data",
"model")`` mesh, ``(n // 2, 2)`` or the degenerate ``(1, 1)`` for ``n`` 1,
on the same batch; the two losses must agree within 1e-2, vqa_tpu's bound.
An odd ``n`` above 1 skips the 2-D leg and says so.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

VOCAB, CLASSES, IMAGE, QLEN = 128, 11, 64, 16


def _batch(n: int) -> dict:
    rng = np.random.default_rng(0)
    b = 2 * n
    return {"image": rng.standard_normal((b, IMAGE, IMAGE, 3)).astype(np.float32),
            "question": rng.integers(1, VOCAB, (b, QLEN)).astype(np.int64),
            "ques_len": np.full((b,), QLEN, np.int64),
            "label": np.zeros((b,), np.int64)}


def _model(device, amax=None):
    from .config import build_model
    model, _ = build_model("attention", VOCAB, CLASSES, opt_lvl=1, int8_backbone=True,
                           device=device, generator=torch.Generator().manual_seed(0))
    if amax is not None:
        model.int8_amax = amax
    return model


def run_in_group(device: torch.device) -> dict:
    """Both legs on this rank's rows; every rank of the existing group calls
    it. Returns the two global losses (``tp_loss`` None when skipped)."""
    from .parallel import distributed
    from .parallel.mesh import get_mesh, get_mesh_2d, shard_batch
    from .train.calibrate import amax_tuple, collect_amax, image_tower
    from .train.state import create_train_state, place_on_mesh
    from .train.steps import make_train_step

    n = distributed.world_size()
    host = _batch(n)
    model = _model(device)
    assert model.vgg.conv0_pallas and model.int8_stages and model.vgg.hpack_pool \
        and model.vgg.fused_stem, "not the production config"
    # static int8 scales from the full batch, the same on every rank
    img = torch.from_numpy(host["image"]).to(device)
    amax = amax_tuple(model.int8_stages, collect_amax(image_tower("attention", model), [img]))
    model.int8_amax = amax

    def step(mesh, model, tp, fsdp):
        state = create_train_state(model, 1e-4)
        state = place_on_mesh(state, mesh, device, tp=tp, fsdp=fsdp)
        rows = shard_batch(host, mesh)
        batch = {k: torch.from_numpy(v).to(device) for k, v in rows.items()}
        metrics = make_train_step()(state, batch)
        return state, float(metrics["loss"])

    mesh = get_mesh(n, device_type=device.type)
    state, loss = step(mesh, model, tp=False, fsdp=False)
    assert state.step == 1 and np.isfinite(loss), loss
    tp_loss, shape = None, None
    if n == 1 or n % 2 == 0:
        mesh2 = get_mesh_2d(device.type, model_parallel=min(n, 2))
        model2 = _model(device, amax)
        model2.act_mesh = mesh2         # + sequence parallelism
        _, tp_loss = step(mesh2, model2, tp=True, fsdp=True)
        shape = tuple(mesh2.shape)
        assert abs(tp_loss - loss) < 1e-2, (tp_loss, loss)
    return {"loss": loss, "tp_loss": tp_loss, "mesh_2d": shape,
            "int8_stages": model.int8_stages}


def _rank(device: str) -> dict:
    from . import _build
    from .parallel import distributed
    distributed.initialize_distributed(torch.device(device).type)
    try:
        out = run_in_group(distributed.device_for(device))
    finally:
        distributed.shutdown()
    out["launches"] = {k.symbol: k.launches for k in _build.KERNELS}
    return out


def dryrun_multichip(n_devices: int, device: str = "cuda") -> dict:
    """Spawn ``n_devices`` ranks and run :func:`run_in_group`; prints one
    line and returns rank 0's result (every rank's kernel launches summed
    in ``launches``). Raises if a rank fails or the losses disagree."""
    from .parallel import distributed
    if torch.device(device).type == "cuda":
        from . import _build
        _build.build_all()
    results = distributed.spawn(_rank, n_devices, (device,))
    out = dict(results[0])
    out["launches"] = {k: sum(r["launches"][k] for r in results) for k in out["launches"]}
    if out["tp_loss"] is None:
        print(f"dryrun_multichip({n_devices}): WARNING — n is odd, the 2-D "
              f"tp+sp+fsdp mesh leg was SKIPPED (needs n % 2 == 0); only the "
              f"1-D data-parallel path was validated", flush=True)
        note = ", 2-D tp+sp+fsdp leg SKIPPED (odd n)"
    else:
        a, b = out["mesh_2d"]
        note = f", tp+sp+fsdp 2-D mesh ({a}x{b}) loss={out['tp_loss']:.4f}"
    print(f"dryrun_multichip({n_devices}): OK — loss={out['loss']:.4f}, "
          f"conv0+int8{out['int8_stages']}+hpack+fused_stem static scales, "
          f"device={device} x{n_devices}{note}", flush=True)
    return out


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("n_devices", type=int)
    parser.add_argument("--device", default="cuda")
    a = parser.parse_args()
    dryrun_multichip(a.n_devices, a.device)
