"""Multi-device training in the port (``vqa_tpu_torch.parallel``, ``main``'s
mesh flags, ``multichip``) vs vqa_tpu's on its simulated mesh, on the CPU.

Sizes are ``tests/test_parallel.py``'s ``tiny_problem``: the attention model
at vocab 30, K 4, hidden 512, mlp 128, batch 16, question length 6, 32²
images (64² for sequence parallelism, S = 4). One flax init goes to both
packages (``models.convert.from_jax``); the same numpy batch goes through
vqa_tpu's ``make_train_step`` on ``get_mesh(2)`` (DP) and ``get_mesh(4,
model_parallel=2)`` (TP + FSDP, and + SP at 64²), in this process on the
simulated 8-device mesh, and through the port in two spawned gloo groups,
one of world 2 (the ``("data",)`` mesh) and one of world 4 (the 2x2
``("data", "model")`` mesh), each started once per module and running every
mode.

Tolerances:

- port world N vs port world 1: losses rtol 1e-5, atol 1e-6; trainable
  parameters after 3 steps within 3e-3 max abs (vqa_tpu's bounds,
  tests/test_parallel_tp.py:159, :170: early Adam steps divide a near-zero
  moment by a near-zero root, so reduction-order noise moves an element by
  a fraction of an update);
- port vs vqa_tpu in the same mode (fp32, vqa_tpu jitted): 3-step losses
  within 1e-4 relative;
- the int8 route's calibration scales: bit-equal across ranks and to world 1;
- batch-stats BatchNorm over ``data`` vs world 1: within 1e-5 * max|out|,
  the recorded batch-stats bound (ROADMAP §3, last entry); running stats
  within 1e-6 of each layer's largest;
- dropout (baseline): each rank's masks bit-equal to its rows of world 1's;
- resume: a world-2 run resumed from its step-2 ``.ckpt`` (and from its
  ``.orbax`` directory) equals the uninterrupted run bit for bit, and the
  ``.ckpt`` resumes at world 1 within the world-N bounds;
- the rule table: the port's ``param_spec`` equals vqa_tpu's under the name
  and layout mapping for every parameter of the three families, except the
  listed exceptions (``parallel.sharding.EXCEPTIONS``).
"""

import os
import pickle
import re
import time
import traceback

import numpy as np
import pytest
import torch
import torch.distributed as dist

V, K, L, B, MLP = 30, 4, 6, 16, 128
LR = 1e-3
N_STEPS = 3
LOSS_RTOL, LOSS_ATOL, PARAM_ATOL = 1e-5, 1e-6, 3e-3
JAX_RTOL = 1e-4
BN_TOL = 1e-5
# a trainable VGG trains at the reference's 1e-4; its batch-stats tower
# amplifies fp32 summation-order differences (2.5e-5 relative within 3 Adam
# steps between two packages, tests/test_torch_vgg_train.py), and at world 2
# the statistics are all-reduced sums
VGG_TRAIN = ("--vgg_train", "true", "--learning_rate", "1e-4")
VGG_RTOL = 1e-4


def _batch(image=32, seed=0):
    rng = np.random.default_rng(seed)
    return {"image": rng.standard_normal((B, image, image, 3)).astype(np.float32),
            "question": rng.integers(1, V, (B, L)).astype(np.int32),
            "ques_len": np.full((B,), L, np.int32),
            "label": rng.integers(0, K, (B,)).astype(np.int32)}


def _torch_batch(b):
    return {"image": torch.from_numpy(b["image"]),
            **{k: torch.from_numpy(b[k]).long() for k in ("question", "ques_len", "label")}}


def _attention(weights):
    from vqa_tpu_torch.models.coattention import HierarchicalCoAttentionNet
    model = HierarchicalCoAttentionNet(V, K, mlp_dim=MLP)
    model.load_state_dict(weights, strict=True)
    return model


def _baseline():
    from vqa_tpu_torch.config import build_model
    model, _ = build_model("baseline", V, K, opt_lvl=0, device="cpu",
                           generator=torch.Generator().manual_seed(3))
    return model


def _train(model, batch, steps, mesh=None, tp=False, fsdp=False):
    """``steps`` port train steps on ``batch`` (this rank's rows when on a
    mesh): (global losses, the state)."""
    from vqa_tpu_torch.train.state import create_train_state, place_on_mesh
    from vqa_tpu_torch.train.steps import make_train_step
    state = create_train_state(model, LR)
    if mesh is not None:
        state = place_on_mesh(state, mesh, torch.device("cpu"), tp=tp, fsdp=fsdp)
    step = make_train_step()
    losses = []
    for _ in range(steps):
        losses.append(float(step(state, batch)["loss"]))
    return losses, state


def _full_params(state) -> dict:
    from vqa_tpu_torch.train.checkpoint import _full
    return {n: _full(p.detach()).numpy() for n, p in state.model.named_parameters()
            if p.requires_grad}


def _dropout_masks(model, store: list):
    """Record each dropout's kept positions (output != 0 where input != 0)."""
    from vqa_tpu_torch.models.layers import Dropout

    def hook(mod, args, out):
        x = args[0]
        store.append(((out != 0) | (x == 0)).numpy())
    return [m.register_forward_hook(hook) for m in model.modules() if isinstance(m, Dropout)]


# ------------------------------------------------------------- the groups

def _world2(weights, work):
    from vqa_tpu_torch.main import main
    from vqa_tpu_torch.models.vgg import VGGFeatures
    from vqa_tpu_torch.parallel.mesh import data_group, get_mesh, local_rows, shard_batch
    from vqa_tpu_torch.train.calibrate import amax_tuple, collect_amax
    mesh = get_mesh(2, device_type="cpu")
    rank = dist.get_rank()
    out = {}
    host = _batch()
    mine = _torch_batch(shard_batch(host, mesh))
    # DP, fp32
    out["dp_losses"], state = _train(_attention(weights), mine, N_STEPS, mesh)
    if rank == 0:
        torch.save(_full_params(state), os.path.join(work, "dp_params.pt"))
    # the int8 route's calibration: the full batch on every rank
    from vqa_tpu_torch.config import build_model
    m8, _ = build_model("attention", V, K, opt_lvl=0, int8_backbone=True, device="cpu")
    out["amax"] = amax_tuple(m8.int8_stages, collect_amax(
        m8.vgg, [torch.from_numpy(host["image"])]))
    # batch-stats BatchNorm over data: features of this rank's rows, running stats
    vgg = _attention(weights).vgg
    vgg.train()
    vgg.stats_group = data_group(mesh)
    with torch.no_grad():
        feats = vgg.train_forward(mine["image"], batch_stats=True)
    out["bn_feats"] = feats.numpy()
    out["bn_running"] = [(bn.running_mean.numpy().copy(), bn.running_var.numpy().copy())
                         for _, bn in vgg._conv_bn]
    out["rows"] = local_rows(mesh)
    # dropout live: the baseline, 2 steps
    masks = []
    model = _baseline()
    handles = _dropout_masks(model, masks)
    out["dropout_losses"], _ = _train(model, mine, 2, mesh)
    for h in handles:
        h.remove()
    out["dropout_masks"] = masks
    # the CLI at world 2: resume (.ckpt and .orbax), then test mode
    cli = _cli_args(work)
    full = main(["--mode", "train", *cli("full", "--save_interval", "2")])
    ckpt = os.path.join(full["log_dir"], "model_2.ckpt")
    resumed = main(["--mode", "train", *cli("resumed", "--model_ckpt", ckpt)])
    orbax = main(["--mode", "train", *cli("orbax", "--save_interval", "2",
                                          "--ckpt_backend", "orbax")])
    orbax_resumed = main(["--mode", "train", *cli(
        "orbax_resumed", "--model_ckpt", os.path.join(orbax["log_dir"], "model_2.orbax"))])
    tested = main(["--mode", "test", *cli("full", "--model_ckpt", "model_4.ckpt",
                                          "--val_file", os.path.join(work, "val13.txt"),
                                          "--val_img", work,
                                          "--batch_size", "8",
                                          "--test_out", os.path.join(work, "preds.txt"))])
    # the feature cache (rank 0 builds, every rank reads its rows) and
    # microbatches (one gradient reduction a step: DDP's no_sync, FSDP2's
    # set_requires_gradient_sync)
    cached = main(["--mode", "train", *cli("cached", "--cache_features", "true",
                                           "--cache_dir", os.path.join(work, "fc"))])
    accum = main(["--mode", "train", *cli("accum", "--grad_accum", "2")])
    fsdp_accum = main(["--mode", "train", *cli("fsdp_accum", "--grad_accum", "2",
                                               "--fsdp", "true")])
    out["fsdp_lstm_calls"] = {k: v - accum["lstm_calls"][k]
                              for k, v in fsdp_accum["lstm_calls"].items()}
    # a trainable VGG: global batch statistics with autograd, its gradients
    # averaged beside the FSDP-sharded head
    vgg_train = main(["--mode", "train", *cli("vgg_train", *VGG_TRAIN, "--fsdp", "true")])
    out["cli"] = {"full": full["losses"], "resumed": resumed["losses"],
                  "first_step": resumed["first_step"], "orbax": orbax["losses"],
                  "orbax_resumed": orbax_resumed["losses"], "ckpt": ckpt,
                  "test": tested, "cached": cached["losses"], "accum": accum["losses"],
                  "fsdp_accum": fsdp_accum["losses"], "vgg_train": vgg_train["losses"]}
    out["bn_group_is_data"] = all(m.stats_group is not None for m in state.model.modules()
                                  if isinstance(m, VGGFeatures))
    return out


def _world4(weights, work):
    from torch.distributed.tensor import DTensor
    from vqa_tpu_torch import multichip
    from vqa_tpu_torch.parallel.mesh import get_mesh, shard_batch
    from vqa_tpu_torch.parallel.sharding import param_spec
    mesh = get_mesh(4, model_parallel=2, device_type="cpu")
    rank = dist.get_rank()
    out = {}
    mine = _torch_batch(shard_batch(_batch(), mesh))
    # TP + FSDP: the LSTM's weights are DTensors, so it runs the loop
    from vqa_tpu_torch.models.layers import lstm_calls
    before = lstm_calls()
    out["tp_losses"], state = _train(_attention(weights), mine, N_STEPS, mesh, tp=True,
                                     fsdp=True)
    out["tp_lstm_calls"] = {k: v - before[k] for k, v in lstm_calls().items()}
    params = _full_params(state)
    if rank == 0:
        torch.save(params, os.path.join(work, "tp_params.pt"))
    placements, expected = {}, {}
    for name, p in state.model.named_parameters():
        if not p.requires_grad:
            continue
        axes = [None] * p.dim()
        if isinstance(p, DTensor):
            for axis, pl in zip(p.device_mesh.mesh_dim_names, p.placements):
                if pl.is_shard():
                    axes[pl.dim] = axis
        while axes and axes[-1] is None:
            axes.pop()
        placements[name] = tuple(axes)
        expected[name] = param_spec(name, p.shape, mesh)
    out["placements"], out["expected_placements"] = placements, expected
    # + sequence parallelism (64²: S = 4, divisible by the model axis)
    model = _attention(weights)
    model.act_mesh = mesh
    out["sp_losses"], _ = _train(model, _torch_batch(shard_batch(_batch(64), mesh)), N_STEPS,
                                 mesh, tp=True, fsdp=True)
    # the baseline family: its GRU stays replicated over model
    out["baseline_losses"], _ = _train(_baseline(), mine, 2, mesh, tp=True, fsdp=True)
    out["dryrun"] = multichip.run_in_group(torch.device("cpu"))
    return out


def _cli_args(work):
    def args(run, *extra):
        return ["--model", "attention", "--expt_dir", os.path.join(work, "runs"),
                "--expt_name", "e", "--run_name", run, "--train_img", work, "--train_file",
                os.path.join(work, "train.txt"), "--vocab_file", os.path.join(work, "vocab.pkl"),
                "--batch_size", "4", "--num_epochs", "1", "--num_cls", str(K - 1),
                "--synthetic_images", "true", "--image_size", "32", "--device", "cpu",
                "--opt_lvl", "0", "--learning_rate", str(LR), "--num_workers", "1",
                "--log_interval", "100", "--prefetch_batches", "1", *extra]
    return args


def _write_cli_data(work):
    words = [f"w{i}" for i in range(2, V)]
    word2idx = {"<PAD>": 0, "<UNKNOWN>": 1, **{w: i + 2 for i, w in enumerate(words)}}
    labels = ["UNKNOWN", "a1", "a2", "a3"]
    vocab = {"word2idx": word2idx, "idx2word": {i: w for w, i in word2idx.items()},
             "label2idx": {a: i for i, a in enumerate(labels)},
             "idx2label": dict(enumerate(labels)), "max_seq_length": L}
    with open(os.path.join(work, "vocab.pkl"), "wb") as f:
        pickle.dump(vocab, f)
    qs = ["w2,w3,w4", "w5,w6", "w7,w8,w9,w10", "w11,w12", "w13,w14,w15"]
    with open(os.path.join(work, "train.txt"), "w") as f:
        f.write("".join(f"t{i}.png\t{qs[i % 5]}\t{labels[1 + i % 3]}\n" for i in range(16)))
    with open(os.path.join(work, "val13.txt"), "w") as f:
        f.write("".join(f"v{i}.png\t{qs[(i + 2) % 5]}\t{labels[1 + i % 3]}\n"
                        for i in range(13)))


def _group_rank(rank, world, init_file, weights_file, work, queue):
    os.environ.update({"RANK": str(rank), "WORLD_SIZE": str(world), "LOCAL_RANK": str(rank),
                       "LOCAL_WORLD_SIZE": str(world)})
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=world)
    try:
        weights = torch.load(weights_file, weights_only=True)
        out = (_world2 if world == 2 else _world4)(weights, work)
    except BaseException:
        out = {"error": traceback.format_exc()}
    queue.put((rank, out))
    dist.destroy_process_group()


class _Groups:
    """The two spawned groups, started together, joined on first use."""

    def __init__(self, tmp, weights):
        import torch.multiprocessing as mp
        self.work = {w: str(tmp / f"w{w}") for w in (2, 4)}
        weights_file = str(tmp / "weights.pt")
        torch.save(weights, weights_file)
        ctx = mp.get_context("spawn")
        self.queues, self.procs = {}, []
        for world in (2, 4):
            os.makedirs(self.work[world])
            _write_cli_data(self.work[world])
            q = ctx.SimpleQueue()
            self.queues[world] = q
            init = str(tmp / f"pg{world}")
            self.procs += [ctx.Process(target=_group_rank,
                                       args=(r, world, init, weights_file, self.work[world], q))
                           for r in range(world)]
        self.t0 = time.perf_counter()
        for p in self.procs:
            p.start()
        self._out = None

    def results(self):
        if self._out is None:
            out = {2: {}, 4: {}}
            while sum(map(len, out.values())) < len(self.procs):
                for world, q in self.queues.items():
                    while not q.empty():
                        r, res = q.get()
                        out[world][r] = res
                if all(p.exitcode is not None for p in self.procs):
                    for world, q in self.queues.items():
                        while not q.empty():
                            r, res = q.get()
                            out[world][r] = res
                    break
                time.sleep(0.05)
            for p in self.procs:
                p.join()
            errors = [res["error"] for w in out.values() for res in w.values() if "error" in res]
            assert not errors, "\n".join(errors)
            assert all(len(out[w]) == w for w in (2, 4)), [p.exitcode for p in self.procs]
            self.seconds = time.perf_counter() - self.t0
            self._out = out
        return self._out


@pytest.fixture(scope="module")
def jax_init():
    import jax
    import jax.numpy as jnp
    from vqa_tpu.models import HierarchicalCoAttentionNet
    from vqa_tpu.train.state import create_train_state
    from vqa_tpu_torch.models.convert import from_jax
    model = HierarchicalCoAttentionNet(vocab_size=V, K=K, word_emb_dim=512, hidden_dim=512,
                                       mlp_dim=MLP)
    batch = _batch()
    init = {k: jnp.asarray(v[:1]) for k, v in batch.items() if k != "label"}
    state = create_train_state(model, jax.random.PRNGKey(0), init, LR)
    weights = from_jax("attention", jax.tree_util.tree_map(np.asarray, state.params),
                       jax.tree_util.tree_map(np.asarray, state.batch_stats))
    return model, state, weights


@pytest.fixture(scope="module")
def groups(tmp_path_factory, jax_init):
    return _Groups(tmp_path_factory.mktemp("mesh"), jax_init[2])


@pytest.fixture(scope="module")
def jax_losses(jax_init, groups):
    """vqa_tpu's DP (get_mesh(2)), TP + FSDP (get_mesh(4, model_parallel=2))
    and TP + FSDP + SP (64²) 3-step losses, while the groups run."""
    from vqa_tpu.parallel.mesh import batch_sharding, get_mesh, replicate_to_mesh, shard_batch
    from vqa_tpu.parallel.sharding import shard_state_to_mesh, state_shardings
    from vqa_tpu.train.state import make_optimizer
    from vqa_tpu.train.steps import make_train_step
    model, state, _ = jax_init
    tx = make_optimizer(LR, state.params, False)
    out = {}
    mesh2d = get_mesh(4, model_parallel=2)
    for mode, mesh in (("dp", get_mesh(2)), ("tp", mesh2d), ("sp", mesh2d)):
        if mode == "dp":
            s, step = replicate_to_mesh(state, mesh), make_train_step(model, tx, donate=False)
        else:
            s = shard_state_to_mesh(state, mesh, tp=True, fsdp=True)
            sh = (state_shardings(s, mesh, tp=True, fsdp=True), batch_sharding(mesh))
            step = make_train_step(model.clone(act_mesh=mesh) if mode == "sp" else model,
                                   tx, donate=False, shardings=sh)
        b = shard_batch(_batch(64 if mode == "sp" else 32), mesh)
        losses = []
        for _ in range(N_STEPS):
            s, m = step(s, b)
            losses.append(float(m["loss"]))
        out[mode] = losses
    return out


@pytest.fixture(scope="module")
def world1(jax_init, groups):
    """The port at world 1 (no group): the references of every mode."""
    weights = jax_init[2]
    out = {}
    torch.set_num_threads(2)
    out["losses"], state = _train(_attention(weights), _torch_batch(_batch()), N_STEPS)
    out["params"] = _full_params(state)
    out["sp_losses"], _ = _train(_attention(weights), _torch_batch(_batch(64)), N_STEPS)
    masks = []
    model = _baseline()
    handles = _dropout_masks(model, masks)
    out["dropout_losses"], _ = _train(model, _torch_batch(_batch()), 2)
    for h in handles:
        h.remove()
    out["dropout_masks"] = masks
    vgg = _attention(weights).vgg
    vgg.train()
    with torch.no_grad():
        out["bn_feats"] = vgg.train_forward(torch.from_numpy(_batch()["image"]),
                                            batch_stats=True).numpy()
    out["bn_running"] = [(bn.running_mean.numpy().copy(), bn.running_var.numpy().copy())
                         for _, bn in vgg._conv_bn]
    from vqa_tpu_torch.config import build_model
    from vqa_tpu_torch.train.calibrate import amax_tuple, collect_amax
    m8, _ = build_model("attention", V, K, opt_lvl=0, int8_backbone=True, device="cpu")
    out["amax"] = amax_tuple(m8.int8_stages, collect_amax(
        m8.vgg, [torch.from_numpy(_batch()["image"])]))
    return out


def _close(a, b):
    np.testing.assert_allclose(a, b, rtol=LOSS_RTOL, atol=LOSS_ATOL)


# ------------------------------------------------------- DP at world 2

def test_dp_world2_matches_world1_and_vqa_tpu(groups, world1, jax_losses):
    res = groups.results()[2]
    assert res[0]["dp_losses"] == res[1]["dp_losses"]
    _close(res[0]["dp_losses"], world1["losses"])
    np.testing.assert_allclose(res[0]["dp_losses"], jax_losses["dp"], rtol=JAX_RTOL)
    params = torch.load(os.path.join(groups.work[2], "dp_params.pt"), weights_only=False)
    assert set(params) == set(world1["params"])
    assert max(np.abs(params[k].astype(np.float64) - world1["params"][k]).max()
               for k in params) < PARAM_ATOL


def test_int8_scales_equal_across_ranks_and_world1(groups, world1):
    res = groups.results()[2]
    assert res[0]["amax"] == res[1]["amax"] == world1["amax"]


def test_batch_stats_bn_is_global(groups, world1):
    res = groups.results()[2]
    ref = world1["bn_feats"]
    scale = np.abs(ref).max()
    for r in (0, 1):
        index, count = res[r]["rows"]
        n = B // count
        np.testing.assert_allclose(res[r]["bn_feats"], ref[index * n:(index + 1) * n],
                                   rtol=0, atol=BN_TOL * scale)
        for (m, v), (rm, rv) in zip(res[r]["bn_running"], world1["bn_running"]):
            np.testing.assert_allclose(m, rm, rtol=0, atol=1e-6 * np.abs(rm).max())
            np.testing.assert_allclose(v, rv, rtol=0, atol=1e-6 * np.abs(rv).max())
    assert res[0]["bn_group_is_data"]


def test_dropout_masks_are_rows_of_world1(groups, world1):
    res = groups.results()[2]
    ref = world1["dropout_masks"]
    for r in (0, 1):
        masks = res[r]["dropout_masks"]
        assert len(masks) == len(ref) > 0
        index, count = res[r]["rows"]
        for got, want in zip(masks, ref):
            n = want.shape[0] // count
            np.testing.assert_array_equal(got, want[index * n:(index + 1) * n])
    _close(res[0]["dropout_losses"], world1["dropout_losses"])


def test_resume_across_world_sizes(groups):
    from vqa_tpu_torch.main import main
    cli = groups.results()[2][0]["cli"]
    assert cli["first_step"] == 2 and cli["resumed"] == cli["full"][2:]
    assert cli["orbax_resumed"] == cli["orbax"][2:] and cli["orbax"] == cli["full"]
    # the world-2 .ckpt resumes at world 1
    work = groups.work[2]
    one = main(["--mode", "train", *_cli_args(work)("world1_resumed", "--model_ckpt",
                                                    cli["ckpt"])])
    assert one["first_step"] == 2
    _close(one["losses"], cli["full"][2:])


@pytest.mark.parametrize("run", ["cached", "accum", "fsdp_accum"])
def test_cli_paths_on_the_mesh_match(groups, run):
    """--cache_features, --grad_accum 2 (DDP) and --grad_accum 2 --fsdp true
    at world 2 train as the plain world-2 run does."""
    cli = groups.results()[2][0]["cli"]
    assert len(cli[run]) == len(cli["full"]) == 4
    _close(cli[run], cli["full"])


def test_fsdp_without_tp_runs_the_fused_lstm(groups):
    """FSDP alone gathers plain tensors for the forward: the sentence LSTM
    takes the fused call on every rank, never the loop."""
    for res in groups.results()[2].values():
        calls = res["fsdp_lstm_calls"]
        assert calls["fused"] > 0 and calls["loop"] == 0


def test_vgg_train_fsdp_matches_world1(groups):
    """--vgg_train true --fsdp true at world 2 against world 1: the first 3
    steps within VGG_RTOL."""
    from vqa_tpu_torch.main import main
    cli = groups.results()[2][0]["cli"]
    one = main(["--mode", "train", *_cli_args(groups.work[2])("vgg_train1", *VGG_TRAIN)])
    np.testing.assert_allclose(cli["vgg_train"][:3], one["losses"][:3], rtol=VGG_RTOL)


def test_test_mode_pads_the_last_batch_on_the_mesh(groups):
    cli = groups.results()[2][0]["cli"]
    assert cli["test"]["samples"] == 13
    preds = open(os.path.join(groups.work[2], "preds.txt")).read().split()
    assert len(preds) == 13


# ---------------------------------------------------- 2x2: TP, FSDP, SP

def test_tp_fsdp_matches_world1_and_vqa_tpu(groups, world1, jax_losses):
    res = groups.results()[4]
    assert all(res[r]["tp_losses"] == res[0]["tp_losses"] for r in res)
    _close(res[0]["tp_losses"], world1["losses"])
    np.testing.assert_allclose(res[0]["tp_losses"], jax_losses["tp"], rtol=JAX_RTOL)
    params = torch.load(os.path.join(groups.work[4], "tp_params.pt"), weights_only=False)
    assert max(np.abs(params[k].astype(np.float64) - world1["params"][k]).max()
               for k in params) < PARAM_ATOL


def test_tp_fsdp_placements_are_the_rule_table(groups):
    res = groups.results()[4][0]
    assert res["placements"] == res["expected_placements"]
    # the Megatron pair and FSDP on the free dim, as vqa_tpu places them
    assert res["placements"]["co_attention.W_q.weight"] == ("model", "data")
    assert res["placements"]["co_attention.w_q.weight"] == (None, "model")
    assert res["placements"]["question_encoder.sentence_lstm.weight_ih_l0"] == \
        ("model", "data")
    assert res["tp_lstm_calls"]["loop"] > 0 and res["tp_lstm_calls"]["fused"] == 0


def test_seq_parallel_matches_world1_and_vqa_tpu(groups, world1, jax_losses):
    res = groups.results()[4]
    _close(res[0]["sp_losses"], world1["sp_losses"])
    np.testing.assert_allclose(res[0]["sp_losses"], jax_losses["sp"], rtol=JAX_RTOL)


def test_baseline_tp_fsdp_runs_with_replicated_gru(groups):
    res = groups.results()[4]
    losses = res[0]["baseline_losses"]
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert all(res[r]["baseline_losses"] == losses for r in res)


def test_dryrun_2x2_legs_agree(groups):
    d = groups.results()[4][0]["dryrun"]
    assert d["mesh_2d"] == (2, 2) and abs(d["tp_loss"] - d["loss"]) < 1e-2


def test_every_rank_exited_cleanly(groups):
    groups.results()
    assert [p.exitcode for p in groups.procs] == [0] * 6


# ------------------------------------------------ no spawn: rules, shards

def _flax_to_port_dims(model_name, params):
    """{port name: (leaf path, {flax dim: port dim})} from the weight bridge:
    a marker array per leaf goes through ``from_jax`` (the VGG's converters
    stubbed out: its 0.4 GB head is replicated in both packages)."""
    import jax
    from vqa_tpu_torch.models import convert
    stubs = {n: getattr(convert, n) for n in ("_vgg", "_vgg_with_head")}
    for n in stubs:
        setattr(convert, n, lambda *a, **k: None)
    try:
        return _bridge_dims(model_name, params)
    finally:
        for n, f in stubs.items():
            setattr(convert, n, f)


def _bridge_dims(model_name, params):
    import jax
    from vqa_tpu.parallel.sharding import _path_str
    from vqa_tpu_torch.models.convert import from_jax, to_port
    leaves, treedef = jax.tree_util.tree_flatten_with_path(params)
    paths = [_path_str(p) for p, _ in leaves]

    def bridge(arrays):
        tree = jax.tree_util.tree_unflatten(treedef, arrays)
        sd = from_jax(model_name, tree, _stats_like(model_name, tree))
        return to_port(sd) if model_name == "bert" else sd

    # the VGG is replicated in both packages: its leaves stay out (placeholders)
    tower = ["vgg11_encoder" in p for p in paths]
    ids = bridge([np.zeros(1, np.float32) if t else np.full(np.shape(x), i + 1, np.float32)
                  for i, ((_, x), t) in enumerate(zip(leaves, tower))])
    flat = bridge([np.zeros(1, np.float32) if t else
                   np.arange(np.size(x), dtype=np.float32).reshape(np.shape(x))
                   for (_, x), t in zip(leaves, tower)])
    out = {}
    for name, t in ids.items():
        if t.dim() == 0 or name.endswith(("running_mean", "running_var")):
            continue
        i = int(t.max()) - 1
        if i < 0:
            continue            # synthesized (the unused co_attention.W_b)
        shape = np.shape(leaves[i][1])
        v = flat[name].numpy()
        if name.endswith("word_embedding.weight"):
            v = v[1:]           # row 0 is zeroed by the bridge (flax masks it)
        base = tuple(min(1, s - 1) for s in v.shape)
        dims = {}
        for pdim in range(v.ndim):
            if v.shape[pdim] < 2:
                continue
            line = list(base)
            line[pdim] = slice(None)                # every position along this dim
            idx = np.unravel_index(v[tuple(line)].astype(np.int64), shape)
            for fdim in range(len(shape)):
                if len(np.unique(idx[fdim])) > 1:
                    dims[fdim] = pdim
        out[name] = (paths[i], shape, dims)
    return out


def _stats_like(model_name, params):
    import jax
    def bn(tree):
        if isinstance(tree, dict):
            if "scale" in tree and "bias" in tree and len(tree) == 2:
                return {"mean": np.zeros_like(tree["scale"]), "var": np.ones_like(tree["scale"])}
            return {k: bn(v) for k, v in tree.items() if isinstance(v, dict)}
        return None

    def prune(t):
        if not isinstance(t, dict):
            return t
        out = {k: prune(v) for k, v in t.items()}
        return {k: v for k, v in out.items() if not (v is None or (isinstance(v, dict) and not v))}
    return prune(bn(jax.tree_util.tree_map(np.asarray, params)))


@pytest.mark.parametrize("model_name", ["attention", "baseline", "bert"])
def test_param_spec_table_matches_vqa_tpu(model_name):
    import jax
    import jax.numpy as jnp
    from vqa_tpu.config import build_model as jax_build
    from vqa_tpu.parallel.mesh import get_mesh as j_get_mesh
    from vqa_tpu.parallel.sharding import param_spec as j_param_spec
    from vqa_tpu_torch.parallel.sharding import EXCEPTIONS, is_exception, param_spec
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8 simulated devices (conftest)")
    jm, _ = jax_build(model_name, V, K, opt_lvl=0, max_seq_length=L)
    init = {"image": jnp.zeros((1, 32, 32, 3)), "question": jnp.ones((1, L), jnp.int32),
            "ques_len": jnp.full((1,), L, jnp.int32)}
    variables = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), init["image"],
                                               init["question"], init["ques_len"]))
    params = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                                    variables["params"])
    jmesh = j_get_mesh(8, model_parallel=2)
    sizes = {"data": 4, "model": 2}
    mapping = _flax_to_port_dims(model_name, params)
    mismatched = set()
    for name, (path, shape, dims) in mapping.items():
        jspec = tuple(j_param_spec(path, shape, jmesh))
        want: dict = {}
        for fdim, axis in enumerate(jspec):
            if axis is not None:
                want.setdefault(dims[fdim], []).append(axis)
        got = param_spec(name, _port_shape(name, shape, dims), sizes)
        got_d = {d: [a] for d, a in enumerate(got) if a is not None}
        if got_d != want:
            mismatched.add(name)
            assert is_exception(name), (name, path, jspec, got)
            if re.search(r"\.gru\.", name):
                assert "model" not in got, name
    # every listed exception is real in some family
    if model_name == "baseline":
        assert any(re.search(EXCEPTIONS[0][0], n) for n in mismatched)
    if model_name == "bert":
        assert any(re.search(EXCEPTIONS[1][0], n) for n in mismatched)
    if model_name == "attention":
        assert not mismatched


def _port_shape(name, flax_shape, dims):
    """The port's shape from the flax shape and the dim mapping (merged
    flax dims multiply)."""
    n = max(dims.values()) + 1 if dims else len(flax_shape)
    shape = [1] * n
    for fdim, pdim in dims.items():
        shape[pdim] *= flax_shape[fdim]
    return tuple(shape)


def test_host_shards_are_disjoint_cover_and_vqa_tpus(tmp_path):
    from vqa_tpu.data.dataset import VQASamples as JSamples
    from vqa_tpu.data.pipeline import DataLoader as JLoader
    from vqa_tpu_torch.data.dataset import VQASamples
    from vqa_tpu_torch.data.pipeline import DataLoader
    lines = [f"img{i}.jpg\tis,the\tyes" for i in range(33)]
    f = tmp_path / "d.txt"
    f.write_text("\n".join(lines) + "\n")
    w2i = {"<PAD>": 0, "<UNKNOWN>": 1, "is": 2, "the": 3}
    samples = VQASamples(str(f), str(tmp_path), w2i, {"UNKNOWN": 0, "yes": 1}, 4)
    jsamples = JSamples(str(f), str(tmp_path), w2i, {"UNKNOWN": 0, "yes": 1}, 4)
    orders = []
    for shard in range(2):
        kw = dict(host_size=8, shuffle=True, seed=3, num_workers=0, synthetic_images=True,
                  shard_index=shard, num_shards=2)
        loader = DataLoader(samples, 4, **kw)
        order = loader._epoch_order()
        np.testing.assert_array_equal(order, JLoader(jsamples, 4, **kw)._epoch_order())
        assert len(order) == 16 and len(loader) == 4
        orders.append(set(order.tolist()))
    assert orders[0] & orders[1] == set()
    assert len(orders[0] | orders[1]) == 32
    # a rank's rows: its block of each host batch, nothing else decoded
    full = next(iter(DataLoader(samples, 4, host_size=8, num_workers=0, synthetic_images=True,
                                shuffle=False)))
    half = next(iter(DataLoader(samples, 4, host_size=8, num_workers=0, synthetic_images=True,
                                shuffle=False, rows=(1, 2))))
    np.testing.assert_array_equal(half["image"], full["image"][2:])
    np.testing.assert_array_equal(half["question"], full["question"][2:])


@pytest.mark.parametrize("flags", [
    ("--model_parallel", "2"), ("--fsdp", "true"), ("--seq_parallel", "true"),
    ("--num_devices", "2", "--seq_parallel", "true"),
    ("--model", "baseline", "--num_devices", "2", "--model_parallel", "2",
     "--seq_parallel", "true"),
    ("--num_devices", "4", "--model_parallel", "2", "--seq_parallel", "true",
     "--image_size", "96"),
])
def test_cli_mesh_checks_match_vqa_tpu(tmp_path, flags):
    """The same flags stop both CLIs with the same message."""
    import jax
    from vqa_tpu.main import main as j_main
    from vqa_tpu_torch.main import main
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8 simulated devices (conftest)")
    _write_cli_data(str(tmp_path))
    common = ["--mode", "train", "--model", "attention", "--expt_dir", str(tmp_path / "e"),
              "--expt_name", "x", "--run_name", "y", "--vocab_file",
              str(tmp_path / "vocab.pkl"), "--train_file", str(tmp_path / "train.txt"),
              "--train_img", str(tmp_path), "--synthetic_images", "true", "--num_cls", "3"]
    with pytest.raises(SystemExit) as j:
        j_main([*common, *flags])
    with pytest.raises(SystemExit) as t:
        main([*common, *flags, "--device", "cpu"])
    assert str(t.value) == str(j.value)


def test_get_mesh_errors_match_vqa_tpu():
    from vqa_tpu.parallel.mesh import get_mesh as j_get_mesh
    from vqa_tpu_torch.parallel.mesh import get_mesh
    for kwargs in ({"num_devices": 10 ** 6}, {"num_devices": 1, "model_parallel": 3}):
        with pytest.raises(ValueError) as j:
            j_get_mesh(**kwargs)
        with pytest.raises(ValueError) as t:
            get_mesh(device_type="cpu", **kwargs)
        pattern = re.sub(r"\d+", r"\\d+", re.escape(str(j.value)))
        assert re.fullmatch(pattern, str(t.value)), (str(j.value), str(t.value))
