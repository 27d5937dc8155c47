"""The port's frozen-tower feature cache (vqa_tpu_torch.data.feature_cache,
``--cache_features``) vs the uncached path and vqa_tpu's cache.

The cache must be invisible to the numbers: it stores exactly what the head
receives on the uncached path, in its dtype, so cached logits and
train-mode losses (dropout live) equal uncached ones bit for bit. Its rows
agree with vqa_tpu's encoder on weights carried across by ``from_jax``:
fp32 within 1e-5 of the largest feature, int8 (applied eagerly, BatchNorm
variances where XLA's ``rsqrt`` is exact) bit for bit. Images are
hash-seeded synthetic images (the file names are missing), at 32² and 64².
The baseline and bert models run here with a narrow stand-in for the VGG's
25,088 -> 4,096 -> 4,096 classifier head (same layers and dropouts, a
16-wide hidden layer), patched in by the test: the head's width does not
change what the cache does.
"""

import os

import numpy as np
import pytest
import torch
import torch.nn as nn

import jax
import jax.numpy as jnp

from test_torch_vgg import parity_safe_variables
from vqa_tpu.config import build_model as jax_build
from vqa_tpu.data import feature_cache as j_fc
from vqa_tpu.data.dataset import VQASamples as JaxSamples
from vqa_tpu.data.pipeline import make_image_preprocessor as j_preprocessor
from vqa_tpu.models.coattention import ImageCoAttentionEncoder as JaxImageEncoder
from vqa_tpu_torch.config import build_model
from vqa_tpu_torch.data.dataset import VQASamples
from vqa_tpu_torch.data.feature_cache import FeatureCache, build_or_open
from vqa_tpu_torch.data.images import decode_batch
from vqa_tpu_torch.data.pipeline import DataLoader, make_image_preprocessor
from vqa_tpu_torch.main import _make_feature_encoder
from vqa_tpu_torch.main import main as t_main
from vqa_tpu_torch.models import vgg as t_vgg
from vqa_tpu_torch.models.convert import from_jax
from vqa_tpu_torch.models.layers import Dropout
from vqa_tpu_torch.train.calibrate import calibrate_model
from vqa_tpu_torch.train.state import create_train_state
from vqa_tpu_torch.train.steps import make_train_step

V, K, L = 20, 4, 5
WORD2IDX = {"<PAD>": 0, "<UNKNOWN>": 1, **{f"w{i}": i for i in range(2, V)}}
LABEL2IDX = {"UNKNOWN": 0, "yes": 1, "no": 2, "two": 3}


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """12 questions over 5 images (train), 6 over 3 others (val)."""
    root = tmp_path_factory.mktemp("fc")
    answers = ["yes", "no", "two"]
    train = [f"img{i % 5}.jpg\tw{2 + i % 7},w{3 + i % 5},w9\t{answers[i % 3]}"
             for i in range(12)]
    val = [f"val{i % 3}.jpg\tw{4 + i % 4},w5\t{answers[(i + 1) % 3]}" for i in range(6)]
    (root / "train.txt").write_text("\n".join(train) + "\n")
    (root / "val.txt").write_text("\n".join(val) + "\n")
    return root


def _samples(data, name="train.txt", cls=VQASamples):
    return cls(str(data / name), str(data), WORD2IDX, LABEL2IDX, L)


class _NarrowHead(nn.Sequential):
    """``VGGClassifierHead``'s layers at a 16-wide hidden layer."""

    def __init__(self, generator=None):
        fc0, fc1 = nn.Linear(512 * 7 * 7, 16), nn.Linear(16, 4096)
        with torch.no_grad():
            for fc in (fc0, fc1):
                fc.weight.normal_(0.0, 0.01, generator=generator)
                fc.bias.zero_()
        super().__init__(nn.Flatten(), fc0, nn.ReLU(), Dropout(0.5), fc1, nn.ReLU(),
                         Dropout(0.5))


@pytest.fixture
def narrow_head(monkeypatch):
    monkeypatch.setattr(t_vgg, "VGGClassifierHead", _NarrowHead)


def _model(name, opt_lvl=0, int8=False, seed=0):
    model, _ = build_model(name, V, K, opt_lvl=opt_lvl, int8_backbone=int8, device="cpu",
                           max_seq_length=L, generator=torch.Generator().manual_seed(seed))
    return model


def _build(model, name, samples, root, size, **kw):
    pre = make_image_preprocessor(size, model.dtype, "cpu")
    encode, fp, boundary = _make_feature_encoder(name, model, pre)
    logs = []
    cache = build_or_open(str(root), samples, encode, fingerprint=fp, image_size=size,
                          dtype=model.dtype, boundary=boundary, batch_size=2,
                          host_size=size, num_workers=2, synthetic_images=True,
                          log=logs.append, **kw)
    return cache, encode, pre, logs


def _pixels(samples, names, size):
    return decode_batch([os.path.join(samples.img_dir, n) for n in names], size,
                        synthetic_fallback=True)


def test_build_open_gather(data, tmp_path):
    samples = _samples(data)
    model = _model("attention")
    cache, encode, _, logs = _build(model, "attention", samples, tmp_path, 64)
    names = sorted(set(samples.image_names))
    assert "built" in logs[-1] and len(names) == 5           # 3 batches of 2, tail padded
    assert set(cache.meta) == {"names", "feature_shape", "dtype", "fingerprint", "boundary",
                               "image_size"}                # vqa_tpu's keys
    assert cache.meta["dtype"] == "float32" and cache.feature_shape == (4, 512)
    assert cache.meta["boundary"] == "coattn_image_encoder"
    assert sorted(os.listdir(cache.cache_dir)) == ["features.bin", "meta.json"]
    direct = encode(_pixels(samples, names, 64))
    assert torch.equal(cache.rows(names), direct)
    assert torch.equal(cache.rows(names[::-1]), direct.flip(0))
    again, _, _, logs = _build(model, "attention", samples, tmp_path, 64)
    assert "reusing" in logs[-1] and again.build_seconds is None
    assert again.cache_dir == cache.cache_dir and torch.equal(again.rows(names), direct)
    reopened = FeatureCache(cache.cache_dir)
    assert torch.equal(reopened.gather(np.array([4, 0])), direct[[4, 0]])


def test_fingerprint_follows_the_tower_not_the_head(data):
    model = _model("attention")
    pre = make_image_preprocessor(32, model.dtype, "cpu")

    def fp():
        return _make_feature_encoder("attention", model, pre)[1]

    fp0 = fp()
    with torch.no_grad():
        model.mlp_classify.W_h.weight.add_(1.0)
        model.question_encoder.word_embedding.weight.add_(1.0)
        assert fp() == fp0
        for tensor in (model.vgg[0].weight, model.vgg[4].bias, model.vgg[1].running_var,
                       model.vgg[5].running_mean):
            old = tensor.clone()
            tensor.view(-1)[0] += 0.5
            assert fp() != fp0
            tensor.copy_(old)
            assert fp() == fp0


@pytest.mark.parametrize("kw", [dict(int8_backbone=True), dict(int8_backbone=False),
                                dict(int8_backbone=True, int8_stages_override=(0, 2, 3)),
                                dict(int8_backbone=True, fused_stem=False, int8_handoff=False)],
                         ids=["int8", "float", "stages-0-2-3", "unfused"])
def test_boundary_matches_vqa_tpu(kw):
    """The int8 tag names the same stages, kernels and calibration as
    vqa_tpu's (main.py:340-384), before and after calibration."""
    from vqa_tpu.main import _make_feature_encoder as j_make_encoder

    jm, _ = jax_build("attention", V, K, opt_lvl=1, **kw)
    tm, _ = build_model("attention", V, K, opt_lvl=1, device="cpu", **kw)
    # the boundary does not read the values: zeros of the init's shapes
    shapes = jax.eval_shape(jm.init, {"params": jax.random.PRNGKey(0)},
                            jnp.zeros((1, 32, 32, 3)), jnp.ones((1, L), jnp.int32),
                            jnp.ones((1,), jnp.int32))
    variables = jax.tree_util.tree_map(lambda a: np.zeros(a.shape, a.dtype), shapes)
    rng = np.random.default_rng(1)
    widths = (3, 64, 128, 256, 256, 512, 512, 512)
    amax = tuple(tuple(float(v) for v in rng.random(widths[s]) + 0.5) for s in jm.int8_stages)
    for a in ((), amax):
        jm, tm.int8_amax = jm.clone(int8_amax=a), a
        want = j_make_encoder("attention", jm, variables, lambda x: x)[2]
        assert _make_feature_encoder("attention", tm, lambda x: x)[2] == want
    assert want.startswith("coattn_image_encoder") and ("@" in want) == bool(amax)


def test_distinct_datasets_get_distinct_dirs(data, tmp_path):
    model = _model("attention")
    train, _, _, _ = _build(model, "attention", _samples(data), tmp_path, 32)
    val, _, _, _ = _build(model, "attention", _samples(data, "val.txt"), tmp_path, 32)
    assert train.cache_dir != val.cache_dir
    assert val.meta["names"] == ["val0.jpg", "val1.jpg", "val2.jpg"]
    assert len(os.listdir(tmp_path)) == 2


def test_bf16_round_trips_exactly(data, tmp_path):
    samples = _samples(data)
    model = _model("attention", opt_lvl=1)          # float route, bf16 compute
    cache, encode, _, _ = _build(model, "attention", samples, tmp_path, 64)
    names = sorted(set(samples.image_names))
    direct = encode(_pixels(samples, names, 64))
    rows = cache.rows(names)
    assert direct.dtype == rows.dtype == torch.bfloat16 and cache.meta["dtype"] == "bfloat16"
    assert cache.features.dtype == np.uint16
    assert os.path.getsize(os.path.join(cache.cache_dir, "features.bin")) == 5 * 4 * 512 * 2
    assert torch.equal(rows.view(torch.int16), direct.view(torch.int16))


CASES = [("attention", 0, False), ("attention", 1, True), ("baseline", 0, False),
         ("bert", 1, False)]


@pytest.mark.parametrize("name,opt_lvl,int8", CASES,
                         ids=["attention-f32", "attention-int8", "baseline-f32", "bert-bf16"])
def test_cached_logits_equal_direct(data, tmp_path, narrow_head, name, opt_lvl, int8):
    samples = _samples(data)
    model = _model(name, opt_lvl=opt_lvl, int8=int8).eval()
    names = sorted(set(samples.image_names))
    pre = make_image_preprocessor(32, model.dtype, "cpu")
    if int8:
        calibrate_model(name, model, pre, [_pixels(samples, names, 32)])
    cache, _, _, _ = _build(model, name, samples, tmp_path, 32)
    dtype = model.dtype
    assert cache.dtype == dtype
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.integers(2, V, (5, L))).long()
    lens = torch.from_numpy(rng.integers(1, L + 1, 5)).long()
    with torch.no_grad():
        direct = model(pre(_pixels(samples, names, 32)), q, lens)
        cached = model(cache.rows(names), q, lens, image_is_features=True)
    assert torch.equal(cached, direct)


def test_train_losses_with_dropout_equal_cached(data, tmp_path, narrow_head):
    """Baseline in train mode: its three dropouts live, the classifier head
    in the step on cached rows; the same masks, losses and weights."""
    samples = _samples(data)
    cache, _, pre, _ = _build(_model("baseline"), "baseline", samples, tmp_path, 32)
    assert cache.meta["boundary"] == "vgg11_features" and cache.feature_shape == (1, 1, 512)
    rng = np.random.default_rng(4)
    batches = [rng.integers(0, len(samples), 4) for _ in range(3)]

    def run(cached):
        state = create_train_state(_model("baseline"), 1e-3, seed=7)
        step = make_train_step(image_is_features=cached)
        losses = []
        for idx in batches:
            names = [samples.image_names[i] for i in idx]
            image = cache.rows(names) if cached else pre(_pixels(samples, names, 32))
            batch = {"image": image,
                     "question": torch.from_numpy(samples.questions[idx]).long(),
                     "ques_len": torch.from_numpy(samples.ques_len[idx]).long(),
                     "label": torch.from_numpy(samples.labels[idx]).long()}
            losses.append(step(state, batch)["loss"].item())
        return losses, state.model.state_dict()

    (a, wa), (b, wb) = run(False), run(True)
    assert a == b and len(set(a)) == 3
    assert all(torch.equal(wa[k], wb[k]) for k in wa)
    with pytest.raises(ValueError, match="running-stats"):
        make_train_step(image_is_features=True, bn_batch_stats=True)


@pytest.mark.parametrize("route", ["float32", "int8"])
def test_cache_rows_match_vqa_tpu(data, tmp_path, route):
    """Both packages' build passes over the same images and weights."""
    params, stats = parity_safe_variables(jax_build("attention", V, K, opt_lvl=0)[0], seed=11)
    int8 = route == "int8"
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if int8 else (jnp.float32, torch.float32)
    amax = ()
    if int8:
        rng = np.random.default_rng(2)
        amax = tuple(tuple(float(v) for v in rng.random(c) * 2 + 0.5)
                     for c in (3, 64, 128, 256, 256, 512, 512, 512))
        enc = JaxImageEncoder(conv0_pallas=True, int8_stages=tuple(range(8)), int8_amax=amax,
                              hpack_pool=True, fused_stem=True, int8_handoff=True, dtype=jdt)
    else:
        enc = JaxImageEncoder(conv0_pallas=True, dtype=jdt)
    v = {"params": params["image_encoder"], "batch_stats": stats["image_encoder"]}
    j_pre = j_preprocessor(32, jdt)
    j_cache = j_fc.build_or_open(
        str(tmp_path / "jax"), _samples(data, cls=JaxSamples),
        lambda u8: enc.apply(v, j_pre(u8)), fingerprint="f", image_size=32, dtype=jdt,
        boundary="b", batch_size=2, host_size=32, synthetic_images=True,
        decode_backend="pil", log=lambda s: None)
    model = _model("attention", opt_lvl=1 if int8 else 0, int8=int8)
    model.load_state_dict(from_jax("attention", params, stats), strict=True)
    model.int8_amax = amax
    cache, _, _, _ = _build(model, "attention", _samples(data), tmp_path / "port", 32,
                            decode_backend="pil")
    names = j_cache.meta["names"]
    assert cache.meta["names"] == names and cache.meta["dtype"] == j_cache.meta["dtype"]
    assert list(cache.feature_shape) == j_cache.meta["feature_shape"]
    ref, rows = j_cache.rows(names), cache.rows(names)
    assert rows.dtype == tdt
    if int8:
        np.testing.assert_array_equal(rows.view(torch.int16).numpy().view(np.uint16),
                                      ref.view(np.uint16))
    else:
        np.testing.assert_allclose(rows.numpy(), ref, rtol=0, atol=1e-5 * np.abs(ref).max())


def test_loader_yields_feature_batches(data, tmp_path):
    samples = _samples(data)
    cache, _, _, _ = _build(_model("attention"), "attention", samples, tmp_path, 32)
    loader = DataLoader(samples, 4, host_size=32, shuffle=False, feature_cache=cache)
    assert loader._pool is None
    batches = list(loader)
    assert len(batches) == 3
    for i, batch in enumerate(batches):
        names = samples.image_names[4 * i:4 * i + 4]
        assert batch["image"].dtype == torch.float32 and tuple(batch["image"].shape) == (4, 1, 512)
        assert torch.equal(batch["image"], cache.rows(names))
        assert np.array_equal(batch["label"], samples.labels[4 * i:4 * i + 4])
    loader.close()


def _cli(data, run, *extra):
    return ["--model", "attention", "--expt_dir", str(data / "runs"), "--expt_name", "e",
            "--run_name", run, "--train_img", str(data), "--train_file", str(data / "train.txt"),
            "--val_img", str(data), "--val_file", str(data / "val.txt"),
            "--vocab_file", str(data / "vocab.pkl"), "--batch_size", "3", "--num_epochs", "1",
            "--num_cls", "3", "--synthetic_images", "true", "--image_size", "32",
            "--device", "cpu", "--opt_lvl", "0", "--num_workers", "2", "--log_interval", "2",
            "--val_size", "3", "--save_interval", "4", *extra]


def test_cli_cached_training_matches_uncached(data, capsys):
    import pickle

    vocab = {"word2idx": WORD2IDX, "idx2word": {i: w for w, i in WORD2IDX.items()},
             "label2idx": LABEL2IDX, "idx2label": {i: a for a, i in LABEL2IDX.items()},
             "max_seq_length": L}
    (data / "vocab.pkl").write_bytes(pickle.dumps(vocab))
    cache_dir = str(data / "cache")
    plain = t_main(["--mode", "train", *_cli(data, "plain")])
    assert plain["feature_caches"] == [] and plain["decode_backend"] == "native"
    capsys.readouterr()
    built = t_main(["--mode", "train", *_cli(data, "built", "--cache_features", "true",
                                             "--cache_dir", cache_dir)])
    assert capsys.readouterr().out.count("feature cache: built") == 2
    reused = t_main(["--mode", "train", *_cli(data, "reused", "--cache_features", "true",
                                              "--cache_dir", cache_dir)])
    assert capsys.readouterr().out.count("feature cache: reusing") == 2
    assert plain["steps"] == 4 and plain["eval_batches"] == built["eval_batches"] > 0
    assert built["losses"] == plain["losses"] == reused["losses"]
    assert all(c.build_seconds is None for c in reused["feature_caches"])
    res = t_main(["--mode", "test", *_cli(data, "built", "--cache_features", "true",
                                          "--model_ckpt", "model_4.ckpt")])
    assert "NOTE: --cache_features is a training-loop feature" in capsys.readouterr().out
    assert res["samples"] == 6


@pytest.mark.parametrize("flags", [("--vgg_train", "true"), ("--bn_mode", "batch")])
def test_cache_features_refuses_a_tower_that_changes(data, flags):
    with pytest.raises(SystemExit, match="--cache_features requires"):
        t_main(["--mode", "train", *_cli(data, "refused", "--cache_features", "true", *flags)])
