"""Weight bridge and calibration files: vqa_tpu_torch vs vqa_tpu.

- ``models.convert.from_jax`` gives the same state dict as vqa_tpu's
  ``coattention_to_torch`` (both adjustments included), and the port's model
  loads it, and a ``save_pth`` file, with ``strict=True``;
- ``train.calibrate`` reads and writes the ``int8_calib.json`` format both
  ways, and reads ``tools/bench_calib.json`` unchanged.
Exact equality throughout: nothing here computes.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vqa_tpu.config import build_model as jax_build
from vqa_tpu.models.convert import save_pth, to_torch
from vqa_tpu.train import calibrate as j_cal
from vqa_tpu_torch.config import build_model
from vqa_tpu_torch.models.convert import from_jax, load_pth
from vqa_tpu_torch.train import calibrate as t_cal

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STAGES = (0, 1, 2, 3, 4, 5, 6, 7)
WIDTHS = (3, 64, 128, 256, 256, 512, 512, 512)


@pytest.fixture(scope="module")
def jax_attention():
    model, _ = jax_build("attention", 25, 4, opt_lvl=0)
    vs = jax.jit(model.init)({"params": jax.random.PRNGKey(3)},
                             jnp.zeros((1, 32, 32, 3)), jnp.ones((1, 5), jnp.int32),
                             jnp.ones((1,), jnp.int32))
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return to_np(vs["params"]), to_np(vs["batch_stats"])


def test_from_jax_equals_vqa_tpu_export(jax_attention):
    params, stats = jax_attention
    ref = to_torch("attention", params, stats)
    sd = from_jax("attention", params, stats)
    assert set(sd) == set(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(sd[k].numpy(), np.asarray(v), err_msg=k)
    assert np.abs(sd["question_encoder.word_embedding.weight"][0].numpy()).max() == 0.0
    assert np.abs(sd["co_attention.W_b.weight"].numpy()).max() == 0.0


def test_port_model_loads_strict(jax_attention):
    params, stats = jax_attention
    model, cfg = build_model("attention", 25, 4, opt_lvl=0, device="cpu")
    assert cfg.image_size == 448
    keys = set(model.state_dict())
    sd = from_jax("attention", params, stats)
    assert keys == set(sd)
    model.load_state_dict(sd, strict=True)
    got = model.state_dict()
    for k, v in sd.items():
        assert torch.equal(got[k], v), k


def test_save_pth_file_loads_into_port(jax_attention, tmp_path):
    params, stats = jax_attention
    path = str(tmp_path / "model.pth")
    save_pth(path, "attention", params, stats)
    model, _ = build_model("attention", 25, 4, opt_lvl=0, device="cpu")
    model.load_state_dict(load_pth(path), strict=True)
    w = model.image_encoder.vgg11_encoder[25].weight.detach().numpy()
    np.testing.assert_array_equal(
        w, params["image_encoder"]["vgg11_encoder"]["features"]["conv7"]["kernel"]
        .transpose(3, 2, 0, 1))


def test_only_attention_is_ported():
    """Named when only the attention model was ported; now all three
    families build and convert (tests/test_torch_{baseline,bert}.py hold
    them to vqa_tpu), and what stays unported for them raises: a trainable
    VGG (batch-stats BatchNorm) and an unknown name."""
    for name, size in (("attention", 448), ("baseline", 224), ("bert", 224)):
        model, cfg = build_model(name, 10, 3, device="cpu", opt_lvl=0)
        head = model.mlp_classify.W_h if name == "attention" else model.fc_final
        assert cfg.image_size == size and head.out_features == 3
        with pytest.raises(NotImplementedError, match="not ported yet"):
            build_model(name, 10, 3, device="cpu", vgg_trainable=True)
    bert, _ = build_model("bert", 10, 3, device="cpu", opt_lvl=0, max_seq_length=80)
    assert bert.question_encoder.position_embedding.shape == (80, 768)
    with pytest.raises(ValueError, match="unknown model"):
        from_jax("resnet", {}, {})
    with pytest.raises(KeyError):
        build_model("resnet", 10, 3, device="cpu")


def _amax(seed=0):
    rng = np.random.default_rng(seed)
    return tuple(tuple(float(v) for v in rng.random(c) + 0.5) for c in WIDTHS)


def test_calib_sidecar_round_trips_between_packages(tmp_path):
    amax = _amax()
    a, b = tmp_path / "a", tmp_path / "b"
    a.mkdir(), b.mkdir()
    t_cal.save_calib(str(a), STAGES, amax)
    assert j_cal.load_calib(str(a), STAGES) == amax
    j_cal.save_calib(str(b), STAGES, amax)
    assert t_cal.load_calib(str(b), STAGES) == amax
    assert t_cal.load_calib(str(b), (2, 3)) is None          # stale stage set
    assert (a / t_cal.CALIB_FILE).read_text() == (b / j_cal.CALIB_FILE).read_text()


def test_bench_calib_reads_unchanged():
    path = os.path.join(REPO, "tools", "bench_calib.json")
    with open(path) as f:
        raw = json.load(f)["attention"]
    amax = t_cal.load_calib_file(path, tuple(raw["stages"]), "attention")
    assert amax == tuple(tuple(float(x) for x in v) for v in raw["amax"])
    assert [len(a) for a in amax] == list(WIDTHS)
    with pytest.raises(ValueError, match="calibrated for int8 stages"):
        t_cal.load_calib_file(path, (2, 3), "attention")


def test_amax_tuple_order_and_missing():
    by_stage = {s: np.full(c, s + 1.0, np.float32) for s, c in zip(STAGES, WIDTHS)}
    assert t_cal.amax_tuple(STAGES, by_stage) == j_cal.amax_tuple(STAGES, by_stage)
    del by_stage[3]
    with pytest.raises(ValueError, match="missed stages"):
        t_cal.amax_tuple(STAGES, by_stage)
