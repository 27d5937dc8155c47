"""The plain reference against the port, on the CPU at a small size, on the
same seeded weights and inputs. The tests may import the port; the
reference may not (``test_vqabench_guard``)."""

from __future__ import annotations

import pytest
import torch
from vqabench_tiny import cpu_threads, tiny_cell

from vqabench import harness, inputs
from vqabench.reference import steps as ref_steps
from vqabench.reference import tower, weights

MODELS = {"attention": "attention.train.b160", "baseline": "baseline.train.b160"}


def port_rounding_fold(weights_: dict, prefix: str, i: int):
    """The BN fold rounded as the port rounds it (the square root in float64,
    then a reciprocal), so that both towers quantize the same weights and
    the comparison sees the rest of the arithmetic."""
    c, b = tower.CONV_INDEX[i], tower.CONV_INDEX[i] + 1
    v = weights_[f"{prefix}{b}.running_var"].float() + torch.tensor(1e-5)
    root = torch.sqrt(v.double()).float()
    f = weights_[f"{prefix}{b}.weight"].float() * (torch.ones_like(root) / root)
    bias = (weights_[f"{prefix}{c}.bias"] - weights_[f"{prefix}{b}.running_mean"]) * f \
        + weights_[f"{prefix}{b}.bias"]
    return weights_[f"{prefix}{c}.weight"] * f[:, None, None, None], bias


def port_rounding_preprocess(images_u8, dtype=torch.float32):
    """The normalization rounded as the port rounds it (x / 255 - mean
    exact in float64, rounded once, times the float32 reciprocal of std,
    then rounded to ``dtype``)."""
    inv255 = torch.tensor(1.0, dtype=torch.float32) / torch.tensor(255.0, dtype=torch.float32)
    mean = torch.tensor(tower.MEAN, dtype=torch.float32)
    inv_std = torch.ones(3) / torch.tensor(tower.STD, dtype=torch.float32)
    x = (images_u8.double() * inv255.double() - mean.double()).float()
    return tower.rounded(x * inv_std, dtype)


def _port(cfg: dict, w: dict, images):
    """The port's model at ``cfg``'s ``opt_lvl`` on the int8 route, with ``w``
    loaded and its static scales calibrated on ``images``."""
    from vqa_tpu_torch.config import build_model
    from vqa_tpu_torch.data.pipeline import make_image_preprocessor
    from vqa_tpu_torch.train.calibrate import calibrate_model

    model, _ = build_model(cfg["model"], cfg["vocab_size"], cfg["num_classes"], device="cpu",
                           opt_lvl=cfg["opt_lvl"], int8_backbone=True,
                           max_seq_length=cfg["max_seq_length"])
    model.load_state_dict(w, strict=True)
    model.eval()
    pre = make_image_preprocessor(cfg["image_size"], ref_steps.compute_dtype(cfg), "cpu")
    calibrate_model(cfg["model"], model, pre, [images], log=lambda s: None)
    return model, pre


@pytest.fixture(scope="module", params=sorted(MODELS))
def setting(request):
    cpu_threads()
    cfg = tiny_cell(MODELS[request.param], opt_lvl=0, limits={}).config
    w = weights.make(cfg, 11, "cpu")
    images = inputs.image_ring(11, 2, 1, 4, cfg["image_size"], "cpu")[0]
    model, pre = _port(cfg, w, images)
    with ref_steps.strict():
        yield cfg, w, images, model, pre


def test_weights_load_into_the_port(setting):
    """The seeded weights are the port's whole state dict: strict loading
    passed, and every BatchNorm variance is positive."""
    cfg, w, _, model, _ = setting
    assert set(w) == set(model.state_dict())
    assert all(float(v.min()) > 0 for k, v in w.items() if k.endswith("running_var"))


@pytest.mark.parametrize("opt_lvl", (0, 1))
def test_tower_bit_equal_on_the_port_fold(setting, opt_lvl, monkeypatch):
    """Given the port's BN-folded weights, the reference's calibration and
    int8 tower give the port's amax and tower output bit for bit from the
    same images, in float32 (``--opt_lvl`` 0) and with bfloat16 compute
    (``--opt_lvl`` 1, as the cells run): the same normalization and
    rounding, quantization, integer sums, epilogue, pools and hand-offs.
    (In float32 the normalization is rounded as the port rounds it; in
    bfloat16 the reference's own gives the port's values.)"""
    cfg, w, images, _, _ = setting
    cfg = {**cfg, "opt_lvl": opt_lvl}
    monkeypatch.setattr(tower, "folded", port_rounding_fold)
    if opt_lvl == 0:
        monkeypatch.setattr(tower, "preprocess", port_rounding_preprocess)
    with torch.backends.cudnn.flags(enabled=False):
        model, pre = _port(cfg, w, images)
    vgg = model.vgg
    assert torch.equal(tower.preprocess(images, ref_steps.compute_dtype(cfg)),
                       pre(images).float())
    amax = ref_steps.calibrate(cfg, w, images, "cpu")
    for got, want in zip(amax, vgg.int8_amax):
        assert torch.equal(got, torch.tensor(want, dtype=torch.float32))
    ref = ref_steps.tower_out(cfg, w, amax, images, "cpu")
    with torch.no_grad():
        assert torch.equal(ref, vgg(pre(images)).float())


def test_tower_matches_the_port(setting):
    """End to end from the images, each side folding and calibrating on its
    own: a handful of rounding-boundary flips, nothing more."""
    cfg, w, images, model, pre = setting
    amax = ref_steps.calibrate(cfg, w, images, "cpu")
    ref = ref_steps.tower_out(cfg, w, amax, images, "cpu")
    with torch.no_grad():
        prog = model.vgg(pre(images)).float()
    assert float((ref - prog).abs().max()) < 0.03 * float(ref.abs().max())


def test_head_matches_the_port(setting):
    """On the same tower output, the reference's logits are the port's
    float32 logits to rounding, quirks included."""
    cfg, w, images, model, pre = setting
    m = weights.model_module(cfg["model"])
    with torch.no_grad():
        feats = model.vgg(pre(images)).float()
    ids, lens = inputs.questions(cfg, tiny_cell(MODELS[cfg["model"]]).traffic, 11, 3, 1, 4)
    ids, lens = torch.tensor(ids[0]).long(), torch.tensor(lens[0]).long()
    with torch.no_grad():
        if cfg["model"] == "attention":
            prog = model.head(feats.reshape(feats.shape[0], -1, feats.shape[-1]), ids, lens)
        else:
            prog = model.head(model.image_encoder.vgg11_encoder.from_features(feats), ids, lens)
        ref = m.logits(w, feats, ids, lens)
    torch.testing.assert_close(ref, prog, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", sorted(MODELS.values()))
def test_training_follows_the_port_in_float32(name, monkeypatch):
    """The reference's three Adam steps (dropout masks drawn as the port
    draws them) against the port's own at --opt_lvl 0, through the cell's
    set-up, the BN fold and the normalization rounded alike: the numbers
    the check compares are rounding."""
    cpu_threads()
    monkeypatch.setattr(tower, "folded", port_rounding_fold)
    monkeypatch.setattr(tower, "preprocess", port_rounding_preprocess)
    c = tiny_cell(name, opt_lvl=0, limits={})
    loop = harness.load_module("traffic", c.traffic["loop"]).Loop(c, 23, "cpu")
    loop.setup()
    loop.release()
    numbers = loop.numbers(loop.outputs, loop.reference())
    assert max(numbers.values()) < 1e-3, numbers
