"""The port's timing probes (``vqa_tpu_torch.tools``) against the JAX
package's Pallas probes (``tools/exp_*.py``, rows 6a-6k of PERF.md's table).

Each JAX probe is loaded from its file under a name of its own (the probes
live outside the package), as tests/test_torch_coattention_kernel.py loads
the retired co-attention kernel: ``vqa_tpu.compile_cache.
setup_compilation_cache`` is patched to a no-op first (three probes call it
at import), ``EXP_CHECK`` is set where a probe reads it (their CPU check
mode: interpret mode, small shapes) and ``sys.path`` is restored after. Its
Pallas kernel runs in interpret mode on the CPU; 6j's ``rate`` times the
kernel on a TPU, so its ``_kernel`` is called through a ``pallas_call``
built here with plain block specs. The same numpy-seeded inputs go through
the port probe's function on the CPU, i.e. the kernels' plain versions.
The H-pair-packed hand-offs of the JAX side (P[q, w, 64r + c] =
x[2q + r, w, c]) are packed or unpacked to the port's NHWC before a
comparison.

Tolerances, stated once:

- int8 outputs (6b, 6h, 6i): at most 1 unit apart, in at most
  max(1, 1e-4 n) of the n elements (the jitted probes may contract
  ``acc * scale + b`` into an FMA and multiply by 1 / s where the port
  divides: a moved rounding tie). Their conv0 inputs are f32 here: with
  bf16 values, x / s_x lands on a rounding tie often, and XLA's jitted
  division by a static scale (a reciprocal) moves such ties in x's
  quantization, each by one input unit that shifts several outputs (the
  JAX package's own unjitted int8 reference divides, as the port does);
- bf16 outputs of int8 routes (6c, 6d, 6e, 6f, 6g, 6k): within 1 bf16 ulp
  taken at |output| + |bias| (the same FMA);
- bf16 routes (6a, 6d, 6e, 6f): within ``conv0_f_bound`` / ``conv3x3_f_bound``
  of the port's plain version (the sums in another order);
- 6j: equal, on random integers in [-8, 8] (every sum exact).
"""

import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

import vqa_tpu.compile_cache
from vqa_tpu_torch.ops import conv_hpack, conv_stage1
from vqa_tpu_torch.ops.mma_rate import mma_rate_plain
from vqa_tpu_torch.ops.quant import weight_quant
from vqa_tpu_torch.tools import (PROBES, exp_conv0, exp_fuse01, exp_hpack_tap, exp_nhwc_tap,
                                 exp_ptap, exp_r4_bblk, exp_r5_conv0, exp_r5_kdepth,
                                 exp_r5_mosaic_dot, exp_tapconv)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def load(monkeypatch):
    """load(name): tools/<name>.py as a fresh module, in its CPU check mode."""
    monkeypatch.setattr(vqa_tpu.compile_cache, "setup_compilation_cache", lambda *a, **k: None)
    monkeypatch.setattr(sys, "path", list(sys.path))
    monkeypatch.setenv("EXP_CHECK", "1")
    monkeypatch.delenv("EXP_TAPS", raising=False)
    monkeypatch.delenv("EXP_RBLK", raising=False)

    def _load(name):
        spec = importlib.util.spec_from_file_location(f"vqa_tpu_probe_{name}",
                                                      os.path.join(REPO, "tools", f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    return _load


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy() if a.dtype == torch.bfloat16 else a.numpy()
    return np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a)


def _pack_pairs(x):
    """NHWC [B, H, W, C] -> the TPU's H-pair packing [B, H/2, W, 2C]."""
    b, h, w, c = x.shape
    return x.reshape(b, h // 2, 2, w, c).transpose(0, 1, 3, 2, 4).reshape(b, h // 2, w, 2 * c)


def _unpack_pairs(p):
    b, q, w, c2 = p.shape
    return p.reshape(b, q, w, 2, c2 // 2).transpose(0, 1, 3, 2, 4).reshape(b, 2 * q, w, c2 // 2)


def assert_int8_close(ref, out):
    ref, out = _np(ref).astype(np.int32), _np(out).astype(np.int32)
    assert ref.shape == out.shape
    diff = np.abs(ref - out)
    assert diff.max() <= 1
    assert np.count_nonzero(diff) <= max(1, 1e-4 * diff.size), np.count_nonzero(diff)


def assert_within_bf16_ulp(ref, out, bias):
    ref, out = _np(ref).astype(np.float64), _np(out).astype(np.float64)
    assert ref.shape == out.shape
    mag = np.maximum(np.abs(ref), np.abs(out)) + np.abs(np.asarray(bias, np.float64))
    ulp = np.exp2(np.floor(np.log2(np.maximum(mag, 1e-38))) - 7)
    assert np.all(np.abs(ref - out) <= ulp), float(np.max(np.abs(ref - out) / ulp))


def assert_within(ref, out, bound):
    diff = np.abs(_np(ref).astype(np.float64) - _np(out).astype(np.float64))
    assert diff.shape == tuple(bound.shape)
    assert np.all(diff <= bound.numpy()), float(np.max(diff - bound.numpy()))


def _conv_case(seed, b=2, h=16, c=16, o=32):
    """The TPU probes' conv inputs at a small size: relu(normal) x (bf16
    on both sides), 0.05 normal w, 0.1 normal b."""
    rng = np.random.default_rng(seed)
    x = np.maximum(rng.standard_normal((b, h, h, c)), 0).astype(np.float32)
    x = np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))       # bf16 values
    w = (rng.standard_normal((3, 3, c, o)) * 0.05).astype(np.float32)
    bias = (rng.standard_normal(o) * 0.1).astype(np.float32)
    return x, w, bias


def _torch(x, w, bias):
    return torch.from_numpy(x).bfloat16(), torch.from_numpy(w), torch.from_numpy(bias)


def _jax(x, w, bias):
    return jnp.asarray(x, jnp.bfloat16), jnp.asarray(w), jnp.asarray(bias)


def test_every_row6_probe_has_a_port():
    rows = sorted(r for v in PROBES.values() for r in v.split(", "))
    assert rows == [f"6{c}" for c in "abcdefghijk"]
    for name in PROBES:
        assert os.path.exists(os.path.join(REPO, "tools", f"{name}.py"))


def test_6a_conv0_matches_jax_probe(load):
    """exp_conv0: vqa_tpu's bf16 conv0 kernel with the probe's planar store
    (``bdot_planar_raw``, unpacked to NHWC) and NHWC store (``bdot``) vs the
    port's kernel C route (its plain version here), within conv0_f_bound."""
    mod = load("exp_conv0")
    x, w, b = (t.cpu() for t in exp_conv0.inputs("cpu", 2, 32))
    xj, wj, bj = (jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in (x, w, b))
    planar = mod.cs._conv0_pallas(xj, wj, bj, variant="bdot_planar_raw", interpret=True)
    nhwc = mod.cs._conv0_pallas(xj, wj, bj, variant="bdot", interpret=True)
    out = exp_conv0.conv0(x, w, b)
    assert out.dtype == torch.bfloat16 and tuple(out.shape) == (2, 16, 16, 64)
    bound = conv_stage1.conv0_f_bound(x, w, out)
    assert_within(jnp.transpose(planar, (0, 2, 3, 1)), out, bound)
    assert_within(nhwc, out, bound)


def _conv0_case(seed, h=32):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, h, h, 3)).astype(np.float32)
    w = (rng.standard_normal((3, 3, 3, 64)) * 0.2).astype(np.float32)
    b = (rng.standard_normal(64) * 0.1).astype(np.float32)
    s_x = tuple(float(v) for v in np.maximum(np.abs(x).reshape(-1, 3).max(0), 1e-12) / 127)
    s1 = tuple(float(v) for v in np.linspace(0.004, 0.02, 64))
    return x, w, b, s_x, s1


def test_6b_conv0_hand_off_matches_jax_probe(load):
    """exp_fuse01.conv0_i8_packed: the H-pair-packed int8 hand-off vs kernel
    A's requant epilogue (plain version), the JAX side unpacked."""
    mod = load("exp_fuse01")
    x, w, b, s_x, s1 = _conv0_case(1)
    ref = mod.conv0_i8_packed(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), s_x, s1)
    out = exp_fuse01.conv0_i8_packed(torch.from_numpy(x), torch.from_numpy(w),
                                     torch.from_numpy(b), s_x, s1)
    assert out.dtype == torch.int8 and tuple(out.shape) == (2, 16, 16, 64)
    assert_int8_close(_unpack_pairs(np.asarray(ref)), out)


def test_6c_conv1_on_hand_off_matches_jax_probe(load):
    """exp_fuse01.hpack_packed on the packed int8 hand-off vs kernel B
    pooled (plain version) on the NHWC one."""
    mod = load("exp_fuse01")
    rng = np.random.default_rng(2)
    x_q = rng.integers(-127, 128, (2, 16, 16, 64)).astype(np.int8)
    w = (rng.standard_normal((3, 3, 64, 128)) * 0.05).astype(np.float32)
    b = (rng.standard_normal(128) * 0.1).astype(np.float32)
    s1 = tuple(float(v) for v in np.linspace(0.004, 0.02, 64))
    ref = mod.hpack_packed(jnp.asarray(_pack_pairs(x_q)), jnp.asarray(w), jnp.asarray(b), s1)
    out = exp_fuse01.hpack_packed(torch.from_numpy(x_q), torch.from_numpy(w),
                                  torch.from_numpy(b), s1)
    assert out.dtype == torch.bfloat16 and tuple(out.shape) == (2, 8, 8, 128)
    assert_within_bf16_ulp(ref, out, b)


@pytest.mark.parametrize("int8", [True, False])
def test_6d_pooled_conv1_matches_jax_probe(load, int8):
    """exp_hpack_tap.conv1_hpack_pool (H-pair-packed taps, fused pool) vs
    kernel B (int8) or D (bf16), plain versions."""
    mod = load("exp_hpack_tap")
    x, w, b = _conv_case(3)
    ref = mod.conv1_hpack_pool(*_jax(x, w, b), int8=int8, interpret=True)
    xt, wt, bt = _torch(x, w, b)
    out = exp_hpack_tap.conv1_hpack_pool(xt, wt, bt, int8=int8)
    assert out.dtype == torch.bfloat16 and tuple(out.shape) == (2, 8, 8, 32)
    if int8:
        assert_within_bf16_ulp(ref, out, b)
    else:
        assert_within(ref, out, conv_hpack.conv3x3_f_bound(xt, wt, out))


@pytest.mark.parametrize("int8", [True, False])
def test_6e_unpooled_conv1_matches_jax_probe(load, int8):
    """exp_nhwc_tap.conv_nhwc_tap (no pool) vs kernel B unpooled (int8) or
    kernel D's unpooled mode (bf16), plain versions."""
    mod = load("exp_nhwc_tap")
    x, w, b = _conv_case(4)
    ref = mod.conv_nhwc_tap(*_jax(x, w, b), int8=int8, interpret=True)
    xt, wt, bt = _torch(x, w, b)
    out = exp_nhwc_tap.conv_nhwc_tap(xt, wt, bt, int8=int8)
    assert out.dtype == torch.bfloat16 and tuple(out.shape) == (2, 16, 16, 32)
    if int8:
        assert_within_bf16_ulp(ref, out, b)
    else:
        assert_within(ref, out, conv_hpack.conv3x3_f_bound(xt, wt, out, pool=False))


@pytest.mark.parametrize("int8", [True, False])
def test_6f_pooled_conv_matches_jax_probe(load, int8):
    """exp_ptap.conv_ptap_pool (row-pair slabs, fused pool) at C 32, O 64
    vs kernel B (int8) or D (bf16), plain versions."""
    mod = load("exp_ptap")
    x, w, b = _conv_case(5, c=32, o=64)
    ref = mod.conv_ptap_pool(*_jax(x, w, b), int8=int8, interpret=True)
    xt, wt, bt = _torch(x, w, b)
    out = exp_ptap.conv_ptap_pool(xt, wt, bt, int8=int8)
    assert out.dtype == torch.bfloat16 and tuple(out.shape) == (2, 8, 8, 64)
    if int8:
        assert_within_bf16_ulp(ref, out, b)
    else:
        assert_within(ref, out, conv_hpack.conv3x3_f_bound(xt, wt, out))


def test_6g_multi_sample_blocks_match_jax_probe(load):
    """exp_r4_bblk._hpack_bblk (2 samples a grid step, 4 rows) on the packed
    hand-off vs kernel B pooled (plain version) on the same int8 weights."""
    mod = load("exp_r4_bblk")
    rng = np.random.default_rng(6)
    x_q = rng.integers(-127, 128, (2, 16, 16, 64)).astype(np.int8)
    w = torch.from_numpy((rng.standard_normal((3, 3, 64, 128)) * 0.05).astype(np.float32))
    w_q, s_w = weight_quant(w * torch.linspace(0.5, 2.0, 64)[None, None, :, None])
    b = torch.zeros(128)
    xpp = jnp.pad(jnp.asarray(_pack_pairs(x_q)), ((0, 0), (1, 1), (1, 1), (0, 0)))
    w_taps = mod.chp._pack_weights(jnp.asarray(w_q.numpy()), jnp.int8, "split")
    ref = mod._hpack_bblk(xpp, w_taps, jnp.asarray(s_w.numpy())[None],
                          jnp.zeros((1, 128), jnp.float32), 2, 4, interpret=True)
    out = exp_r4_bblk.hpack_bblk(torch.from_numpy(x_q), w_q, s_w, b)
    assert out.dtype == torch.bfloat16 and tuple(out.shape) == (2, 8, 8, 128)
    assert_within_bf16_ulp(ref, out, 0.0)


def test_6h_planar_conv0_matches_jax_probe(load):
    """exp_r5_conv0.v1_planar (planar int8 store, XLA pair-pack) vs kernel
    A's requant epilogue (plain version), the JAX side unpacked."""
    mod = load("exp_r5_conv0")
    x, w, b, _, _ = _conv0_case(9)
    ref = mod.v1_planar(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), exp_r5_conv0.S_X,
                        exp_r5_conv0.S1, interpret=True)
    out = exp_r5_conv0.v1_planar(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b))
    assert out.dtype == torch.int8 and tuple(out.shape) == (2, 16, 16, 64)
    assert_int8_close(_unpack_pairs(np.asarray(ref)), out)


def test_6i_kdeep_matches_jax_probe(load):
    """exp_r5_kdepth.run_variant('kdeep') (K 384 dots, requant to conv2) vs
    kernel B pooled with ``s_next`` (plain version)."""
    mod = load("exp_r5_kdepth")
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 16, 16, 64)).astype(np.float32)
    w = (rng.standard_normal((3, 3, 64, 128)) * 0.05).astype(np.float32)
    b = (rng.standard_normal(128) * 0.1).astype(np.float32)
    s_x, s_next = (0.02,) * 64, (0.03,) * 128
    ref = mod.run_variant(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), s_x, s_next,
                          "kdeep", True)
    out = exp_r5_kdepth.run_variant(torch.from_numpy(x), torch.from_numpy(w),
                                    torch.from_numpy(b), s_x, s_next)
    assert out.dtype == torch.int8 and tuple(out.shape) == (2, 8, 8, 128)
    assert_int8_close(ref, out)


@pytest.mark.parametrize("k,ndots", exp_r5_mosaic_dot.DEPTHS)
@pytest.mark.parametrize("label", ["s8", "bf16"])
def test_6j_dot_rate_matches_jax_probe(load, label, k, ndots):
    """exp_r5_mosaic_dot's ``_kernel`` (row 0 of sum_i x[g] w[i]) through a
    ``pallas_call`` with plain block specs in interpret mode, 3 steps of
    R 2 x W 64, vs kernel F's plain version: equal (integer sums)."""
    mod = load("exp_r5_mosaic_dot")
    grid, r, wd, n = 3, 2, 64, mod.N
    rng = np.random.default_rng(k + ndots)
    x = rng.integers(-8, 9, (grid, r, wd, k)).astype(np.int8)
    w = rng.integers(-8, 9, (ndots, k, n)).astype(np.int8)
    jdt, acct = (jnp.int8, jnp.int32) if label == "s8" else (jnp.bfloat16, jnp.float32)
    f = pl.pallas_call(
        lambda x_ref, w_ref, o_ref: mod._kernel(x_ref, w_ref, o_ref, k=k, ndots=ndots,
                                                acct=acct),
        grid=(grid,),
        in_specs=[pl.BlockSpec((1, r, wd, k), lambda i: (i, 0, 0, 0)),
                  pl.BlockSpec((ndots, k, n), lambda i: (0, 0, 0))],
        out_specs=pl.BlockSpec((1, 1, wd, n), lambda i: (i, 0, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((grid, 1, wd, n), jnp.float32),
        interpret=True)
    ref = np.asarray(f(jnp.asarray(x, jdt), jnp.asarray(w, jdt)))[:, 0]
    tdt = torch.int8 if label == "s8" else torch.bfloat16
    out = exp_r5_mosaic_dot.rate_fn(torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(tdt))
    assert out.dtype == (torch.int32 if label == "s8" else torch.float32)
    assert tuple(out.shape) == (grid, wd, n)
    np.testing.assert_array_equal(out.numpy().astype(np.float32), ref)


@pytest.mark.parametrize("k,ndots", exp_r5_mosaic_dot.DEPTHS)
@pytest.mark.parametrize("label", ["s8", "bf16"])
def test_6j_yardstick_gemm_computes_kernel_f_sums(label, k, ndots):
    """The yardstick's one GEMM (``stacked_operands``: x beside itself ndots
    times by the w_i stacked along K) holds row 0 of sum_i x[g] w[i] in its
    rows: its product (float64 here) at those rows equals kernel F's plain
    version, 3 steps of R 2 x W 64 on random integers."""
    rng = np.random.default_rng(k * ndots)
    tdt = torch.int8 if label == "s8" else torch.bfloat16
    x = torch.from_numpy(rng.integers(-8, 9, (3, 2, 64, k)).astype(np.int8)).to(tdt)
    w = torch.from_numpy(rng.integers(-8, 9, (ndots, k, 128)).astype(np.int8)).to(tdt)
    xs, ws = exp_r5_mosaic_dot.stacked_operands(x, w)
    assert tuple(xs.shape) == (3 * 2 * 64, ndots * k) and tuple(ws.shape) == (ndots * k, 128)
    ref = mma_rate_plain(x, w)
    got = (xs.double() @ ws.double()).reshape(3, 2, 64, 128)[:, 0].to(ref.dtype)
    assert torch.equal(got, ref)


def test_6k_planar_tap_conv_matches_jax_probe(load):
    """exp_tapconv.conv_tap_i8 (planar taps) vs kernel B unpooled with a
    bf16 epilogue (plain version)."""
    mod = load("exp_tapconv")
    x, w, b = _conv_case(8)
    ref = mod.conv_tap_i8(*_jax(x, w, b), interpret=True)
    out = exp_tapconv.conv_tap_i8(*_torch(x, w, b))
    assert out.dtype == torch.bfloat16 and tuple(out.shape) == (2, 16, 16, 32)
    assert_within_bf16_ulp(ref, out, b)


@pytest.mark.parametrize("name", list(PROBES))
def test_probe_entry_point_runs_on_cpu(name, capsys):
    """``python -m vqa_tpu_torch.tools.<name> --device cpu``: the plain
    versions at a small size, one JSON line a variant, no time."""
    mod = importlib.import_module(f"vqa_tpu_torch.tools.{name}")
    assert mod.main(["--device", "cpu"]) == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]
    assert lines and all('"device": "cpu"' in ln and "ms" not in ln for ln in lines)
