"""The port's CUDA kernels against their plain PyTorch versions.

This file imports no JAX, so it also runs where only the port is installed.
On a machine with a card and nvcc, run the card tests with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py -m cuda

(``--noconftest``: the suite's conftest sets up JAX). There each kernel mode
must equal its plain version bit for bit, at odd shapes that exercise the
tile edges, except the float kernels, which sum on the tensor cores in
another order (in f32 through 3xTF32): kernel C is held within
``conv_stage1.conv0_f_bound``, kernel D within ``conv_hpack.conv3x3_f_bound``
and kernel E within ``coattention_kernel.coattention_bound``. Without a card
those tests skip; the dispatch contract, the weight layouts, a model of
kernel C's 3xTF32 arithmetic and the soundness of that bound, and a model of
kernel D's shared-memory descriptor addressing run everywhere (kernel D's
and E's bounds: tests/test_torch_hpack_float.py and
tests/test_torch_coattention_kernel.py).
"""

import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from vqa_tpu_torch import _build
from vqa_tpu_torch.ops import coattention_kernel, conv_hpack, conv_stage1, quant
from vqa_tpu_torch.tools import exp_r5_mosaic_dot

TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def test_cpu_tensors_take_plain_version_and_count_nothing():
    _build.reset_counts()
    rng = np.random.default_rng(9)
    x_q = torch.from_numpy(rng.integers(-127, 128, (1, 4, 4, 32)).astype(np.int8))
    w_q = torch.from_numpy(rng.integers(-127, 128, (3, 3, 32, 64)).astype(np.int8))
    one = torch.ones(64)
    out = conv_hpack.int8_conv3x3(x_q, w_q, one, one, pool=True)
    assert tuple(out.shape) == (1, 2, 2, 64) and out.dtype == torch.float32
    x0 = torch.from_numpy(rng.integers(-127, 128, (1, 4, 6, 3)).astype(np.int8))
    w0 = torch.from_numpy(rng.integers(-127, 128, (3, 3, 3, 64)).astype(np.int8))
    out = conv_stage1.conv0_i8(x0, w0, one, one, s1=one)
    assert tuple(out.shape) == (1, 2, 3, 64) and out.dtype == torch.int8
    out = conv_stage1.conv0_f(x0.to(torch.bfloat16), w0.float(), one)
    assert tuple(out.shape) == (1, 2, 3, 64) and out.dtype == torch.bfloat16
    xf = torch.from_numpy(rng.standard_normal((1, 5, 7, 8)).astype(np.float32))
    out = conv_hpack.conv3x3_f(xf.bfloat16(), torch.ones(3, 3, 8, 16), torch.ones(16))
    assert tuple(out.shape) == (1, 2, 3, 16) and out.dtype == torch.bfloat16
    v = torch.from_numpy(rng.standard_normal((2, 6, 32)).astype(np.float32))
    q = torch.from_numpy(rng.standard_normal((2, 3, 4, 32)).astype(np.float32))
    vec = torch.ones(32)
    out_v, out_q = coattention_kernel.coattention_fwd(v, q, torch.eye(32), vec, torch.eye(32),
                                                      vec, vec, vec)
    assert tuple(out_v.shape) == tuple(out_q.shape) == (2, 3, 32)
    assert all(k.launches == 0 and k.plain_on_cuda == 0 for k in _build.KERNELS)


def test_plain_pool_equals_pool_after_epilogue():
    """Pooling the int32 sums first (the kernels' order) gives the values
    of the JAX order, epilogue first then pool: every step is monotone."""
    rng = np.random.default_rng(4)
    x_q = torch.from_numpy(rng.integers(-127, 128, (2, 6, 8, 32)).astype(np.int8))
    w_q = torch.from_numpy(rng.integers(-127, 128, (3, 3, 32, 64)).astype(np.int8))
    sc = torch.from_numpy((rng.random(64) * 1e-4 + 1e-6).astype(np.float32))
    b = torch.from_numpy((rng.standard_normal(64) * 0.3).astype(np.float32))
    sn = torch.from_numpy((rng.random(64) * 0.02 + 1e-3).astype(np.float32))
    for kw in ({"out_dtype": torch.bfloat16}, {"s_next": sn}):
        full = conv_hpack.int8_conv3x3(x_q, w_q, sc, b, pool=False, **kw)
        pooled = conv_hpack.int8_conv3x3(x_q, w_q, sc, b, pool=True, **kw)
        ref = full.float().reshape(2, 3, 2, 4, 2, 64).amax(dim=(2, 4)).to(full.dtype)
        assert torch.equal(pooled, ref)


def test_kernels_name_their_sources_and_tpu_counterparts():
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert [k.symbol for k in _build.KERNELS] == [
        "conv0_s2d_i8", "conv3x3_i8", "conv0_f", "conv3x3_f", "coattention_fwd", "mma_rate"]
    for k in _build.KERNELS:
        assert os.path.exists(os.path.join(_build.CSRC, k.source))
        for part in k.replaces.split(", "):
            path, line = part.split(" ")[0].split(":")
            with open(os.path.join(repo, path)) as f:
                assert "def _kernel" in f.readlines()[int(line) - 1]


def test_kernel_b_weight_layout_matches_index_formula():
    rng = np.random.default_rng(5)
    w = torch.from_numpy(rng.integers(-127, 128, (3, 3, 64, 192)).astype(np.int8))
    wp = conv_hpack.pack_conv3x3_weights(w)
    assert tuple(wp.shape) == (2, 2, 9, 16, 2, 8, 16) and wp.is_contiguous()
    k, p, t, n, h, r, i = (torch.from_numpy(rng.integers(0, m, 2000))
                           for m in (2, 2, 9, 16, 2, 8, 16))
    o = 128 * p + 8 * n + r                  # channels 192..255 are padding
    want = torch.where(o < 192, w[t // 3, t % 3, 32 * k + 16 * h + i, o.clamp(max=191)], 0)
    assert bool((o >= 192).any()) and torch.equal(wp[k, p, t, n, h, r, i], want.to(torch.int8))


def test_kernel_a_weight_layout_matches_index_formula():
    """Register r of lane (g, t), n-tile j: K word k = t + 4r of channel
    8j + g; byte c < 3 is tap k's channel c, byte 3 tap 8's channel k (k < 3)."""
    rng = np.random.default_rng(6)
    w = torch.from_numpy(rng.integers(-127, 128, (3, 3, 3, 64)).astype(np.int8))
    wf = conv_stage1.pack_conv0_i8_weights(w)
    assert tuple(wf.shape) == (8, 4, 8, 2) and wf.dtype == torch.int32 and wf.is_contiguous()
    wb = wf.view(torch.int8).reshape(8, 4, 8, 2, 4)
    for g in range(8):
        for t in range(4):
            for r in range(2):
                k = t + 4 * r
                o = 8 * torch.arange(8) + g                  # channel of n-tile j
                for c in range(4):
                    if c < 3:
                        want = w[k // 3, k % 3, c, o]
                    else:
                        want = w[2, 2, k, o] if k < 3 else torch.zeros(8, dtype=torch.int8)
                    assert torch.equal(wb[g, t, :, r, c], want)


def _kernel_a_sums(x_q, wf):
    """Kernel A's GEMM as its fragments build it (csrc/conv0_s2d_i8.cu):
    per pooled pixel and pool phase an A row of 8 char4 words, word k = tap
    k's (c0, c1, c2, 0) with, for k < 3, byte 3 replaced by tap 8's channel
    k (the ``__byte_perm``); B rebuilt from the packed fragments by the PTX
    m16n8k32 layout (lane (g, t), register r: K bytes 4t + 16r .. + 3,
    column g). Returns the int max over the phases, [B, H/2, W/2, 64]."""
    b, h, w, _ = x_q.shape
    xp = np.pad(x_q.astype(np.int64), ((0, 0), (1, 1), (1, 1), (0, 1)))   # char4 words
    wb = wf.view(torch.int8).reshape(8, 4, 8, 2, 4).numpy().astype(np.int64)
    bmat = np.zeros((32, 64), np.int64)
    for g in range(8):
        for t in range(4):
            for r in range(2):
                for j in range(8):
                    bmat[4 * t + 16 * r:4 * t + 16 * r + 4, 8 * j + g] = wb[g, t, j, r]
    best = None
    for p in range(2):
        for q in range(2):
            words = [xp[:, p + k // 3:p + k // 3 + h:2, q + k % 3:q + k % 3 + w:2]
                     for k in range(9)]
            arow = np.concatenate(words[:8], -1)                               # [.., 32]
            for k in range(3):
                arow[..., 4 * k + 3] = words[8][..., k]
            s = arow @ bmat
            best = s if best is None else np.maximum(best, s)
    return best


def test_kernel_a_fragments_reproduce_conv_sums():
    """The 27 (tap, channel) pairs packed into one 32-byte k-step (tap 8 in
    byte 3 of words 0-2) give the exact pooled conv sums, at a ragged shape."""
    rng = np.random.default_rng(11)
    x_q = rng.integers(-128, 128, (2, 10, 14, 3)).astype(np.int8)
    w_q = torch.from_numpy(rng.integers(-127, 128, (3, 3, 3, 64)).astype(np.int8))
    got = _kernel_a_sums(x_q, conv_stage1.pack_conv0_i8_weights(w_q))
    ref = F.max_pool2d(quant.int_conv3x3(torch.from_numpy(x_q), w_q), 2)
    assert np.array_equal(got, ref.permute(0, 2, 3, 1).numpy().astype(np.int64))


def _requant_as_kernel_b(y, s):
    """Kernel B's int8 requant (csrc/conv3x3_i8.cu ``stage`` with
    ``needs_division`` and its division fallback) in float32 numpy, whose
    operations round to nearest like the CUDA intrinsics."""
    with np.errstate(divide="ignore", over="ignore", invalid="ignore"):
        normal = (s >= np.float32(2.0 ** -120)) & (s <= np.float32(2.0 ** 120))
        inv = np.where(normal, np.float32(1) / s, np.float32(np.nan))
        q = y * inv
        slow = ~(q >= np.float32(128.5)) & ~(
            np.abs(q - np.rint(q)) < np.float32(0.5) - np.float32(2.0 ** -14))
        fast = np.where(q >= np.float32(128.5), np.float32(127), np.clip(np.rint(q), -127, 127))
        exact = np.clip(np.rint(y / s), -127, 127)
    return np.where(slow, exact, fast), exact


def test_kernel_b_requant_reciprocal_path_equals_division():
    """The reciprocal path of kernel B's requant gives clip(rint(y / s)) for
    every y, s: random values, quotients a few ulps from each half-integer
    and from 128.5, saturated and tiny ones."""
    rng = np.random.default_rng(7)
    n = 400_000
    s = (rng.random(n) * 0.02 + 1e-3).astype(np.float32)
    halves = (rng.integers(-130, 131, n) + 0.5).astype(np.float32)
    y_near = (halves * s).astype(np.float32)
    steps = rng.integers(-64, 65, n).astype(np.float32)
    y_near = (y_near + steps * np.spacing(y_near)).astype(np.float32)
    y_rand = (rng.random(n) * 3.0).astype(np.float32)
    y_wide = (10.0 ** rng.uniform(-40, 38, n)).astype(np.float32)
    s_wide = (10.0 ** rng.uniform(-39, 38, n)).astype(np.float32)
    for y, sc in ((y_near, s), (y_rand, s), (y_wide, s), (y_rand, s_wide), (y_wide, s_wide)):
        got, want = _requant_as_kernel_b(y.astype(np.float32), sc)
        assert np.array_equal(got, want)


def _requant_as_kernel_a(v, s):
    """Kernel A's int8 requant (csrc/conv0_s2d_i8.cu, MODE 2) in float32
    numpy, from v before the ReLU: q = v * rn(1 / s) (NaN for s outside
    [2^-120, 2^120]), its value max(min(int(rint(q)), 127), 0) with a
    saturating conversion that takes NaN to 0, and the division of relu(v)
    wherever |q - rint(q)| >= 0.5 - 2^-14 or is NaN (a superset of kernel
    B's rule)."""
    with np.errstate(divide="ignore", over="ignore", invalid="ignore"):
        normal = (s >= np.float32(2.0 ** -120)) & (s <= np.float32(2.0 ** 120))
        inv = np.where(normal, np.float32(1) / s, np.float32(np.nan))
        q = v * inv
        rq = np.rint(q)
        slow = ~(np.abs(q - rq) < np.float32(0.5) - np.float32(2.0 ** -14))
        fast = np.clip(np.clip(np.nan_to_num(rq, nan=0.0), -2.0 ** 31, 2.0 ** 31 - 1), 0, 127)
        exact = np.clip(np.rint(np.where(v > 0, v, np.float32(0)) / s), -127, 127)
    return np.where(slow, exact, fast), exact, slow


def test_kernel_a_requant_reciprocal_path_equals_division():
    """Kernel A's requant through the reciprocal, from v before the ReLU,
    equals clip(rint(relu(v) / s)): zeros, random values of both signs,
    quotients a few ulps from each half-integer in [-130, 130] and from
    128.5, saturated, tiny and huge ones, and scales outside [2^-120, 2^120]."""
    rng = np.random.default_rng(8)
    n = 400_000
    s = (rng.random(n) * 0.02 + 1e-3).astype(np.float32)
    halves = (rng.integers(-130, 131, n) + 0.5).astype(np.float32)
    v_near = (halves * s).astype(np.float32)
    steps = rng.integers(-64, 65, n).astype(np.float32)
    v_near = (v_near + steps * np.spacing(v_near)).astype(np.float32)
    v_rand = (rng.random(n) * 6.0 - 3.0).astype(np.float32)
    v_rand[: n // 10] = 0
    v_wide = (10.0 ** rng.uniform(-40, 38, n) * rng.choice([-1, 1], n)).astype(np.float32)
    s_wide = (10.0 ** rng.uniform(-39, 38, n)).astype(np.float32)
    n_slow = 0
    for v, sc in ((v_near, s), (v_rand, s), (v_wide, s), (v_rand, s_wide), (v_wide, s_wide)):
        got, want, slow = _requant_as_kernel_a(v.astype(np.float32), sc)
        assert np.array_equal(got, want)
        n_slow += int(slow.sum())
    assert n_slow > 0                        # the division fallback was exercised


def _epilogue_as_kernel_a(acc, scale, bias, s1):
    """Kernel A's epilogue in float32 numpy from its int32 sums:
    v = float(sum) * scale + bias, rounded at each step; relu(v) in bf16
    (round to nearest even, by torch) or, with s1, the requant of v."""
    v = acc.astype(np.float32) * scale + bias
    if s1 is None:
        return torch.from_numpy(np.where(v > 0, v, np.float32(0))).to(torch.bfloat16)
    return torch.from_numpy(_requant_as_kernel_a(v, s1)[0].astype(np.int8))


@pytest.mark.parametrize("out", ["bfloat16", "int8"])
def test_kernel_a_epilogue_equals_plain_epilogue(out):
    """From int32 sums to the stored value, kernel A's arithmetic
    equals ``quant.epilogue``: random sums, the largest (+-27 * 127^2), and
    sums that put y / s1 a few ulps from half-integers."""
    rng = np.random.default_rng(12)
    top = 27 * 127 ** 2
    acc = rng.integers(-top, top + 1, (3, 64, 1, 4096))
    acc[0, :, 0, :2] = [top, -top]
    acc[2] = 256 * rng.integers(-300, 300, (64, 1, 4096))
    s1 = (rng.random(64) * 0.02 + 1e-3).astype(np.float32)
    scale = (rng.random(64) * 9e-5 + 1e-5).astype(np.float32)
    bias = (rng.standard_normal(64) * 0.1).astype(np.float32)
    for i in range(3):
        sc, b = (s1 / 256, s1 / 2) if i == 2 else (scale, bias)
        kw = {"s_next": torch.from_numpy(s1)} if out == "int8" else {"s_next": None}
        want = quant.epilogue(torch.from_numpy(acc[i:i + 1]).double(), torch.from_numpy(sc),
                              torch.from_numpy(b), torch.bfloat16, **kw)[0]
        got = _epilogue_as_kernel_a(acc[i].transpose(1, 2, 0), sc, b,
                                    s1 if out == "int8" else None)
        assert torch.equal(got, want)


def _tf32_rna(v):
    """f32 -> TF32 (10 mantissa bits), to nearest, ties away from zero, by
    bit operations on the int32 view: add half a TF32 ulp to the magnitude
    bits, clear the 13 low bits (``cvt.rna.tf32.f32`` on finite values)."""
    bits = v.float().contiguous().view(torch.int32)
    return ((bits + (1 << 12)) & ~((1 << 13) - 1)).view(torch.float32)


def _kernel_c_f32_index(t, j, r):
    """Kernel C's f32 A fragment entry [t, part, j, r] of thread t = 32w + 4g
    + q: slot q of tap 2j + r // 2 of output channel 16w + g + 8 (r % 2)
    (zero for slot 3 and tap 9), as (row of the [27, 64] weights, 27 = a
    zero; channel)."""
    w, g, q = t // 32, t % 32 // 4, t % 4
    tap = 2 * j + r // 2
    return torch.where((tap < 9) & (q < 3), 3 * tap + q, 27), 16 * w + g + 8 * (r % 2)


def test_kernel_c_f32_weight_split_rebuilds_weights():
    """hi + lo gives w within 2^-22 relative; both are TF32 (13 low mantissa
    bits zero); hi is w rounded to nearest TF32, ties away from zero."""
    rng = np.random.default_rng(13)
    w = rng.standard_normal((27, 64)) * 10.0 ** rng.uniform(-4, 4, (27, 64))
    w[0, [0, 8, 16, 24]] = [1 + 2.0 ** -11, -(1 + 3 * 2.0 ** -12), 2.0 ** -126, 0]   # ties, tiny, zero
    w32 = torch.from_numpy(w.astype(np.float32))
    wa = conv_stage1.pack_conv0_f32_weights(w32)
    assert tuple(wa.shape) == (128, 2, 5, 4) and wa.dtype == torch.float32
    hi, lo = wa[:, 0], wa[:, 1]
    for part in (hi, lo):
        assert int((part.contiguous().view(torch.int32) & 0x1FFF).abs().sum()) == 0
    k, o = _kernel_c_f32_index(torch.arange(128)[:, None, None], torch.arange(5)[None, :, None],
                               torch.arange(4)[None, None, :])
    want = torch.cat([w32, torch.zeros(1, 64)])[k, o]
    assert torch.equal(hi, _tf32_rna(want))
    rel = (hi.double() + lo.double() - want.double()).abs() / want.double().abs().clamp_min(1e-300)
    assert float(rel.max()) <= 2.0 ** -22
    assert float(hi[0, 0, 0]) == 1 + 2.0 ** -10 and float(lo[0, 0, 0]) == -(2.0 ** -11)


def test_kernel_c_f32_weight_layout_matches_index_formula():
    """Register r of thread (w, g, q) in k-step j holds slot q (c0, c1, c2,
    then a zero) of tap 2j + r // 2 (tap = 3 kh + kw; tap 9 zero) of output
    channel 16w + g + 8 (r % 2): the m64nNk8 TF32 A layout, rows g and g + 8
    of warp w's 16, K columns q and q + 4."""
    rng = np.random.default_rng(14)
    w = torch.from_numpy(rng.standard_normal((3, 3, 3, 64)).astype(np.float32))
    wa = conv_stage1.pack_conv0_f32_weights(w.reshape(27, 64))
    for wp in range(4):
        for g in range(8):
            for q in range(4):
                for j in range(5):
                    for r in range(4):
                        tap, o = 2 * j + r // 2, 16 * wp + g + 8 * (r % 2)
                        want = float(w[tap // 3, tap % 3, q, o]) if tap < 9 and q < 3 else 0.0
                        t = 32 * wp + 4 * g + q
                        got = float(wa[t, 0, j, r]) + float(wa[t, 1, j, r])
                        assert abs(got - want) <= 2.0 ** -22 * abs(want)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_kernel_d_weight_layout_matches_index_formula(dtype):
    """``pack_conv3x3_f_weights``: wp[p, k, (s,) t, n, h, r, i] = part_s of
    w[t // 3, t % 3, CK k + E h + i, N p + 8 n + r] (E values of 16 bytes,
    CK = 2 E, N the slice), zero past C and O; in f32 hi is rna_tf32(w),
    both parts TF32, and hi + lo rebuilds w within 2^-22 relative."""
    dt = TORCH_DT[dtype]
    rng = np.random.default_rng(15)
    c, o = 40, 200                               # a ragged last K chunk and slice
    w = torch.from_numpy((rng.standard_normal((3, 3, c, o))
                          * 10.0 ** rng.uniform(-3, 3, (3, 3, c, o))).astype(np.float32))
    wp = conv_hpack.pack_conv3x3_f_weights(w, dt)
    e, n = (8 if dtype == "bfloat16" else 4), conv_hpack.CONV3X3_F_SLICE
    nch, slices = -(-c // (2 * e)), -(-o // n)
    parts = [wp] if dtype == "bfloat16" else [wp[:, :, 0], wp[:, :, 1]]
    for part in parts:
        assert tuple(part.shape) == (slices, nch, 9, n // 8, 2, 8, e) and part.dtype == dt
    assert wp.is_contiguous()
    p, k, t, nn, h, r, i = (torch.from_numpy(rng.integers(0, m, 4000))
                            for m in (slices, nch, 9, n // 8, 2, 8, e))
    ci, oi = 2 * e * k + e * h + i, n * p + 8 * nn + r
    valid = (ci < c) & (oi < o)
    want = torch.where(valid, w.to(dt)[t // 3, t % 3, ci.clamp(max=c - 1), oi.clamp(max=o - 1)],
                       torch.zeros((), dtype=dt))
    assert bool((~valid).any())
    if dtype == "bfloat16":
        assert torch.equal(wp[p, k, t, nn, h, r, i], want)
        return
    hi, lo = wp[p, k, 0, t, nn, h, r, i], wp[p, k, 1, t, nn, h, r, i]
    assert torch.equal(hi, _tf32_rna(want))
    for part in (hi, lo):
        assert int((part.view(torch.int32) & 0x1FFF).abs().sum()) == 0
    err = (hi.double() + lo.double() - want.double()).abs()
    assert bool((err <= 2.0 ** -22 * want.double().abs()).all())


# kernel D's shared-memory geometry (csrc/conv3x3_f.cu): a K half of the halo
# is [10][34] pixels x 16 bytes, padded to 128-byte alignment
_D_HALO_W, _D_HALF = 34, (10 * 34 * 16 + 127) // 128 * 128


def _kernel_d_sums(x, w, b, ty, tx, dtype):
    """Kernel D's conv sums of one tile (8 conv rows x 32 columns from (8 ty,
    32 tx)) and every output channel, read as its wgmma descriptors address
    shared memory: per K chunk, the halo as two TMA boxes of 16 bytes x 34 x
    10 (zeros outside the image) at [K half][pixel], A of warpgroup wg and
    tap (ky, kx) from start 8 wg + ky 34 + kx pixels with LBO = one K half
    and SBO = one halo row, M row m = core matrix m // 8, row m % 8; B from
    the packed slice with LBO 128 and SBO 256 bytes, a tap 32 N bytes on,
    lo 9 taps on (f32); each 32-byte K row a (bf16) or three (3xTF32: lo_x
    hi_w, hi_x lo_w, hi_x hi_w) products summed in float64. Returns
    [8, 32, O]: conv pixel (8 ty + r, 32 tx + 8 wg + m % 8) at row r = m // 8."""
    dt = TORCH_DT[dtype]
    bsz, h, wd, c = x.shape
    o = w.shape[-1]
    e, n = (8 if dtype == "bfloat16" else 4), conv_hpack.CONV3X3_F_SLICE
    wp = conv_hpack.pack_conv3x3_f_weights(w, dt)
    nch, parts = wp.shape[1], 1 if dtype == "bfloat16" else 2
    xs = x.to(dt)
    if dtype == "float32":
        xh = _tf32_rna(xs)
        halos = [xh, _tf32_rna(xs - xh)]              # hi, lo (split once a stage)
    else:
        halos = [xs]
    tap_bytes = n * 32
    out = np.zeros((8, 32, wp.shape[0] * n))
    m = np.arange(64)
    kb = np.arange(32)
    for k in range(nch):
        smem = []
        for part in halos:                            # the stage: two K halves
            buf = np.zeros(2 * _D_HALF, np.uint8)
            for half in range(2):
                box = torch.zeros((10, 34, e), dtype=dt)
                c0 = 2 * e * k + e * half
                for yy in range(10):
                    for xx in range(34):
                        iy, ix = 8 * ty - 1 + yy, 32 * tx - 1 + xx
                        if 0 <= iy < h and 0 <= ix < wd:
                            vals = part[b, iy, ix, c0:c0 + e]
                            box[yy, xx, :vals.shape[0]] = vals
                raw = box.contiguous().view(torch.uint8).numpy().reshape(-1)
                buf[half * _D_HALF:half * _D_HALF + raw.size] = raw
            smem.append(buf)
        for p in range(wp.shape[0]):
            wb = wp[p, k].contiguous().view(torch.uint8).numpy().reshape(-1)
            for wg in range(4):
                for tap in range(9):
                    ky, kx = divmod(tap, 3)
                    start = (8 * wg + ky * _D_HALO_W + kx) * 16
                    # A [64, 32 bytes]: address = start + (kb // 16) LBO + (m // 8) SBO + (m % 8) 16 + kb % 16
                    a_addr = (start + (kb // 16)[None] * _D_HALF + (m // 8)[:, None] * _D_HALO_W * 16
                              + (m % 8)[:, None] * 16 + (kb % 16)[None])
                    nn = np.arange(n)
                    b_addr = (tap * tap_bytes + (kb // 16)[None] * 128 + (nn // 8)[:, None] * 256
                              + (nn % 8)[:, None] * 16 + (kb % 16)[None])

                    def val(buf, addr):
                        return torch.from_numpy(np.ascontiguousarray(buf[addr])).view(dt).double()

                    if dtype == "bfloat16":
                        terms = [(val(smem[0], a_addr), val(wb, b_addr))]
                    else:
                        lo_w = b_addr + 9 * tap_bytes
                        terms = [(val(smem[1], a_addr), val(wb, b_addr)),
                                 (val(smem[0], a_addr), val(wb, lo_w)),
                                 (val(smem[0], a_addr), val(wb, b_addr))]
                    for av, bv in terms:                  # [64, E32] x [N, E32]
                        s = (av @ bv.T).numpy()           # M rows x N
                        out[m // 8, 8 * wg + m % 8, p * n:(p + 1) * n] += s
    return out[..., :o]


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_kernel_d_descriptors_reproduce_conv_sums(dtype):
    """A model of kernel D's shared-memory addressing (halo boxes, per-tap
    descriptor starts, LBO/SBO, 32-byte K rows, the packed B slices) gives
    the conv's sums at an interior tile and at a tile that crosses the
    image's right and bottom edges, with C 24 (a zero-filled K half in bf16)
    and O 40 (a partial slice): to float64 rounding in bf16, within the
    3xTF32 split's 3 * 2^-22 sum |x w| in f32."""
    rng = np.random.default_rng(16)
    x = torch.from_numpy(rng.standard_normal((2, 12, 40, 24)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((3, 3, 24, 40)) * 0.2).astype(np.float32))
    dt = TORCH_DT[dtype]
    xd, wd_ = x.to(dt).double(), w.to(dt).double()
    xp = F.pad(xd, (0, 0, 1, 1, 1, 1))
    conv = sum(xp[:, ky:ky + 12, kx:kx + 40] @ wd_[ky, kx] for ky in range(3) for kx in range(3))
    absc = sum(xp[:, ky:ky + 12, kx:kx + 40].abs() @ wd_[ky, kx].abs()
               for ky in range(3) for kx in range(3))
    for b, ty, tx in ((0, 0, 0), (1, 1, 1)):
        got = _kernel_d_sums(x, w, b, ty, tx, dtype)
        rows = slice(8 * ty, min(8 * ty + 8, 12))
        cols = slice(32 * tx, min(32 * tx + 32, 40))
        nr, nc = rows.stop - rows.start, cols.stop - cols.start
        want, scale = conv[b, rows, cols].numpy(), absc[b, rows, cols].numpy()
        tol = 1e-12 * scale if dtype == "bfloat16" else 3 * 2.0 ** -22 * scale + 1e-12
        assert np.all(np.abs(got[:nr, :nc] - want) <= tol)
        assert float(np.abs(want).max()) > 0


# kernel D's unpooled epilogue (csrc/conv3x3_f.cu, POOL = false): each warp
# stages 64 bytes of channels of its 2 x 16 pixels, a pixel a row, under the
# 64-byte swizzle, and stores that box by TMA


def _tma_swizzle(addr, mode):
    """The address TMA (and wgmma) use for logical shared-memory byte
    ``addr`` of a tile aligned to its swizzle atom: the 128-byte swizzle
    XORs the 16-byte unit (bits 4-6) with bits 7-9, the 64-byte one bits
    4-5 with bits 7-8."""
    mask = 7 if mode == 128 else 3
    return addr ^ (((addr >> 7) & mask) << 4)


def _sw64_offset(row, b):
    """Where TMA's 64-byte swizzle puts byte ``b`` of row ``row`` of a tile
    of 64-byte rows (512-byte aligned): the 16-byte unit b / 16 at (b / 16)
    ^ ((row >> 1) & 3)."""
    return row * 64 + ((((b >> 4) ^ (row >> 1)) & 3) << 4) + (b & 15)


def _kernel_d_unpooled_store(acc, bias, dtype, streams, n0, cout, tile, out):
    """Kernel D's unpooled epilogue for one stream's tile, as the kernel
    runs it: ``acc`` [threads][2][64] f32 sums (thread t of the stream =
    warpgroup wg, warp w, lane (g, q); acc[mt][4j + 2hf + e] is pixel (2w +
    hf, col0 + 8mt + g) of the tile, channel n0 + 8j + 2q + e). Per warp
    and piece of UCH channels: the fragments (+ bias, ReLU, one rounding) at
    the kernel's addresses (row 16 hf + 8 mt + g, byte cb ^ keyb), then
    TMA's store of the box (UCH channels x 16 x 2 from (channel, x, y, b))
    into ``out`` [B, H, W, C_out], clipped at its edges (``tile`` = (x, y,
    b) of the tile's first pixel). Returns each warp store's lane offsets
    (for the bank check)."""
    dt = TORCH_DT[dtype]
    es = torch.empty((), dtype=dt).element_size()
    uch, tw = 64 // es, 32 // streams
    stores = []
    for wg in range(2 if streams == 1 else 1):
        for w in range(4):
            x0, y0 = tile[0] + 16 * (wg if streams == 1 else 0), tile[1] + 2 * w
            for ck in range(128 // uch):
                if n0 + ck * uch >= cout:
                    break
                piece = np.zeros(32 * 64, np.uint8)
                written = np.zeros(32 * 64, np.int64)
                for jj in range(uch // 8):
                    j = ck * (uch // 8) + jj
                    if n0 + 8 * j >= cout:
                        break
                    for mt in range(2):
                        for hf in range(2):
                            lanes = []
                            for g in range(8):
                                for q in range(4):
                                    t = 128 * wg + 32 * w + 4 * g + q
                                    # the kernel's address: the lane's bytes, XOR the unit
                                    lane_bytes = g * 64 + ((2 * q * es) & 15) \
                                        + (((g >> 1) & 3) << 4)
                                    cb = (8 * jj + 2 * q) * es
                                    off = (lane_bytes ^ ((cb >> 4) << 4)) + (16 * hf + 8 * mt) * 64
                                    assert off == _sw64_offset(16 * hf + 8 * mt + g, cb)
                                    v = [acc[t, mt, 4 * j + 2 * hf + e]
                                         + bias[n0 + 8 * j + 2 * q + e] for e in range(2)]
                                    raw = torch.tensor([max(a, 0.0) for a in v]).to(dt) \
                                        .view(torch.uint8).numpy()
                                    piece[off:off + raw.size] = raw
                                    written[off:off + raw.size] += 1
                                    lanes.append(off)
                            stores.append(lanes)
                assert written.max() <= 1                  # no two fragments on one byte
                # TMA reads logical byte (row, c) of the box at its swizzled address
                logical = piece[_tma_swizzle(np.arange(piece.size), 64)]
                box = torch.from_numpy(logical.copy()).view(dt).reshape(2, 16, uch)
                c0 = n0 + ck * uch
                hh = max(0, min(2, out.shape[1] - y0))
                ww = max(0, min(16, out.shape[2] - x0))
                cc = min(uch, cout - c0)
                out[tile[2], y0:y0 + hh, x0:x0 + ww, c0:c0 + cc] = box[:hh, :ww, :cc]
    return stores


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_kernel_d_unpooled_staging_matches_nhwc_tile(dtype):
    """A model of kernel D's unpooled epilogue: every (pixel, channel)
    fragment of a warp lands on its own bytes of its staging piece under
    the 64-byte swizzle, and read back in TMA's box
    order (un-swizzled), clipped at the image's and C_out's edges, the
    warps' boxes give the NHWC tile of relu(sums + bias) in x.dtype. Two
    streams' tiles of 16 columns and one stream's of 32, an interior tile
    and a tile past W 41 / H 11 with C_out 200 (the second slice: 72
    channels, the last box mid-piece). In bf16 a warp's fragment stores (4
    bytes a lane) fall on 32 distinct banks."""
    rng = np.random.default_rng(21)
    dt = TORCH_DT[dtype]
    cout = 200
    bias = rng.standard_normal(256).astype(np.float32)
    for streams in (2, 1):
        tw = 32 // streams
        for ty, tx, n0 in ((0, 0, 0), (1, 41 // tw, 128)):
            acc = rng.standard_normal((256, 2, 64)).astype(np.float32)
            out = torch.full((1, 11, 41, cout), -1.0).to(dt)
            stores = _kernel_d_unpooled_store(acc, bias, dtype, streams, n0, cout,
                                              (tw * tx, 8 * ty, 0), out)
            # the same tile from the thread layout directly
            want = torch.full_like(out, -1.0)
            for t in range(256 if streams == 1 else 128):
                wg, w, lane = t // 128, (t // 32) % 4, t % 32
                g, q = lane // 4, lane % 4
                for mt in range(2):
                    for j in range(16):
                        for hf in range(2):
                            for e in range(2):
                                y = 8 * ty + 2 * w + hf
                                x = tw * tx + 16 * wg + 8 * mt + g
                                c = n0 + 8 * j + 2 * q + e
                                if y < 11 and x < 41 and c < cout:
                                    v = acc[t, mt, 4 * j + 2 * hf + e] + bias[c]
                                    want[0, y, x, c] = torch.tensor(max(v, 0.0)).to(dt)
            assert torch.equal(out, want)
            assert bool((out != -1).any())
            if dtype == "bfloat16":
                for lanes in stores:
                    assert len({(off // 4) % 32 for off in lanes}) == 32


# kernel F (csrc/mma_rate.cu): K split across a cluster of CLUSTER blocks


def _kernel_f_as_cluster(x, w):
    """Kernel F's schedule on the CPU: x [G, R, W, K], w [ndots, K, 128]
    (int8 or bfloat16) -> [G, W, 128] as the cluster computes it. Per unit
    of 128 rows of a step, rank r reads its K share: chunks of CB bytes
    (``mma_rate.k_chunk``) as TMA boxes of x [128 rows, CB] and of the
    packed w^T [128 n, CB] at K coordinate r share_k + c CB / es, stored
    with the CB-byte swizzle; each warpgroup's wgmmas read 64 rows x 32
    bytes from descriptor start a0 + 32 j (a0 = the stage + 64 wg rows);
    the products are exact integers, summed in float64 (the kernel's s32 /
    f32 sums stay exact). The partial sums travel through the receive
    slots [CL - 1][8 warps][VALS][32 lanes] of the rank that finalizes
    their columns (acc[s VALS + v] of lane (g, q) of warp (wg, w) is row
    64 wg + 16 w + g + 8 h, column 8 j + 2 q + e, s VALS + v = 4 j + 2 h +
    e), each (row, column) once, and are added in rank order."""
    from vqa_tpu_torch.ops import mma_rate

    g_, r_, wd, k = x.shape
    nd = w.shape[0]
    es = x.element_size()
    cl = mma_rate.CLUSTER[x.dtype]
    cb = mma_rate.k_chunk(k * es, cl)
    assert cb in (64, 128)
    share_k, kv = k // cl, cb // es
    nk = share_k // kv
    vals = 64 // cl
    wt = mma_rate.pack_mma_rate_weights(w)
    m = r_ * wd
    xf = x.reshape(g_ * m, k)

    def smem(tile):                                  # a TMA box, as shared-memory bytes
        raw = tile.contiguous().view(torch.uint8).numpy().reshape(-1)
        out = np.zeros_like(raw)
        out[_tma_swizzle(np.arange(raw.size), cb)] = raw
        return out

    def operand(buf, start, rows):                   # a wgmma's 32 bytes of K of `rows` rows
        addr = start + np.arange(rows)[:, None] * cb + np.arange(32)[None]
        raw = np.ascontiguousarray(buf[_tma_swizzle(addr, cb)])
        return torch.from_numpy(raw).view(x.dtype).double()

    # the receive slots' layout: every (row, column) of rank s's columns once
    lane = np.arange(32)
    for s in range(cl):
        seen = set()
        for warp in range(8):
            for v in range(vals):
                idx = s * vals + v
                j, h, e = idx // 4, (idx % 4) // 2, idx % 2
                rows = 64 * (warp // 4) + 16 * (warp % 4) + lane // 4 + 8 * h
                cols = 8 * j + 2 * (lane % 4) + e
                assert all(128 * s // cl <= c < 128 * (s + 1) // cl for c in cols)
                seen.update(zip(rows.tolist(), cols.tolist()))
        assert len(seen) == 128 * 128 // cl
    assert (cl - 1) * 8 * vals * 128 == {2: 32768, 4: 49152}[cl]

    out = torch.zeros((g_, wd, 128), dtype=torch.float64)
    for u in range(g_ * (m // 128)):
        step, grp = divmod(u, m // 128)
        rows0 = step * m + grp * 128
        partials = []
        for rank in range(cl):
            acc = torch.zeros((128, 128), dtype=torch.float64)
            for c in range(nk):
                k0 = rank * share_k + c * kv
                xs = smem(xf[rows0:rows0 + 128, k0:k0 + kv])
                for i in range(nd):
                    ws = smem(wt[128 * i:128 * (i + 1), k0:k0 + kv])
                    for wg in range(2):
                        for jstep in range(cb // 32):
                            a = operand(xs, wg * 64 * cb + 32 * jstep, 64)
                            b = operand(ws, 32 * jstep, 128)
                            acc[64 * wg:64 * wg + 64] += a @ b.T
            partials.append(acc)
        total = torch.zeros((128, 128), dtype=torch.float64)
        for p in partials:                           # in rank order
            total += p
        keep = max(0, min(128, wd - grp * 128))      # rows r < W of the step
        out[step, grp * 128:grp * 128 + keep] = total[:keep]
    return out


@pytest.mark.parametrize("label", ["int8", "bfloat16"])
@pytest.mark.parametrize("k,ndots", [*exp_r5_mosaic_dot.DEPTHS, (384, 2)])
def test_kernel_f_split_k_schedule_equals_plain(label, k, ndots):
    """A model of kernel F's cluster schedule (``_kernel_f_as_cluster``:
    each rank's K share of x and of the packed weights through TMA's
    swizzle and the wgmma descriptors' addresses, the receive slots' layout,
    the partial sums added in rank order) equals ``mma_rate_plain`` bit for
    bit on random integers, s8 and bf16, at the probe's K of 128 (a share
    of 64 bytes: the 64-byte swizzle), 256 and 512 (128-byte chunks), and
    at K 384 (shares of 192 bytes: three 64-byte chunks), each K with the
    probe's dot count; two steps of R 2 x W 192 (three units a step: the
    second stored in part, the third not)."""
    from vqa_tpu_torch.ops import mma_rate

    dt = torch.int8 if label == "int8" else torch.bfloat16
    rng = np.random.default_rng(22 + k)
    x = torch.from_numpy(rng.integers(-8, 9, (2, 2, 192, k))).to(dt)
    w = torch.from_numpy(rng.integers(-8, 9, (ndots, k, 128))).to(dt)
    got = _kernel_f_as_cluster(x, w)
    ref = mma_rate.mma_rate_plain(x, w)
    assert torch.equal(got, ref.double())
    assert got.abs().max() > 0


def test_kernel_f_k_chunks():
    """The cluster's K shares: 128-byte chunks where a share is a multiple
    of 128 bytes, else 64-byte ones; 0 (the wrapper raises) where K does
    not split into CLUSTER shares of a multiple of 64 bytes."""
    from vqa_tpu_torch.ops import mma_rate

    s8, bf16 = mma_rate.CLUSTER[torch.int8], mma_rate.CLUSTER[torch.bfloat16]
    assert (s8, bf16) == (2, 4)
    assert [mma_rate.k_chunk(k, s8) for k in (128, 256, 384, 512, 64, 192)] == \
        [64, 128, 64, 128, 0, 0]
    assert [mma_rate.k_chunk(2 * k, bf16) for k in (128, 256, 384, 512, 64, 192)] == \
        [64, 128, 64, 128, 0, 0]


def _add_rz(a, b):
    """a + b in f32, rounded toward zero (from the exact sum in float64)."""
    s = a.double() + b.double()
    r = s.float()
    return torch.where(r.double().abs() > s.abs(), torch.nextafter(r, torch.zeros_like(r)), r)


def _conv0_f32_as_kernel_c(x, w, b, truncate):
    """Kernel C's f32 body (csrc/conv0_f.cu, 3xTF32) in PyTorch: each
    activation split into rna_tf32 hi and lo, the weights as
    ``pack_conv0_f32_weights`` splits them (rebuilt from the packed A
    fragments), K = 9 taps x 4 slots (c0, c1, c2, 0) zero-padded to 40, and
    per k-step of 8 (two taps) three MMAs into one f32 accumulator: lo_x * hi_w,
    hi_x * lo_w, hi_x * hi_w. An MMA adds its 8 exact products to the
    accumulator with one rounding to nearest, or (``truncate``) as 8 f32
    adds in turn, each rounded toward zero. Then the phase max, + bias, ReLU."""
    bsz, h, wd, c = x.shape
    wa = conv_stage1.pack_conv0_f32_weights(w.float().reshape(27, 64))
    wm = torch.zeros(2, 40, 64)                        # [hi/lo, k = 8j + 4 (r // 2) + q, channel]
    for t in range(128):
        for r in range(4):
            k = 8 * torch.arange(5) + 4 * (r // 2) + t % 4
            wm[:, k, 16 * (t // 32) + t % 32 // 4 + 8 * (r % 2)] = wa[t, :, :, r]
    xp = F.pad(x.float(), (0, 1, 1, 1, 1, 1))          # a zero 4th slot
    cols = torch.cat([xp[:, kh:kh + h, kw:kw + wd] for kh in range(3) for kw in range(3)], -1)
    cols = F.pad(cols, (0, 4))                         # [B, H, W, 40]: tap 9 is zero
    xh = _tf32_rna(cols)
    xl = _tf32_rna(cols - xh)
    acc = torch.zeros((bsz, h, wd, 64))
    for s in range(5):
        ks = slice(8 * s, 8 * s + 8)
        for a, bm in ((xl, wm[0]), (xh, wm[1]), (xh, wm[0])):
            prods = a[..., ks, None] * bm[ks]          # exact: TF32 x TF32 fits f32
            if truncate:
                for i in range(8):
                    acc = _add_rz(acc, prods[..., i, :])
            else:
                acc = (acc.double() + prods.double().sum(-2)).float()
    m = acc.reshape(bsz, h // 2, 2, wd // 2, 2, -1).amax(dim=(2, 4))
    return torch.relu(m + b.float())


def _conv0_f_in_order(x, w, b, order):
    """``conv0_f_plain`` with its 27 exact f32 products summed in another
    order: ``reversed`` taps, or a ``pairwise`` tree."""
    bsz, h, wd, c = x.shape
    w32 = w.to(x.dtype).float().reshape(27, -1)
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))
    prods = [xp[:, kh:kh + h, kw:kw + wd, ci:ci + 1] * w32[(kh * 3 + kw) * c + ci]
             for kh in range(3) for kw in range(3) for ci in range(c)]
    if order == "reversed":
        acc = torch.zeros_like(prods[0])
        for p in reversed(prods):
            acc = acc + p
    else:
        while len(prods) > 1:
            prods = [prods[i] + prods[i + 1] if i + 1 < len(prods) else prods[i]
                     for i in range(0, len(prods), 2)]
        acc = prods[0]
    m = acc.reshape(bsz, h // 2, 2, wd // 2, 2, -1).amax(dim=(2, 4))
    return torch.relu(m + b.to(x.dtype).float()).to(x.dtype)


# (mode, summation, inputs): bf16 in other orders of exact products; f32
# through the 3xTF32 model, its MMAs rounding once or truncating each add, on
# random inputs and on inputs with cancellation (mixed signs, magnitudes 1e-3
# to 1e3), and in another order of the plain version's products
KERNEL_C_BOUND_CASES = {
    "reversed": ("bfloat16", "reversed", "random"),
    "pairwise": ("bfloat16", "pairwise", "random"),
    "float32-3xtf32": ("float32", "3xtf32", "random"),
    "float32-3xtf32_truncating": ("float32", "3xtf32_truncating", "random"),
    "float32-3xtf32-cancellation": ("float32", "3xtf32", "cancellation"),
    "float32-3xtf32_truncating-cancellation": ("float32", "3xtf32_truncating", "cancellation"),
    "float32-pairwise": ("float32", "pairwise", "random"),
}


@pytest.mark.parametrize("case", list(KERNEL_C_BOUND_CASES))
def test_kernel_c_bf16_bound_covers_other_summation_orders(case):
    """The bound that holds kernel C (tensor-core order; f32 through 3xTF32)
    holds the plain version summed in other orders and the model of the
    3xTF32 body, at (2, 36, 70, 3), and is not vacuous."""
    mode, order, values = KERNEL_C_BOUND_CASES[case]
    g = torch.Generator().manual_seed(2)
    if values == "random":
        x = torch.randn((2, 36, 70, 3), generator=g)
        w = torch.randn((3, 3, 3, 64), generator=g) * 0.2
    else:
        def spread(*shape):
            sign = torch.randint(0, 2, shape, generator=g) * 2.0 - 1
            return sign * 10.0 ** (torch.rand(shape, generator=g) * 6 - 3)
        x, w = spread(2, 36, 70, 3), spread(3, 3, 3, 64) * 1e-3
    b = torch.randn(64, generator=g) * 0.1
    x = x.to(TORCH_DT[mode])
    ref = conv_stage1.conv0_f_plain(x, w, b)
    if order.startswith("3xtf32"):
        other = _conv0_f32_as_kernel_c(x, w, b, truncate=order.endswith("truncating"))
    else:
        other = _conv0_f_in_order(x, w, b, order)
    diff = (other.float() - ref.float()).abs()
    bound = conv_stage1.conv0_f_bound(x, w, ref)
    assert bool((diff <= bound).all()), float((diff - bound).max())
    limit = 0.05 if mode == "bfloat16" else 1e-4
    assert float(bound.max()) < limit * float(ref.float().abs().max())
    if mode == "float32":
        assert float((diff / bound.clamp_min(1e-38)).max()) > 0      # the split is not exact


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


# (shape, values): kernel A's block tile is 16 pooled rows x 32 pooled
# columns, a warp's unit 16 pooled columns. "ragged": pooled 18 x 35, the
# last tile 2 rows and 3 columns; pooled width 23: a unit 7 wide; pooled
# rows 13: an odd count of rows in a partial tile; 448²: the serving shape;
# "extremes": inputs and weights at +-127 (the largest sums, a corner all
# +127); "half_integers": sums multiples of 256 with scale = s1 / 256 and
# bias = s1 / 2, so y / s1 lies a few ulps from a half-integer (the requant's
# division fallback); "tiles_784" and "tiles_1024": more 16 x 32 tiles than
# the card holds blocks at once (at most 3 a SM), so each persistent block
# computes several and prefetches the next, at full tiles and at ragged ones;
# 224²: the baseline and bert models' shape, pooled 112 = 3.5 tiles of 32
# columns (the last tile's second unit lies past the edge), at b2 and at b32
# (784 tiles, persistent blocks)
KERNEL_A_CASES = {"ragged": ((2, 36, 70), "random"), "pooled_width_23": ((1, 20, 46), "random"),
                  "pooled_rows_13": ((3, 26, 36), "random"), "448": ((1, 448, 448), "random"),
                  "224": ((2, 224, 224), "random"), "224_b32": ((32, 224, 224), "random"),
                  "extremes": ((2, 36, 70), "extremes"),
                  "half_integers": ((2, 36, 70), "half_integers"),
                  "tiles_784": ((8, 448, 448), "random"), "tiles_1024": ((256, 36, 70), "random")}


def _kernel_a_inputs(shape, values, g):
    s1 = torch.rand(64, generator=g) * 0.02 + 1e-3
    sc = torch.rand(64, generator=g) * 1e-4 + 1e-5
    b = torch.randn(64, generator=g) * 0.1
    if values == "random":
        x = torch.randint(-127, 128, (*shape, 3), generator=g, dtype=torch.int8)
        w = torch.randint(-127, 128, (3, 3, 3, 64), generator=g, dtype=torch.int8)
    elif values == "extremes":
        x = (torch.randint(0, 2, (*shape, 3), generator=g) * 254 - 127).to(torch.int8)
        x[:, :8, :8] = 127
        w = (torch.randint(0, 2, (3, 3, 3, 64), generator=g) * 254 - 127).to(torch.int8)
        w[..., :4] = 127
    else:
        x = (torch.randint(-7, 8, (*shape, 3), generator=g) * 16).to(torch.int8)
        w = (torch.randint(-7, 8, (3, 3, 3, 64), generator=g) * 16).to(torch.int8)
        sc, b = s1 / 256, s1 / 2
    return x, w, sc, b, s1


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(KERNEL_A_CASES))
@pytest.mark.parametrize("mode", ["float32", "bfloat16", "int8"])
def test_kernel_a_bit_equal_to_plain_on_card(cuda, mode, case):
    g = torch.Generator().manual_seed(0)
    shape, values = KERNEL_A_CASES[case]
    x, w, sc, b, s1 = (v.to(cuda) for v in _kernel_a_inputs(shape, values, g))
    kw = {"s1": s1} if mode == "int8" else {"out_dtype": TORCH_DT[mode]}
    _build.reset_counts()
    out = conv_stage1.conv0_i8(x, w, sc, b, **kw)
    assert _build.CONV0_S2D_I8.launches == 1
    assert torch.equal(out, conv_stage1.conv0_i8_plain(x, w, sc, b, **kw))
    assert _build.CONV0_S2D_I8.launches == 1 and _build.CONV0_S2D_I8.plain_on_cuda == 1


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [1, 4, 8])
def test_kernel_a_unaligned_image_on_card(cuda, offset):
    """An image at 1 byte past an allocation's start is cloned by the
    wrapper (the launcher refuses it); at 4 or 8 bytes, not 16-byte
    aligned, it is launched as it lies. Bit-equal either way."""
    g = torch.Generator().manual_seed(4)
    x, w, sc, b, s1 = (v.to(cuda) for v in _kernel_a_inputs((2, 36, 70), "random", g))
    buf = torch.empty(x.numel() + 16, dtype=torch.int8, device=cuda)
    xv = buf[offset:offset + x.numel()].view(x.shape)
    xv.copy_(x)
    assert xv.data_ptr() % 16 == offset
    for kw in ({"s1": s1}, {"out_dtype": torch.bfloat16}):
        _build.reset_counts()
        out = conv_stage1.conv0_i8(xv, w, sc, b, **kw)
        assert _build.CONV0_S2D_I8.launches == 1
        assert torch.equal(out, conv_stage1.conv0_i8_plain(x, w, sc, b, **kw))
    if offset % 4:
        wf = conv_stage1.pack_conv0_i8_weights(w)
        out = torch.empty((2, 18, 35, 64), dtype=torch.int8, device=cuda)
        with pytest.raises(RuntimeError, match="cudaError 716"):
            _build.CONV0_S2D_I8.launch(xv.data_ptr(), wf.data_ptr(), sc.data_ptr(), b.data_ptr(),
                                       s1.data_ptr(), out.data_ptr(), 2, 36, 70, 2)


# (C_in, C_out): every VGG conv1-7 pair, a C_in that is not a multiple of
# 64, a single chunk, and C_out % 128 == 64 (a block's last 64 channels are
# zero padding, never stored)
KERNEL_B_CHANNELS = [(64, 128), (128, 256), (256, 256), (256, 512), (512, 512),
                     (96, 128), (32, 64), (64, 192)]


@pytest.mark.cuda
@pytest.mark.parametrize("hw", [(13, 22), (7, 9)])
@pytest.mark.parametrize("channels", KERNEL_B_CHANNELS)
@pytest.mark.parametrize("pool", [False, True])
@pytest.mark.parametrize("mode", ["float32", "bfloat16", "int8"])
def test_kernel_b_bit_equal_to_plain_on_card(cuda, mode, pool, channels, hw):
    c, o = channels
    g = torch.Generator().manual_seed(1)
    x = torch.randint(-127, 128, (2, *hw, c), generator=g, dtype=torch.int8).to(cuda)
    w = torch.randint(-127, 128, (3, 3, c, o), generator=g, dtype=torch.int8).to(cuda)
    sc = (torch.rand(o, generator=g) * 1e-5 + 1e-6).to(cuda)
    b = (torch.randn(o, generator=g) * 0.1).to(cuda)
    kw = ({"s_next": (torch.rand(o, generator=g) * 0.02 + 1e-3).to(cuda)}
          if mode == "int8" else {"out_dtype": TORCH_DT[mode]})
    _build.reset_counts()
    out = conv_hpack.int8_conv3x3(x, w, sc, b, pool=pool, **kw)
    assert _build.CONV3X3_I8.launches == 1
    assert torch.equal(out, conv_hpack.int8_conv3x3_plain(x, w, sc, b, pool=pool, **kw))


# conv1-7 at 224² (H = W, C_in, C_out, pool): conv1 on the fused stem's
# 112-wide hand-off (3.5 tiles of 32 columns), conv6-7 at 14 x 14 (most of
# an 8 x 32 tile masked)
KERNEL_B_224 = {"conv1": (112, 64, 128, True), "conv2": (56, 128, 256, False),
                "conv3": (56, 256, 256, True), "conv4": (28, 256, 512, False),
                "conv5": (28, 512, 512, True), "conv6": (14, 512, 512, False),
                "conv7": (14, 512, 512, True)}


@pytest.mark.cuda
@pytest.mark.parametrize("layer", list(KERNEL_B_224))
@pytest.mark.parametrize("mode", ["float32", "bfloat16", "int8"])
def test_kernel_b_bit_equal_at_224_shapes_on_card(cuda, mode, layer):
    hw, c, o, pool = KERNEL_B_224[layer]
    g = torch.Generator().manual_seed(3)
    x = torch.randint(-127, 128, (2, hw, hw, c), generator=g, dtype=torch.int8).to(cuda)
    w = torch.randint(-127, 128, (3, 3, c, o), generator=g, dtype=torch.int8).to(cuda)
    sc = (torch.rand(o, generator=g) * 1e-5 + 1e-6).to(cuda)
    b = (torch.randn(o, generator=g) * 0.1).to(cuda)
    kw = ({"s_next": (torch.rand(o, generator=g) * 0.02 + 1e-3).to(cuda)}
          if mode == "int8" else {"out_dtype": TORCH_DT[mode]})
    _build.reset_counts()
    out = conv_hpack.int8_conv3x3(x, w, sc, b, pool=pool, **kw)
    assert _build.CONV3X3_I8.launches == 1
    assert torch.equal(out, conv_hpack.int8_conv3x3_plain(x, w, sc, b, pool=pool, **kw))


@pytest.mark.cuda
def test_kernel_b_rejects_unsupported_channels_on_card(cuda):
    x = torch.zeros((1, 4, 4, 48), dtype=torch.int8, device=cuda)
    w = torch.zeros((3, 3, 48, 64), dtype=torch.int8, device=cuda)
    one = torch.ones(64, device=cuda)
    with pytest.raises(ValueError, match="C % 32"):
        conv_hpack.int8_conv3x3(x, w, one, one, pool=False)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 36, 70), (2, 224, 224), (2, 448, 448)],
                         ids=["ragged", "224", "448"])
@pytest.mark.parametrize("mode", ["float32", "bfloat16"])
def test_kernel_c_matches_plain_on_card(cuda, mode, shape):
    """Both modes within ``conv0_f_bound`` (tensor-core order; f32 through
    3xTF32). At 224² the pooled 112 x 112 map is less than one 128-pixel
    bf16 tile per row pair and 3.5 f32 units of 32 pooled columns (the last
    unit's right half lies past the edge); at 448², 7 units; at 36 x 70, 18
    pooled rows end in a partial unit of 4 and 35 pooled columns in one of 3."""
    g = torch.Generator().manual_seed(2)
    x = torch.randn((*shape, 3), generator=g).to(cuda, TORCH_DT[mode])
    w = (torch.randn((3, 3, 3, 64), generator=g) * 0.2).to(cuda)
    b = (torch.randn(64, generator=g) * 0.1).to(cuda)
    _build.reset_counts()
    out = conv_stage1.conv0_f(x, w, b)
    assert _build.CONV0_F.launches == 1 and out.dtype == TORCH_DT[mode]
    ref = conv_stage1.conv0_f_plain(x, w, b)
    assert _build.CONV0_F.launches == 1 and _build.CONV0_F.plain_on_cuda == 1
    diff = (out.float() - ref.float()).abs()
    assert bool((diff <= conv_stage1.conv0_f_bound(x, w, ref)).all())


@pytest.mark.cuda
def test_kernels_repeat_bit_for_bit_on_card(cuda):
    """Two launches of each kernel on the same inputs give the same bits
    (no atomics; kernel F's split sums added in a fixed order): resumed
    training stays exact. Kernel D pooled and unpooled at a shape whose
    persistent blocks walk several tiles, kernel E with 8 slices of D a
    sample and level, kernel F with 1,120 units over its clusters."""
    g = torch.Generator().manual_seed(3)
    x0 = torch.randint(-127, 128, (2, 36, 70, 3), generator=g, dtype=torch.int8).to(cuda)
    w0 = torch.randint(-127, 128, (3, 3, 3, 64), generator=g, dtype=torch.int8).to(cuda)
    x1 = torch.randint(-127, 128, (2, 13, 22, 128), generator=g, dtype=torch.int8).to(cuda)
    w1 = torch.randint(-127, 128, (3, 3, 128, 256), generator=g, dtype=torch.int8).to(cuda)
    xf = torch.randn((2, 36, 70, 3), generator=g).to(cuda)
    wf = (torch.randn((3, 3, 3, 64), generator=g) * 0.2).to(cuda)
    s64, s256 = torch.full((64,), 1e-4, device=cuda), torch.full((256,), 1e-6, device=cuda)
    calls = [lambda: conv_stage1.conv0_i8(x0, w0, s64, s64, out_dtype=torch.bfloat16),
             lambda: conv_hpack.int8_conv3x3(x1, w1, s256, s256, pool=True,
                                             out_dtype=torch.bfloat16),
             lambda: conv_stage1.conv0_f(xf.bfloat16(), wf, s64),
             lambda: conv_stage1.conv0_f(xf, wf, s64)]
    x3 = torch.randn((4, 100, 130, 64), generator=g).to(cuda)     # blocks walk several tiles
    w3 = (torch.randn((3, 3, 64, 128), generator=g) * 0.05).to(cuda)
    v, q, params = _kernel_e_inputs((2, 49, 7, 512), g, cuda)
    calls += [lambda: conv_hpack.conv3x3_f(x3.bfloat16(), w3, s256[:128]),
              lambda: conv_hpack.conv3x3_f(x3, w3, s256[:128]),
              lambda: conv_hpack.conv3x3_f(x3.bfloat16(), w3, s256[:128], pool=False),
              lambda: conv_hpack.conv3x3_f(x3, w3, s256[:128], pool=False),
              lambda: torch.cat(coattention_kernel.coattention_fwd(v.bfloat16(), q.bfloat16(),
                                                                   *params)),
              lambda: torch.cat(coattention_kernel.coattention_fwd(v, q, *params))]
    # kernel F: its clusters walk several units and add their partial sums
    from vqa_tpu_torch.ops import mma_rate
    xf8 = torch.randint(-8, 9, (40, 16, 224, 256), generator=g, dtype=torch.int8).to(cuda)
    wf8 = torch.randint(-8, 9, (6, 256, 128), generator=g, dtype=torch.int8).to(cuda)
    calls += [lambda: mma_rate.mma_rate(xf8, wf8),
              lambda: mma_rate.mma_rate(xf8.bfloat16(), wf8.bfloat16())]
    _build.reset_counts()
    for call in calls:
        assert torch.equal(call(), call())
    assert [k.launches for k in _build.KERNELS] == [2, 2, 4, 8, 4, 4]


# (shape (B, H, W), C_in, C_out): odd H and W (pooled 9 x 18, partial 4 x
# 16 tiles, the last row and column of conv outputs unused); C_out 200 (a
# second slice of 128 channels, 72 of them stored) with C_in 96 (6 chunks of
# bf16 and 12 of f32: the weights stream with the halo, they do not fit
# beside it); C 8 (one chunk, zero-filled past C); VGG conv1 at 224² (x [2,
# 112, 112, 64]) and at 448² (x [1, 224, 224, 64]), whose weights stay
# resident in bf16; VGG conv7 at 448² (C = C_out = 512 at 28², 4 slices, 32
# chunks of bf16 and 64 of f32); 4 images at pooled 50 x 65: 260 tiles of
# 4 x 16 pooled pixels (f32) or 520 of 4 x 8 (bf16, two streams), over 132
# persistent blocks on an H100, a count that is no multiple of them; W 41,
# H 11 and C_out 72: unpooled, the last tile's TMA store boxes end mid-box
# in W (41 = 2 x 16 + 9 in bf16, 32 + 9 in f32), in H (8 + 3) and in C_out
# (the third 32- or 16-channel piece holds 8 channels)
KERNEL_D_CASES = {"odd": ((2, 19, 37), 64, 128), "channels_96_200": ((2, 12, 20), 96, 200),
                  "channels_8": ((1, 6, 10), 8, 8), "conv1_224": ((2, 112, 112), 64, 128),
                  "conv1_448": ((1, 224, 224), 64, 128), "conv7_28": ((2, 28, 28), 512, 512),
                  "tiles_260": ((4, 100, 130), 64, 128), "ragged_41": ((2, 11, 41), 64, 72)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(KERNEL_D_CASES))
@pytest.mark.parametrize("mode", ["float32", "bfloat16"])
def test_kernel_d_matches_plain_on_card(cuda, mode, case):
    """``conv_bn_relu_pool`` with its default float route launches kernel D,
    within ``conv3x3_f_bound`` of ``conv3x3_f_plain``."""
    shape, c, o = KERNEL_D_CASES[case]
    g = torch.Generator().manual_seed(6)
    x = torch.relu(torch.randn((*shape, c), generator=g)).to(cuda, TORCH_DT[mode])
    w = (torch.randn((3, 3, c, o), generator=g) * 0.1).to(cuda)
    b = (torch.randn(o, generator=g) * 0.1).to(cuda)
    _build.reset_counts()
    out = conv_hpack.conv_bn_relu_pool(x, w, b)
    assert _build.CONV3X3_F.launches == 1 and out.dtype == TORCH_DT[mode]
    ref = conv_hpack.conv3x3_f_plain(x, w, b)
    assert _build.CONV3X3_F.launches == 1 and _build.CONV3X3_F.plain_on_cuda == 1
    assert tuple(out.shape) == (shape[0], shape[1] // 2, shape[2] // 2, o)
    diff = (out.float() - ref.float()).abs()
    assert bool((diff <= conv_hpack.conv3x3_f_bound(x, w, ref)).all())


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(KERNEL_D_CASES))
@pytest.mark.parametrize("mode", ["float32", "bfloat16"])
def test_kernel_d_unpooled_matches_plain_on_card(cuda, mode, case):
    """Kernel D's unpooled mode (``conv3x3_f(..., pool=False)``, every conv
    pixel stored by TMA) within ``conv3x3_f_bound(pool=False)`` of
    ``conv3x3_f_plain(pool=False)``, at the pooled test's shapes (odd H and
    W: the last partial tile's rows and columns are stored too; boxes that
    end past H, W and C_out are clipped by TMA, and nothing past them is
    written: the output is allocated filled with NaN first)."""
    shape, c, o = KERNEL_D_CASES[case]
    g = torch.Generator().manual_seed(16)
    x = torch.relu(torch.randn((*shape, c), generator=g)).to(cuda, TORCH_DT[mode])
    w = (torch.randn((3, 3, c, o), generator=g) * 0.1).to(cuda)
    b = (torch.randn(o, generator=g) * 0.1).to(cuda)
    _build.reset_counts()
    out = conv_hpack.conv3x3_f(x, w, b, pool=False)
    assert _build.CONV3X3_F.launches == 1 and out.dtype == TORCH_DT[mode]
    # the same launch into a NaN-filled buffer with a margin after the
    # output: the clipped boxes write nothing past it, and every element of
    # the output is written
    wp, b32 = conv_hpack.conv3x3_f_operands(x, w, b)
    buf = torch.full((out.numel() + 64 * 1024,), float("nan"), dtype=x.dtype, device=cuda)
    _build.CONV3X3_F.launch(x.data_ptr(), wp.data_ptr(), b32.data_ptr(), buf.data_ptr(),
                            *shape, c, o, conv_hpack._MODES[x.dtype], 0)
    torch.cuda.synchronize()
    assert torch.equal(buf[:out.numel()].view_as(out), out)
    assert bool(buf[out.numel():].isnan().all())
    ref = conv_hpack.conv3x3_f_plain(x, w, b, pool=False)
    assert _build.CONV3X3_F.plain_on_cuda == 1 and tuple(out.shape) == (*shape, o)
    diff = (out.float() - ref.float()).abs()
    assert bool((diff <= conv_hpack.conv3x3_f_bound(x, w, ref, pool=False)).all())


# (G, R, W, K, ndots): the TPU probe's three contraction depths (M = R W =
# 3,584, the output rows W = 224) at a few steps (K 128: a K share of 64
# bytes in both types, the 64-byte swizzle), and small shapes: one unit a
# step (M 128, all rows stored), W 100 (M 3,200: rows 100-127 of the first
# unit computed but not stored, a warp's rows split by the edge), K 384
# (shares of 192 bytes: three 64-byte chunks), and 67 units, a count that
# is no multiple of the clusters an H100 holds (at most 66 of 2 blocks, 33
# of 4), so some clusters take one unit more
KERNEL_F_CASES = {"k128": (3, 16, 224, 128, 12), "k256": (3, 16, 224, 256, 6),
                  "k512": (3, 16, 224, 512, 3), "one_unit": (5, 1, 128, 128, 1),
                  "w100": (2, 32, 100, 256, 2), "k384": (2, 16, 224, 384, 4),
                  "units_67": (67, 1, 128, 256, 6)}


@pytest.mark.cuda
@pytest.mark.parametrize("values", ["twos", "random"])
@pytest.mark.parametrize("case", list(KERNEL_F_CASES))
@pytest.mark.parametrize("mode", ["int8", "bfloat16"])
def test_kernel_f_equals_plain_on_card(cuda, mode, case, values):
    """Kernel F (``mma_rate``) equals ``mma_rate_plain`` bit for bit: the
    TPU probe's all-2 operands, and random integers in [-8, 8] whose sums
    stay exact in f32 (a fault in the layout shows there, not with 2s)."""
    from vqa_tpu_torch.ops import mma_rate

    g_, r, wd, k, nd = KERNEL_F_CASES[case]
    dt = torch.int8 if mode == "int8" else torch.bfloat16
    if values == "twos":
        x, w = torch.full((g_, r, wd, k), 2), torch.full((nd, k, 128), 2)
    else:
        gen = torch.Generator().manual_seed(17)
        x = torch.randint(-8, 9, (g_, r, wd, k), generator=gen)
        w = torch.randint(-8, 9, (nd, k, 128), generator=gen)
    x, w = x.to(cuda, dt), w.to(cuda, dt)
    _build.reset_counts()
    out = mma_rate.mma_rate(x, w)
    assert _build.MMA_RATE.launches == 1
    ref = mma_rate.mma_rate_plain(x, w)
    assert out.dtype == ref.dtype and tuple(out.shape) == (g_, wd, 128)
    assert torch.equal(out, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("mode,k", [("int8", 64), ("int8", 192), ("bfloat16", 64),
                                    ("bfloat16", 192)])
def test_kernel_f_rejects_k_the_cluster_cannot_split_on_card(cuda, mode, k):
    """K must split into CLUSTER shares of a multiple of 64 bytes (s8 2, bf16
    4 blocks a cluster: K a multiple of 128 values): anything else raises,
    with no fallback and no launch."""
    from vqa_tpu_torch.ops import mma_rate

    dt = torch.int8 if mode == "int8" else torch.bfloat16
    x = torch.full((1, 1, 128, k), 2, dtype=dt, device=cuda)
    w = torch.full((1, k, 128), 2, dtype=dt, device=cuda)
    _build.reset_counts()
    with pytest.raises(ValueError, match="splits K across"):
        mma_rate.mma_rate(x, w)
    assert _build.MMA_RATE.launches == 0


def _kernel_e_inputs(shape, g, device):
    """V [B, S, D] (ReLU features), Q [B, 3, L, D] and the kernel's six
    parameters (W_v, b_v, W_q, b_q, w_v, w_q) at the model's init scale."""
    b, s, l, d = shape
    lim = d ** -0.5
    params = [((torch.rand(sh, generator=g) * 2 - 1) * lim).to(device)
              for sh in ((d, d), (d,), (d, d), (d,), (d, 1), (d, 1))]
    v = (torch.relu(torch.randn((b, s, d), generator=g)) * 2).to(device)
    q = torch.randn((b, 3, l, d), generator=g).to(device)
    return v, q, params


# (B, S, L, D): the attention model's shape at b32 (S 196 = 14², L 23) and at
# b3 with S 49 (224²); B 6 (not a multiple of the TPU kernel's block of 4)
# at a small width (one slice of D, 32 wide); S 7 and L 1 (odd, a single
# word); D 96 (a slice of 64 and a ragged one of 32)
KERNEL_E_CASES = {"b32": (32, 196, 23, 512), "s49": (3, 49, 23, 512),
                  "small": (6, 16, 5, 32), "odd": (1, 7, 1, 64), "d96": (4, 49, 23, 96)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(KERNEL_E_CASES))
@pytest.mark.parametrize("mode", ["float32", "bfloat16"])
def test_kernel_e_matches_plain_on_card(cuda, mode, case):
    """``coattention_fused``'s forward launches kernel E once, within
    ``coattention_bound`` of ``coattention_plain``."""
    g = torch.Generator().manual_seed(7)
    v, q, (wv_, bv, wq_, bq, sv, sq) = _kernel_e_inputs(KERNEL_E_CASES[case], g, cuda)
    v, q = v.to(TORCH_DT[mode]), q.to(TORCH_DT[mode])
    zero = torch.zeros(1, device=cuda)
    params = (wv_, bv, wq_, bq, sv, zero, sq, zero)
    _build.reset_counts()
    img, ques = coattention_kernel.coattention_fused(params, v, list(q.unbind(1)))
    assert _build.COATTENTION_FWD.launches == 1
    ref = coattention_kernel.coattention_plain(v, q, wv_, bv, wq_, bq, sv, sq)
    assert _build.COATTENTION_FWD.plain_on_cuda == 1
    for out, r, bound in zip((torch.stack(img, 1), torch.stack(ques, 1)), ref,
                             coattention_kernel.coattention_bound(v, q, *ref)):
        assert out.dtype == TORCH_DT[mode] and out.shape == r.shape
        assert bool(((out.float() - r.float()).abs() <= bound).all())


@pytest.mark.cuda
def test_kernel_e_gradients_on_card(cuda):
    """Gradients through kernel E's forward equal autograd through
    ``coattention_reference`` for one cotangent: the backward recomputes
    through it."""
    g = torch.Generator().manual_seed(8)
    v, q, (wv_, bv, wq_, bq, sv, sq) = _kernel_e_inputs((4, 49, 23, 128), g, cuda)
    cv, cq = torch.randn(1, generator=g).to(cuda), torch.randn(1, generator=g).to(cuda)
    cot = torch.randn((2, 4, 3, 128), generator=g).to(cuda)
    grads = []
    for fn in (coattention_kernel.coattention_fused, coattention_kernel.coattention_reference):
        leaves = [t.clone().requires_grad_() for t in (v, q, wv_, bv, wq_, bq, sv, cv, sq, cq)]
        img, ques = fn(tuple(leaves[2:]), leaves[0], list(leaves[1].unbind(1)))
        out = torch.stack([torch.stack(img, 1), torch.stack(ques, 1)])
        out.backward(cot)
        grads.append([t.grad for t in leaves])
    for a, b in zip(*grads):
        assert torch.allclose(a, b, rtol=0, atol=1e-6 * float(b.abs().max()) + 1e-12)


@pytest.mark.cuda
def test_float_conv0_route_raises_on_card(cuda):
    """The float route launches kernel C, which takes only even H and W
    and float32/bfloat16 images: anything else raises, with no fallback."""
    w, b = torch.zeros(3, 3, 3, 64), torch.zeros(64)
    with pytest.raises(ValueError, match="even"):
        conv_stage1.conv0_bn_relu_pool(torch.zeros((1, 8, 9, 3), device=cuda), w, b)
    with pytest.raises(ValueError, match="float32/bfloat16"):
        conv_stage1.conv0_bn_relu_pool(
            torch.zeros((1, 8, 8, 3), device=cuda, dtype=torch.float16), w, b)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["conv0_i8", "int8_conv3x3", "conv0_f", "conv3x3_f",
                                  "coattention_fwd", "mma_rate"])
def test_kernel_operators_pass_opcheck_on_card(cuda, name):
    """``torch.library.opcheck`` of each registered operator on CUDA tensors
    (its CUDA implementation, which launches the kernel, against its fake),
    and the operator's output equal to a direct launch's."""
    from vqa_tpu_torch.ops import library

    g = torch.Generator().manual_seed(12)
    x0 = torch.randint(-127, 128, (2, 8, 10, 3), generator=g, dtype=torch.int8)
    x1 = torch.randint(-127, 128, (2, 6, 8, 64), generator=g, dtype=torch.int8)
    s64 = torch.rand(64, generator=g) * 1e-4 + 1e-5
    b64 = torch.randn(64, generator=g) * 0.1
    sn = torch.rand(64, generator=g) * 0.02 + 1e-3
    cases = {
        "conv0_i8": [(x0, torch.randint(-127, 128, (3, 3, 3, 64), generator=g,
                                        dtype=torch.int8), s64, b64, torch.bfloat16, None),
                     (x0, torch.randint(-127, 128, (3, 3, 3, 64), generator=g,
                                        dtype=torch.int8), s64, b64, torch.float32, sn)],
        "int8_conv3x3": [(x1, torch.randint(-127, 128, (3, 3, 64, 64), generator=g,
                                            dtype=torch.int8), s64 / 10, b64, True, sn,
                          torch.float32),
                         (x1, torch.randint(-127, 128, (3, 3, 64, 64), generator=g,
                                            dtype=torch.int8), s64 / 10, b64, False, None,
                          torch.bfloat16)],
        "conv0_f": [(torch.randn((2, 8, 10, 3), generator=g), torch.randn(3, 3, 3, 64) * 0.2,
                     b64),
                    (torch.randn((2, 8, 10, 3), generator=g).bfloat16(),
                     torch.randn(3, 3, 3, 64) * 0.2, b64)],
        "conv3x3_f": [(torch.randn((2, 8, 10, 16), generator=g), torch.randn(3, 3, 16, 64) * 0.1,
                       b64),
                      (torch.randn((2, 9, 11, 16), generator=g).bfloat16(),
                       torch.randn(3, 3, 16, 64) * 0.1, b64),
                      (torch.randn((2, 9, 11, 16), generator=g).bfloat16(),
                       torch.randn(3, 3, 16, 64) * 0.1, b64, False)],
        "coattention_fwd": [(v.to(dt), q.to(dt), *params) for dt in (torch.float32, torch.bfloat16)
                            for v, q, params in [_kernel_e_inputs((2, 16, 5, 64), g, "cpu")]],
        "mma_rate": [(torch.randint(-8, 9, (2, 2, 64, 128), generator=g, dtype=torch.int8),
                      torch.randint(-8, 9, (3, 128, 128), generator=g, dtype=torch.int8)),
                     (torch.randint(-8, 9, (2, 1, 128, 128), generator=g).bfloat16(),
                      torch.randint(-8, 9, (2, 128, 128), generator=g).bfloat16())],
    }
    op = library.OPS[name]
    for args in cases[name]:
        args = tuple(a.to(cuda) if isinstance(a, torch.Tensor) else a for a in args)
        result = torch.library.opcheck(op, args)
        assert set(result.values()) == {"SUCCESS"}, result
        _build.reset_counts()
        out = op(*args)
        out = torch.cat(out) if isinstance(out, tuple) else out
        assert out.is_cuda and sum(k.launches for k in _build.KERNELS) == 1
        direct = library.CUDA_IMPLS[name](*args)
        assert torch.equal(out, torch.cat(direct) if isinstance(direct, tuple) else direct)
