"""The port's CUDA kernels against their plain PyTorch versions.

This file imports no JAX, so it also runs where only the port is installed.
On a machine with a card and nvcc, run the card tests with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py -m cuda

(``--noconftest``: the suite's conftest sets up JAX). There each kernel mode
must equal its plain version bit for bit, at odd shapes that exercise the
tile edges, except kernel C in bf16, which sums on the tensor cores in
another order and is held within ``conv_stage1.conv0_f_bound``. Without a
card those tests skip; the dispatch contract, the weight layouts and the
soundness of that bound run everywhere.
"""

import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from vqa_tpu_torch import _build
from vqa_tpu_torch.ops import conv_hpack, conv_stage1, quant

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


def _conv0_bf16_in_order(x, w, b, order):
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


@pytest.mark.parametrize("order", ["reversed", "pairwise"])
def test_kernel_c_bf16_bound_covers_other_summation_orders(order):
    """The bound that holds kernel C's bf16 mode (tensor-core order) holds
    the plain version summed in other orders too, at (2, 36, 70, 3)."""
    g = torch.Generator().manual_seed(2)
    x = torch.randn((2, 36, 70, 3), generator=g).to(torch.bfloat16)
    w = torch.randn((3, 3, 3, 64), generator=g) * 0.2
    b = torch.randn(64, generator=g) * 0.1
    ref = conv_stage1.conv0_f_plain(x, w, b)
    other = _conv0_bf16_in_order(x, w, b, order)
    diff = (other.float() - ref.float()).abs()
    bound = conv_stage1.conv0_f_bound(x, w, ref)
    assert bool((diff <= bound).all()), float((diff - bound).max())
    assert float(bound.max()) < 0.05 * float(ref.float().abs().max())


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
@pytest.mark.parametrize("shape", [(2, 36, 70), (2, 224, 224)], ids=["ragged", "224"])
@pytest.mark.parametrize("mode", ["float32", "bfloat16"])
def test_kernel_c_matches_plain_on_card(cuda, mode, shape):
    """f32: bit-equal. bf16: within ``conv0_f_bound`` (tensor-core order).
    At 224² the pooled 112 x 112 map is less than one 128-pixel bf16 tile
    per row pair."""
    g = torch.Generator().manual_seed(2)
    x = torch.randn((*shape, 3), generator=g).to(cuda, TORCH_DT[mode])
    w = (torch.randn((3, 3, 3, 64), generator=g) * 0.2).to(cuda)
    b = (torch.randn(64, generator=g) * 0.1).to(cuda)
    _build.reset_counts()
    out = conv_stage1.conv0_f(x, w, b)
    assert _build.CONV0_F.launches == 1 and out.dtype == TORCH_DT[mode]
    ref = conv_stage1.conv0_f_plain(x, w, b)
    assert _build.CONV0_F.launches == 1 and _build.CONV0_F.plain_on_cuda == 1
    if mode == "float32":
        assert torch.equal(out, ref)
    else:
        diff = (out.float() - ref.float()).abs()
        assert bool((diff <= conv_stage1.conv0_f_bound(x, w, ref)).all())


@pytest.mark.cuda
def test_kernels_repeat_bit_for_bit_on_card(cuda):
    """Two launches of each kernel on the same inputs give the same bits
    (no atomics, no split sums): resumed training stays exact."""
    g = torch.Generator().manual_seed(3)
    x0 = torch.randint(-127, 128, (2, 36, 70, 3), generator=g, dtype=torch.int8).to(cuda)
    w0 = torch.randint(-127, 128, (3, 3, 3, 64), generator=g, dtype=torch.int8).to(cuda)
    x1 = torch.randint(-127, 128, (2, 13, 22, 128), generator=g, dtype=torch.int8).to(cuda)
    w1 = torch.randint(-127, 128, (3, 3, 128, 256), generator=g, dtype=torch.int8).to(cuda)
    xf = torch.randn((2, 36, 70, 3), generator=g).to(cuda, torch.bfloat16)
    wf = (torch.randn((3, 3, 3, 64), generator=g) * 0.2).to(cuda)
    s64, s256 = torch.full((64,), 1e-4, device=cuda), torch.full((256,), 1e-6, device=cuda)
    calls = [lambda: conv_stage1.conv0_i8(x0, w0, s64, s64, out_dtype=torch.bfloat16),
             lambda: conv_hpack.int8_conv3x3(x1, w1, s256, s256, pool=True,
                                             out_dtype=torch.bfloat16),
             lambda: conv_stage1.conv0_f(xf, wf, s64)]
    _build.reset_counts()
    for call in calls:
        assert torch.equal(call(), call())
    assert all(k.launches == 2 for k in _build.KERNELS)


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
