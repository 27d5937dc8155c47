"""Port int8 conv ops (vqa_tpu_torch.ops) vs the JAX package's.

Inputs come from numpy seeds and go through both packages: the JAX side's
plain XLA fallbacks (``_xla_reference_i8`` / ``_xla_reference``) and its
Pallas kernels in interpret mode (``force="pallas"``, as
tests/test_conv_{stage1,hpack,stem}.py run them); the port side's plain
versions, which are what its CUDA wrappers run for CPU tensors.

Tolerances, stated once:

- float outputs: within 1 ulp of their dtype, taken at |output| + |bias|
  (XLA on the CPU contracts ``acc * scale + bias`` into an FMA and the port
  does not; the two differ by at most an ulp of the product, whose size is
  at most |output| + |bias|, which matters where the sum cancels);
- int8 outputs: at most 1 unit apart, in at most max(1, 1e-4 * n) of the
  n elements (a rounding tie moved by that FMA, or by the TPU kernels'
  multiply-by-reciprocal where the port divides).

The CUDA kernels themselves are held to these plain versions by
tests/test_torch_kernels.py and chip_smoke.py on the card: bit for bit,
except kernel C, which sums on the tensor cores in another order (in f32
through 3xTF32) and is held within ``conv_stage1.conv0_f_bound``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vqa_tpu.ops import conv_hpack as j_hpack
from vqa_tpu.ops import conv_stage1 as j_stage1
from vqa_tpu.ops import conv_stem as j_stem
from vqa_tpu_torch.ops import conv_hpack as t_hpack
from vqa_tpu_torch.ops import conv_stage1 as t_stage1
from vqa_tpu_torch.ops import conv_stem as t_stem
from vqa_tpu_torch.ops.quant import quantize, weight_quant

TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JAX_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy() if a.dtype == torch.bfloat16 else a.numpy()
    return np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a)


def assert_within_ulp(ref, out, dtype: str, bias, slack=0.0):
    """|ref - out| <= slack + 1 ulp of ``dtype`` at max(|ref|, |out|) + |bias|
    (``bias`` broadcasts over the channel axis)."""
    ref, out = _np(ref).astype(np.float64), _np(out).astype(np.float64)
    assert ref.shape == out.shape
    mag = np.maximum(np.abs(ref), np.abs(out)) + np.abs(np.asarray(bias, np.float64))
    if dtype == "float32":
        ulp = np.spacing(mag.astype(np.float32)).astype(np.float64)
    else:   # bfloat16: 8 significant bits
        ulp = np.exp2(np.floor(np.log2(np.maximum(mag, 1e-38))) - 7)
    excess = np.abs(ref - out) - slack
    assert np.all(excess <= ulp), float(np.max(excess / ulp))


def assert_float_parity(ref, kern, out, dtype: str, bias):
    """The port within 1 ulp of vqa_tpu's XLA fallback, and no further from
    vqa_tpu's interpret-mode kernel than that fallback is, plus 1 ulp (the
    JAX package's own kernel and fallback differ by a few ulps on the CPU)."""
    assert_within_ulp(ref, out, dtype, bias)
    assert_within_ulp(kern, out, dtype, bias,
                      slack=np.abs(_np(ref).astype(np.float64) - _np(kern)))


def assert_int8_close(ref, out):
    ref, out = _np(ref).astype(np.int32), _np(out).astype(np.int32)
    assert ref.shape == out.shape
    diff = np.abs(ref - out)
    assert diff.max() <= 1
    assert np.count_nonzero(diff) <= max(1, 1e-4 * diff.size), np.count_nonzero(diff)


def _scales(x, axis_c):
    return tuple(float(v) for v in np.abs(x).reshape(-1, axis_c).max(0) / 127.0)


def _conv0_case(seed=0, b=2, h=16, w=16):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, h, w, 3)).astype(np.float32)
    w0 = (rng.standard_normal((3, 3, 3, 64)) * 0.2).astype(np.float32)
    b0 = (rng.standard_normal(64) * 0.1).astype(np.float32)
    return x, w0, b0


def _conv1_case(seed=1, b=2, h=16, w=16, c=64, o=128):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, h, w, c)).astype(np.float32)
    w1 = (rng.standard_normal((3, 3, c, o)) * 0.05).astype(np.float32)
    b1 = (rng.standard_normal(o) * 0.1).astype(np.float32)
    return x, w1, b1


SCALE_MODES = ["dynamic", "per_tensor", "per_channel"]


def _s_x(mode, x, c):
    return {"dynamic": None, "per_tensor": 0.021,
            "per_channel": _scales(x, c) if mode == "per_channel" else None}[mode]


# ------------------------------------------------------------- conv0 (kernel A)

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", SCALE_MODES)
def test_conv0_int8_matches_jax(mode, dtype):
    x, w0, b0 = _conv0_case()
    s_x = _s_x(mode, x, 3)
    xj = jnp.asarray(x).astype(JAX_DT[dtype])
    ref = j_stage1._xla_reference_i8(xj, jnp.asarray(w0), jnp.asarray(b0), s_x=s_x)
    kern = j_stage1.conv0_bn_relu_pool(xj, jnp.asarray(w0), jnp.asarray(b0),
                                       int8=True, s_x=s_x, force="pallas")
    out = t_stage1.conv0_bn_relu_pool(torch.from_numpy(x).to(TORCH_DT[dtype]),
                                      torch.from_numpy(w0), torch.from_numpy(b0),
                                      int8=True, s_x=s_x)
    assert out.dtype == TORCH_DT[dtype] and tuple(out.shape) == (2, 8, 8, 64)
    assert_float_parity(ref, kern, out, dtype, b0)


def test_conv0_float_route_matches_jax_on_cpu():
    x, w0, b0 = _conv0_case(seed=3)
    ref = j_stage1._xla_reference(jnp.asarray(x), jnp.asarray(w0), jnp.asarray(b0))
    out = t_stage1.conv0_bn_relu_pool(torch.from_numpy(x), torch.from_numpy(w0),
                                      torch.from_numpy(b0), int8=False)
    np.testing.assert_allclose(_np(out), _np(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 32, 32, 3), (1, 16, 48, 3)])
def test_conv0_float_plain_matches_tpu_kernel(shape, dtype):
    """Kernel C's plain version vs vqa_tpu's float Pallas kernel
    (``_conv0_pallas``) in interpret mode. f32: atol 1e-5 (the two sum the
    27 products in different orders); bf16: within 1 bf16 ulp of the output
    (an f32 sum that differs in its last bits can round to the next bf16)."""
    b, h, w, _ = shape
    x, w0, b0 = _conv0_case(seed=8, b=b, h=h, w=w)
    xj = jnp.asarray(x).astype(JAX_DT[dtype])
    kern = j_stage1.conv0_bn_relu_pool(xj, jnp.asarray(w0), jnp.asarray(b0),
                                       force="pallas")
    out = t_stage1.conv0_f_plain(torch.from_numpy(x).to(TORCH_DT[dtype]),
                                 torch.from_numpy(w0), torch.from_numpy(b0))
    assert out.dtype == TORCH_DT[dtype] and tuple(out.shape) == (b, h // 2, w // 2, 64)
    if dtype == "float32":
        np.testing.assert_allclose(_np(out), _np(kern), rtol=0, atol=1e-5)
    else:
        assert_within_ulp(kern, out, dtype, 0.0)


def test_conv0_requant_handoff_matches_packed_tpu_kernel():
    """Kernel A's requant epilogue (plain version) vs vqa_tpu's
    ``_conv0_i8_packed`` in interpret mode, whose H-pair-packed output
    [B, H/4, W/2, 128] is unpacked with the inverse of ``_pack_h_pairs``."""
    x, w0, b0 = _conv0_case(seed=4, h=32, w=32)
    s_x0 = _scales(x, 3)
    s1 = tuple(float(v) for v in np.linspace(0.004, 0.02, 64))
    packed = np.asarray(j_stem._conv0_i8_packed(
        jnp.asarray(x), jnp.asarray(w0), jnp.asarray(b0), s_x0, s1, interpret=True))
    b, q, w2, c2 = packed.shape
    ref = packed.reshape(b, q, w2, 2, c2 // 2).transpose(0, 1, 3, 2, 4) \
        .reshape(b, 2 * q, w2, c2 // 2)
    s_c = torch.tensor(s_x0)
    x_q = quantize(torch.from_numpy(x), s_c)
    w_q, s_w = weight_quant(torch.from_numpy(w0) * s_c[None, None, :, None])
    out = t_stage1.conv0_i8(x_q, w_q, s_w, torch.from_numpy(b0), s1=torch.tensor(s1))
    assert out.dtype == torch.int8
    assert_int8_close(ref, out)


# ------------------------------------------------- pooled conv (kernel B, hpack)

@pytest.mark.parametrize("handoff", [False, True])
@pytest.mark.parametrize("mode", SCALE_MODES)
def test_hpack_int8_matches_jax(mode, handoff):
    x, w1, b1 = _conv1_case()
    s_x = _s_x(mode, x, 64)
    s_next = tuple(float(v) / 127.0 for v in np.linspace(0.5, 2.0, 128)) if handoff else None
    args = (jnp.asarray(x), jnp.asarray(w1), jnp.asarray(b1))
    ref = j_hpack._xla_reference_i8(*args, s_x=s_x, s_next=s_next)
    kern = j_hpack.conv_bn_relu_pool(*args, int8=True, s_x=s_x, s_next=s_next,
                                     force="pallas")
    out = t_hpack.conv_bn_relu_pool(torch.from_numpy(x), torch.from_numpy(w1),
                                    torch.from_numpy(b1), int8=True, s_x=s_x,
                                    s_next=s_next)
    assert tuple(out.shape) == (2, 8, 8, 128)
    if handoff:
        assert out.dtype == torch.int8
        assert_int8_close(ref, out)
        assert_int8_close(kern, out)
    else:
        assert out.dtype == torch.float32
        assert_float_parity(ref, kern, out, "float32", b1)


def _jax_int8_stage(x_q, w_q, scale, b, pool, s_next, out_dtype):
    """The int8-XLA stage of vqa_tpu/models/vgg.py:362-389 on given int8
    operands (the conv2-7 route kernel B replaces)."""
    acc = jax.lax.conv_general_dilated(
        jnp.asarray(x_q), jnp.asarray(w_q), (1, 1), [(1, 1), (1, 1)],
        dimension_numbers=("NHWC", "HWIO", "NHWC"), preferred_element_type=jnp.int32)
    y = acc.astype(jnp.float32) * jnp.asarray(scale) + jnp.asarray(b)
    if s_next is not None:
        q = jnp.clip(jnp.round(jax.nn.relu(y) / jnp.asarray(s_next)), -127, 127) \
            .astype(jnp.int8)
        if pool:
            q = jax.lax.reduce_window(q, jnp.array(-128, jnp.int8), jax.lax.max,
                                      (1, 2, 2, 1), (1, 2, 2, 1), "VALID")
        return q
    y = jax.nn.relu(y).astype(out_dtype)
    if pool:
        y = jax.lax.reduce_window(y, jnp.array(-jnp.inf, out_dtype), jax.lax.max,
                                  (1, 2, 2, 1), (1, 2, 2, 1), "VALID")
    return y


@pytest.mark.parametrize("out", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("pool", [False, True])
def test_int8_conv3x3_matches_jax_xla_stage(pool, out):
    rng = np.random.default_rng(7)
    x_q = rng.integers(-127, 128, (2, 10, 12, 128)).astype(np.int8)
    w_q = rng.integers(-127, 128, (3, 3, 128, 64)).astype(np.int8)
    scale = (rng.random(64) * 1e-5 + 1e-6).astype(np.float32)
    b = (rng.standard_normal(64) * 0.1).astype(np.float32)
    s_next = (rng.random(64) * 0.02 + 0.002).astype(np.float32) if out == "int8" else None
    jdt = JAX_DT.get(out, jnp.float32)
    ref = _jax_int8_stage(x_q, w_q, scale, b, pool, s_next, jdt)
    res = t_hpack.int8_conv3x3(
        torch.from_numpy(x_q), torch.from_numpy(w_q), torch.from_numpy(scale),
        torch.from_numpy(b), pool=pool,
        s_next=None if s_next is None else torch.from_numpy(s_next),
        out_dtype=TORCH_DT.get(out, torch.float32))
    assert tuple(res.shape) == ((2, 5, 6, 64) if pool else (2, 10, 12, 64))
    if out == "int8":
        assert_int8_close(ref, res)
    else:
        assert_within_ulp(ref, res, out, b)


# ------------------------------------------------------------------ fused stem

@pytest.mark.parametrize("handoff", [False, True])
def test_fused_stem_matches_jax(handoff):
    x, w0, b0 = _conv0_case(seed=5, h=32, w=32)
    _, w1, b1 = _conv1_case(seed=6)
    s_x0 = _scales(x, 3)
    y0 = np.asarray(j_stage1._xla_reference(jnp.asarray(x), jnp.asarray(w0),
                                            jnp.asarray(b0)))
    s_x1 = tuple(max(float(v), 1e-12) / 127.0 for v in y0.reshape(-1, 64).max(0))
    s_next = tuple(float(v) / 127.0 for v in np.linspace(0.5, 2.0, 128)) if handoff else None
    jargs = [jnp.asarray(a) for a in (x, w0, b0, w1, b1)]
    ref = j_stem._xla_reference(*jargs, s_x0, s_x1, jnp.float32, s_next=s_next)
    kern = j_stem.fused_stem(*jargs, s_x0=s_x0, s_x1=s_x1, s_next=s_next, force="pallas")
    out = t_stem.fused_stem(*[torch.from_numpy(a) for a in (x, w0, b0, w1, b1)],
                            s_x0=s_x0, s_x1=s_x1, s_next=s_next)
    assert tuple(out.shape) == (2, 8, 8, 128)
    if handoff:
        assert out.dtype == torch.int8
        assert_int8_close(ref, out)
        assert_int8_close(kern, out)
    else:
        # interpret mode multiplies by 1/s1 at the hand-off where the
        # fallback and the port divide: a moved tie there shifts a conv1
        # input by one step, in the kernel only
        assert_float_parity(ref, kern, out, "float32", b1)


def test_fused_stem_requires_static_scales():
    x, w0, b0 = _conv0_case()
    _, w1, b1 = _conv1_case()
    with pytest.raises(ValueError, match="static per-channel"):
        t_stem.fused_stem(*[torch.from_numpy(a) for a in (x, w0, b0, w1, b1)],
                          s_x0=_scales(x, 3), s_x1=0.1)


@pytest.mark.parametrize("shape", [(2, 16, 16, 3), (2, 18, 16, 3), (1, 64, 64, 3),
                                   (160, 448, 448, 3), (2, 20, 20, 3), (4, 24, 40, 3)])
def test_stem_supported_same_as_jax(shape):
    for w0s, w1s in (((3, 3, 3, 64), (3, 3, 64, 128)), ((3, 3, 3, 32), (3, 3, 32, 128))):
        assert t_stem.stem_supported(shape, w0s, w1s) == \
            j_stem.stem_supported(shape, w0s, w1s)
