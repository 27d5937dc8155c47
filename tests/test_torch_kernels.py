"""The port's CUDA kernels against their plain PyTorch versions.

This file imports no JAX, so it also runs where only the port is installed.
On a machine with a card and nvcc, run the card tests with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py -m cuda

(``--noconftest``: the suite's conftest sets up JAX). There each kernel mode
must equal its plain version bit for bit, at odd shapes that exercise the
tile edges. Without a card those tests skip; the dispatch contract below
runs everywhere.
"""

import os

import numpy as np
import pytest
import torch

from vqa_tpu_torch import _build
from vqa_tpu_torch.ops import conv_hpack, conv_stage1

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


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["float32", "bfloat16", "int8"])
def test_kernel_a_bit_equal_to_plain_on_card(cuda, mode):
    g = torch.Generator().manual_seed(0)
    x = torch.randint(-127, 128, (2, 36, 70, 3), generator=g, dtype=torch.int8).to(cuda)
    w = torch.randint(-127, 128, (3, 3, 3, 64), generator=g, dtype=torch.int8).to(cuda)
    sc = (torch.rand(64, generator=g) * 1e-4 + 1e-5).to(cuda)
    b = (torch.randn(64, generator=g) * 0.1).to(cuda)
    kw = ({"s1": (torch.rand(64, generator=g) * 0.02 + 1e-3).to(cuda)} if mode == "int8"
          else {"out_dtype": TORCH_DT[mode]})
    _build.reset_counts()
    out = conv_stage1.conv0_i8(x, w, sc, b, **kw)
    assert _build.CONV0_S2D_I8.launches == 1
    assert torch.equal(out, conv_stage1.conv0_i8_plain(x, w, sc, b, **kw))
    assert _build.CONV0_S2D_I8.launches == 1 and _build.CONV0_S2D_I8.plain_on_cuda == 1


@pytest.mark.cuda
@pytest.mark.parametrize("pool", [False, True])
@pytest.mark.parametrize("mode", ["float32", "bfloat16", "int8"])
def test_kernel_b_bit_equal_to_plain_on_card(cuda, mode, pool):
    g = torch.Generator().manual_seed(1)
    x = torch.randint(-127, 128, (2, 13, 22, 96), generator=g, dtype=torch.int8).to(cuda)
    w = torch.randint(-127, 128, (3, 3, 96, 128), generator=g, dtype=torch.int8).to(cuda)
    sc = (torch.rand(128, generator=g) * 1e-5 + 1e-6).to(cuda)
    b = (torch.randn(128, generator=g) * 0.1).to(cuda)
    kw = ({"s_next": (torch.rand(128, generator=g) * 0.02 + 1e-3).to(cuda)}
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
def test_float_conv0_route_raises_on_card(cuda):
    x = torch.zeros((1, 8, 8, 3), device=cuda)
    with pytest.raises(NotImplementedError, match="not ported"):
        conv_stage1.conv0_bn_relu_pool(x, torch.zeros(3, 3, 3, 64), torch.zeros(64))
