"""The sentence LSTM's fused call on the card (``models/layers.LSTM``).

This file imports no JAX. On a machine with a card, run

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_lstm.py -m cuda

Both tests take the benchmark's shape (B 160, L 23, E = H = 512), lengths
from 0 to 23, and hold the fused call and the masked loop to a float32 loop
on the same inputs (IEEE products: ``torch.backends.cuda.matmul.allow_tf32``
is off by default). Without a card they skip; the CPU test of the fused
call against the loop is in tests/test_torch_coattention.py.
"""

import pytest
import torch

from vqa_tpu_torch.models.layers import LSTM, autocast, lstm_calls

B, L, E, H = 160, 23, 512, 512


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (cuDNN's LSTM runs only on the card)")
    return torch.device("cuda")


def _setup(device):
    gen = torch.Generator().manual_seed(11)
    lstm = LSTM(E, H, gen).to(device)
    x = torch.randn(B, L, E, generator=gen).to(device)
    lengths = torch.randint(0, L + 1, (B,), generator=gen)
    lengths[:2] = torch.tensor([0, L])
    g = torch.randn(B, L, H, generator=gen).to(device)
    return lstm, x, lengths.to(device), g


def _run(lstm, fn, x, lengths, g, policy):
    """Outputs and the gradients of (input, four weights), all as float32."""
    x = x.detach().clone().requires_grad_()
    lstm.zero_grad()
    with autocast(policy, x.device.type):
        out = fn(x, lengths)
    (out.float() * g).sum().backward()
    return [out.detach().float(), x.grad.float(), *(w.grad.float() for w in lstm._weights())]


def _errors(got, ref):
    """Outputs: largest absolute difference; gradients: difference over norm."""
    return [float((got[0] - ref[0]).abs().max())] + [
        float((a - b).norm() / b.norm()) for a, b in zip(got[1:], ref[1:])]


@pytest.mark.cuda
def test_fused_bf16_policy_no_further_off_than_the_bf16_loop(cuda):
    """Under the bf16 policy the fused call is at least as close to a
    float32 loop as the loop under that policy is, in the outputs and in
    every gradient. That is the tolerance: the fused call may not compute
    in a lower precision than the loop it replaces. Outputs past each
    length are exactly 0, and the counters show the fused path."""
    lstm, x, lengths, g = _setup(cuda)
    xb = x.bfloat16()
    ref = _run(lstm, lstm._loop, xb.float(), lengths, g, torch.float32)
    loop = _run(lstm, lstm._loop, xb, lengths, g, torch.bfloat16)
    before = lstm_calls()
    fused = _run(lstm, lstm, xb, lengths, g, torch.bfloat16)
    after = lstm_calls()
    assert (after["fused"] - before["fused"], after["loop"] - before["loop"]) == (1, 0)
    fused_err, loop_err = _errors(fused, ref), _errors(loop, ref)
    assert all(f <= lp for f, lp in zip(fused_err, loop_err)), (fused_err, loop_err)
    past = torch.arange(L, device=cuda)[None, :] >= lengths[:, None]
    assert torch.all(fused[0][past] == 0)


@pytest.mark.cuda
def test_fused_fp32_policy_is_ieee_float32(cuda):
    """Under the fp32 policy the fused call keeps the loop's IEEE float32
    products (cuDNN, which would take TF32, is off for the call): outputs
    within 1e-5 and gradients within 1e-5 of their norm, where TF32
    products would be off by about 1e-3."""
    lstm, x, lengths, g = _setup(cuda)
    ref = _run(lstm, lstm._loop, x, lengths, g, torch.float32)
    fused = _run(lstm, lstm, x, lengths, g, torch.float32)
    err = _errors(fused, ref)
    assert all(e <= 1e-5 for e in err), err
