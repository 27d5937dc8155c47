"""Building blocks with the JAX package's numerics (vqa_tpu/models/layers.py).

- :class:`Embedding`: torch-default N(0, 1) init; with ``zero_pad_idx``
  (the attention and bert models) ids equal to 0 look up exactly zero, as
  the flax module masks them (layers.py:77-97), whatever row 0 holds; the
  baseline's embedding does not mask.
- :class:`Linear`: an ``nn.Linear`` with the torch-default
  U(+-1/sqrt(fan_in)) init drawn from an explicit generator.
- :class:`LSTM`: single-layer LSTM over a padded batch, gates (i, f, g, o),
  the output exactly 0 at t >= length — what ``pack_padded_sequence`` ->
  LSTM -> ``pad_packed_sequence`` gives (layers.py:151-200). One call of
  the fused LSTM operator (cuDNN on the card) over the whole padded batch,
  its outputs masked; a Python loop over the steps, as ``lax.scan`` is in
  JAX, where the weights are tensor-parallel ``DTensor`` s. Parameter names
  are ``nn.LSTM``'s (``weight_ih_l0`` ...), so reference state dicts load
  unchanged.
- :class:`GRU`: ``nn.GRU`` (gates (r, z, n), separate ``b_ih``/``b_hh``)
  returning the last *valid* hidden state of each sequence
  (layers.py:100-148).
- :class:`Dropout`: ``nn.Dropout`` whose masks come from an explicit
  ``torch.Generator`` (:func:`set_dropout_generator`), so a checkpoint that
  saves the generator resumes with the same masks; under data parallelism
  each rank keeps its rows of the global batch's mask
  (:func:`set_dropout_rows`).
"""

from __future__ import annotations

import contextlib
import math
import warnings

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from ..train.profiling import span

# LSTM's four weights stay separate parameters (the TP rules, FSDP and
# ``Module.to`` treat each alone), so cuDNN packs them into its own buffer
# on every call: a few copies, 8 MB at width 512. Its warning about that
# describes this design, once a process, from this module's calls alone.
warnings.filterwarnings("ignore", message="RNN module weights are not part of single "
                        "contiguous chunk of memory", category=UserWarning, module=__name__)


def autocast(dtype: torch.dtype, device_type: str):
    """The precision policy's context: nothing under fp32, else autocast to
    ``dtype`` (the trained layers' bf16 compute at ``--opt_lvl >= 1``)."""
    if dtype == torch.float32:
        return contextlib.nullcontext()
    return torch.autocast(device_type, dtype=dtype)


def uniform_(t: torch.Tensor, fan_in: int, generator: torch.Generator | None):
    bound = 1.0 / math.sqrt(fan_in)
    with torch.no_grad():
        return t.uniform_(-bound, bound, generator=generator)


class Embedding(nn.Embedding):
    """Token embedding; with ``zero_pad_idx``, padding index 0 is masked at
    lookup (and gets no gradient)."""

    def __init__(self, vocab_size: int, features: int,
                 generator: torch.Generator | None = None, zero_pad_idx: bool = True):
        super().__init__(vocab_size, features, padding_idx=0 if zero_pad_idx else None)
        self.zero_pad_idx = zero_pad_idx
        with torch.no_grad():
            self.weight.normal_(0.0, 1.0, generator=generator)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        out = super().forward(ids)
        if not self.zero_pad_idx:
            return out
        return out * (ids != 0).unsqueeze(-1).to(out.dtype)


class Linear(nn.Linear):
    """``nn.Linear`` with torch-default init from an explicit generator."""

    def __init__(self, in_features: int, out_features: int,
                 generator: torch.Generator | None = None):
        super().__init__(in_features, out_features)
        uniform_(self.weight, in_features, generator)
        uniform_(self.bias, in_features, generator)


class LSTM(nn.Module):
    """Masked single-layer LSTM: [B, L, E] + lengths [B] -> [B, L, H].

    On plain tensors the recurrence is one call of the fused LSTM operator
    (``torch._VF.lstm``, what ``nn.LSTM`` calls) over the whole padded batch
    from a zero state, its outputs then multiplied by ``t < length``. That
    equals the masked loop: a forward recurrence's output at t < length
    does not depend on later inputs, the loop's frozen carry changes only
    outputs at t >= length, which both zero, and no gradient enters there.
    The lengths stay on the device (``pack_padded_sequence`` would read them
    on the host: a synchronise a call).

    Precision: the call runs in float32 outside autocast, as :class:`GRU`
    does, and its output is cast back to the input's dtype. That is never
    below the loop's precision: under the bf16 policy the loop rounds its
    gates and state to bfloat16 at every step, where cuDNN keeps them in
    float32 and takes its products in TF32 with float32 sums
    (``torch.backends.cudnn.allow_tf32``, on by default: 10 mantissa bits
    to bfloat16's 7). A float32 input is the fp32 policy: there the call
    runs with cuDNN off, ATen's own LSTM, whose products are IEEE float32
    matmuls as the loop's are.

    Where a weight is a ``DTensor`` (the tensor-parallel head, whose weights
    ``parallel.sharding`` shards by gate block) the recurrence is the masked
    loop: DTensor has no sharding rule for the fused operator. The loop
    projects the inputs of all steps in one matmul and freezes the carry at
    t >= length.

    :attr:`fused_calls` and :attr:`loop_calls` count the calls of each path
    in the process; either runs inside the span ``vqa.model.lstm``.
    """

    fused_calls = 0
    loop_calls = 0

    def __init__(self, input_dim: int, hidden_dim: int,
                 generator: torch.Generator | None = None):
        super().__init__()
        h = hidden_dim
        self.hidden_dim = h
        self.weight_ih_l0 = nn.Parameter(torch.empty(4 * h, input_dim))
        self.weight_hh_l0 = nn.Parameter(torch.empty(4 * h, h))
        self.bias_ih_l0 = nn.Parameter(torch.empty(4 * h))
        self.bias_hh_l0 = nn.Parameter(torch.empty(4 * h))
        for p in self.parameters():
            uniform_(p, h, generator)

    def _weights(self) -> list[torch.Tensor]:
        return [self.weight_ih_l0, self.weight_hh_l0, self.bias_ih_l0, self.bias_hh_l0]

    def forward(self, x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        with span("vqa.model.lstm"):
            if any(isinstance(w, DTensor) for w in self._weights()):
                LSTM.loop_calls += 1
                return self._loop(x, lengths)
            LSTM.fused_calls += 1
            return self._fused(x, lengths)

    def _fused(self, x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        b, seq_len, _ = x.shape
        h0 = x.new_zeros((1, b, self.hidden_dim), dtype=torch.float32)
        ieee = (torch.backends.cudnn.flags(enabled=False) if x.dtype == torch.float32
                else contextlib.nullcontext())
        with torch.autocast(x.device.type, enabled=False), ieee:
            out, _, _ = torch._VF.lstm(x.float(), (h0, h0), self._weights(), True, 1, 0.0,
                                       torch.is_grad_enabled(), False, True)
        valid = (torch.arange(seq_len, device=x.device)[None, :]
                 < lengths.to(x.device)[:, None])                      # [B, L]
        return (out * valid[..., None].to(out.dtype)).to(x.dtype)

    def _loop(self, x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        b, seq_len, _ = x.shape
        h = self.hidden_dim
        x_proj = F.linear(x, self.weight_ih_l0, self.bias_ih_l0)      # [B, L, 4H]
        dt = x_proj.dtype
        h_prev = torch.zeros((b, h), dtype=dt, device=x.device)
        c_prev = torch.zeros((b, h), dtype=dt, device=x.device)
        valid = (torch.arange(seq_len, device=x.device)[None, :]
                 < lengths.to(x.device)[:, None]).to(dt)               # [B, L]
        outs = []
        for t in range(seq_len):
            gates = x_proj[:, t] + F.linear(h_prev, self.weight_hh_l0) \
                + self.bias_hh_l0.to(dt)
            g_i, g_f, g_g, g_o = gates.chunk(4, dim=-1)
            i, f = torch.sigmoid(g_i), torch.sigmoid(g_f)
            g, o = torch.tanh(g_g), torch.sigmoid(g_o)
            c_new = f * c_prev + i * g
            h_new = o * torch.tanh(c_new)
            v = valid[:, t:t + 1]
            h_prev = v * h_new + (1.0 - v) * h_prev
            c_prev = v * c_new + (1.0 - v) * c_prev
            outs.append(v * h_new)
        return torch.stack(outs, dim=1)


def lstm_calls() -> dict[str, int]:
    """{"fused": ..., "loop": ...}: :class:`LSTM` calls of each path so far
    in this process."""
    return {"fused": LSTM.fused_calls, "loop": LSTM.loop_calls}


class GRU(nn.GRU):
    """Single-layer GRU: [B, L, E] + lengths [B] -> last valid hidden [B, H].

    The whole padded sequence runs through ``nn.GRU`` (cuDNN on the card)
    and the output at step ``length - 1`` is taken: a forward recurrence's
    output there does not depend on the padding after it, so this is what
    ``pack_padded_sequence`` gives, without moving the lengths to the host.
    A length of 0 gives the zero initial state, as the masked scan does. It
    runs in fp32 outside autocast: vqa_tpu runs its scan in the compute
    dtype, which only bf16 policies change.
    """

    def __init__(self, input_dim: int, hidden_dim: int,
                 generator: torch.Generator | None = None):
        super().__init__(input_dim, hidden_dim, batch_first=True)
        for p in self.parameters():
            uniform_(p, hidden_dim, generator)

    def forward(self, x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        with torch.autocast(x.device.type, enabled=False):
            out, _ = super().forward(x.float())                       # [B, L, H]
        lengths = lengths.to(x.device)
        last = out[torch.arange(out.shape[0], device=x.device), (lengths - 1).clamp_min(0)]
        return last * (lengths > 0).unsqueeze(-1).to(last.dtype)


class Dropout(nn.Dropout):
    """``nn.Dropout`` drawing its masks from ``self.generator`` (None: the
    default generator). Keeps each value with probability 1 - p and scales
    the kept ones by 1 / (1 - p), as flax's ``nn.Dropout``.

    ``rows = (index, count)`` (data parallelism, :func:`set_dropout_rows`):
    the input is block ``index`` of ``count`` equal blocks of the global
    batch, so the mask is drawn for the global batch from the replicated
    generator and this block of it is kept: every rank uses its rows of the
    mask a single device would draw."""

    generator: torch.Generator | None = None
    rows: tuple[int, int] = (0, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        index, count = self.rows
        b = x.shape[0]
        keep = torch.empty((b * count, *x.shape[1:]), device=x.device).bernoulli_(
            1.0 - self.p, generator=self.generator)
        if count > 1:
            keep = keep[index * b:(index + 1) * b]
        return torch.where(keep.bool(), x / (1.0 - self.p), torch.zeros_like(x))


def set_dropout_generator(model: nn.Module, generator: torch.Generator | None) -> None:
    """Make every :class:`Dropout` of ``model`` draw from ``generator``."""
    for m in model.modules():
        if isinstance(m, Dropout):
            m.generator = generator


def set_dropout_rows(model: nn.Module, index: int, count: int) -> None:
    """Every :class:`Dropout` of ``model`` sees block ``index`` of ``count``
    of the global batch (``Dropout.rows``)."""
    for m in model.modules():
        if isinstance(m, Dropout):
            m.rows = (index, count)
