"""Building blocks with the JAX package's numerics (vqa_tpu/models/layers.py).

- :class:`Embedding`: torch-default N(0, 1) init; ids equal to 0 look up
  exactly zero, as the flax module masks them (layers.py:77-97), whatever
  row 0 holds.
- :class:`Linear`: an ``nn.Linear`` with the torch-default
  U(+-1/sqrt(fan_in)) init drawn from an explicit generator.
- :class:`LSTM`: single-layer LSTM over a padded batch, gates (i, f, g, o),
  the carry frozen at t >= length and the output exactly 0 there — what
  ``pack_padded_sequence`` -> LSTM -> ``pad_packed_sequence`` gives
  (layers.py:151-200). The input projection is one matmul for all steps;
  the recurrence is a Python loop, as ``lax.scan`` is in JAX: no kernel.
  Parameter names are ``nn.LSTM``'s (``weight_ih_l0`` ...), so reference
  state dicts load unchanged.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F


def uniform_(t: torch.Tensor, fan_in: int, generator: torch.Generator | None):
    bound = 1.0 / math.sqrt(fan_in)
    with torch.no_grad():
        return t.uniform_(-bound, bound, generator=generator)


class Embedding(nn.Embedding):
    """Token embedding with padding index 0, masked at lookup."""

    def __init__(self, vocab_size: int, features: int,
                 generator: torch.Generator | None = None):
        super().__init__(vocab_size, features, padding_idx=0)
        with torch.no_grad():
            self.weight.normal_(0.0, 1.0, generator=generator)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        out = super().forward(ids)
        return out * (ids != 0).unsqueeze(-1).to(out.dtype)


class Linear(nn.Linear):
    """``nn.Linear`` with torch-default init from an explicit generator."""

    def __init__(self, in_features: int, out_features: int,
                 generator: torch.Generator | None = None):
        super().__init__(in_features, out_features)
        uniform_(self.weight, in_features, generator)
        uniform_(self.bias, in_features, generator)


class LSTM(nn.Module):
    """Masked single-layer LSTM: [B, L, E] + lengths [B] -> [B, L, H]."""

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

    def forward(self, x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
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
