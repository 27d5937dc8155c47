"""BERT-style question tower + VQA fusion net (port of vqa_tpu/models/bert.py).

The image tower, fusion and head are the baseline's (``models.baseline``);
the question tower is a transformer: learned token + position embeddings ->
LayerNorm -> N post-LN blocks (multi-head attention, GELU FFN) with a
padding mask from the lengths -> masked mean pooling -> FC-1024 + tanh.
Padded positions are masked out of both attention and pooling, so results
do not depend on what the padding holds.

flax's conventions, kept so the two packages agree:

- ``nn.gelu`` is the tanh approximation (``F.gelu(approximate="tanh")``);
- ``LayerNorm`` epsilon is 1e-6;
- attention scales the query by 1/sqrt(head_dim) before the dot and masks
  with the dtype's minimum; a row with no valid key attends uniformly;
- the pool divides by max(valid, 1);
- Dense kernels start lecun-normal (truncated at 2 sigma), biases at zero.

Attention is plain PyTorch ops: the JAX package computes it in XLA, so no
hand-written kernel is due. ``bert`` has no reference torch format; its
``.pth`` files hold vqa_tpu's flat flax-path dict (``models.convert``).
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from .baseline import VQABaselineNet
from .layers import Embedding, Linear

LN_EPS = 1e-6


def _dense(in_features: int, out_features: int, generator) -> nn.Linear:
    """flax ``nn.Dense``'s init: lecun_normal kernel, zero bias."""
    layer = nn.Linear(in_features, out_features)
    std = math.sqrt(1.0 / in_features) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(layer.weight, 0.0, std, -2 * std, 2 * std, generator=generator)
        layer.bias.zero_()
    return layer


class MultiHeadAttention(nn.Module):
    """flax ``MultiHeadDotProductAttention`` (self-attention, no dropout)."""

    def __init__(self, hidden_dim: int, num_heads: int, generator=None):
        super().__init__()
        self.num_heads = num_heads
        self.query = _dense(hidden_dim, hidden_dim, generator)
        self.key = _dense(hidden_dim, hidden_dim, generator)
        self.value = _dense(hidden_dim, hidden_dim, generator)
        self.out = _dense(hidden_dim, hidden_dim, generator)

    def forward(self, x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        """x [B, L, D], valid [B, L] (keys that may be attended) -> [B, L, D]."""
        b, seq, d = x.shape
        hd = d // self.num_heads

        def heads(t):
            return t.view(b, seq, self.num_heads, hd).transpose(1, 2)     # [B, H, L, hd]

        q = heads(self.query(x))
        q = q / math.sqrt(hd)
        logits = q @ heads(self.key(x)).transpose(-1, -2)                # [B, H, L, L]
        logits = logits.masked_fill(~valid[:, None, None, :], torch.finfo(logits.dtype).min)
        weights = torch.softmax(logits, dim=-1).to(q.dtype)
        o = (weights @ heads(self.value(x))).transpose(1, 2).reshape(b, seq, d)
        return self.out(o)


class TransformerBlock(nn.Module):
    """Post-LN block: x = LN(x + MHA(x)); x = LN(x + FFN(x))."""

    def __init__(self, hidden_dim: int, num_heads: int, mlp_ratio: int = 4, generator=None):
        super().__init__()
        self.attention = MultiHeadAttention(hidden_dim, num_heads, generator)
        self.ln_attn = nn.LayerNorm(hidden_dim, eps=LN_EPS)
        self.mlp_in = _dense(hidden_dim, hidden_dim * mlp_ratio, generator)
        self.mlp_out = _dense(hidden_dim * mlp_ratio, hidden_dim, generator)
        self.ln_mlp = nn.LayerNorm(hidden_dim, eps=LN_EPS)

    def forward(self, x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        x = self.ln_attn(x + self.attention(x, valid))
        h = self.mlp_out(F.gelu(self.mlp_in(x), approximate="tanh"))
        return self.ln_mlp(x + h)


class BertQuestionEncoder(nn.Module):
    """Question ids [B, L] + lengths [B] -> 1024-d embedding."""

    def __init__(self, vocab_size: int, hidden_dim: int = 768, num_layers: int = 6,
                 num_heads: int = 12, max_len: int = 64, generator=None):
        super().__init__()
        if hidden_dim % num_heads:
            raise ValueError(f"hidden dim {hidden_dim} not divisible by num_heads={num_heads}")
        self.max_len = max_len
        self.token_embedding = Embedding(vocab_size, hidden_dim, generator, zero_pad_idx=True)
        self.position_embedding = nn.Parameter(torch.empty(max_len, hidden_dim))
        with torch.no_grad():
            self.position_embedding.normal_(0.0, 0.02, generator=generator)
        self.ln_emb = nn.LayerNorm(hidden_dim, eps=LN_EPS)
        self.blocks = nn.ModuleList(TransformerBlock(hidden_dim, num_heads, generator=generator)
                                    for _ in range(num_layers))
        self.embedding_fc = Linear(hidden_dim, 1024, generator)

    def forward(self, x: torch.Tensor, x_lens: torch.Tensor) -> torch.Tensor:
        seq = x.shape[1]
        if seq > self.max_len:
            raise ValueError(f"question length {seq} exceeds the position table "
                             f"(max_len={self.max_len}); build the model with a larger "
                             f"max_len (e.g. the vocab's max_seq_length)")
        h = self.ln_emb(self.token_embedding(x) + self.position_embedding[:seq][None])
        valid = torch.arange(seq, device=x.device)[None, :] < x_lens.to(x.device)[:, None]
        for block in self.blocks:
            h = block(h, valid)
        vmask = valid[..., None].to(h.dtype)
        pooled = (h * vmask).sum(dim=1) / vmask.sum(dim=1).clamp_min(1)
        return torch.tanh(self.embedding_fc(pooled))


class VQABertNet(VQABaselineNet):
    """The baseline's image tower and fusion head over the BERT question tower."""

    def __init__(self, vocab_size: int, K: int, *, hidden_dim: int = 768,
                 num_layers: int = 6, num_heads: int = 12, max_len: int = 64,
                 generator: torch.Generator | None = None, **kwargs):
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        question_encoder = BertQuestionEncoder(vocab_size, hidden_dim, num_layers, num_heads,
                                               max_len, generator)
        super().__init__(vocab_size, K, generator=generator,
                         question_encoder=question_encoder, **kwargs)


def bert_from_hf_state_dict(sd: dict, num_layers: int, vocab_map=None,
                            num_heads: int = 12) -> dict:
    """HuggingFace ``bert-base-uncased`` weights (``{name: array}``, torch
    layouts) -> a state dict for :class:`BertQuestionEncoder`, as
    vqa_tpu's ``bert_from_hf_state_dict`` (bert.py:140) grafts them.

    ``vocab_map``: optional [our vocab size] -> HF id array that re-indexes
    the token table. ``num_heads`` is checked against the hidden size (HF
    stores the heads fused). ``embedding_fc`` is not in the result: load with
    ``strict=False`` and it keeps its init.
    """
    def t(name):
        return torch.as_tensor(sd[name]).float().clone()

    out: dict = {}
    tok = torch.as_tensor(sd["bert.embeddings.word_embeddings.weight"]).float()
    out["token_embedding.weight"] = (tok[torch.as_tensor(vocab_map).long()]
                                     if vocab_map is not None else tok.clone())
    out["position_embedding"] = t("bert.embeddings.position_embeddings.weight")
    out["ln_emb.weight"] = t("bert.embeddings.LayerNorm.weight")
    out["ln_emb.bias"] = t("bert.embeddings.LayerNorm.bias")
    pairs = {"attention.query": "attention.self.query", "attention.key": "attention.self.key",
             "attention.value": "attention.self.value",
             "attention.out": "attention.output.dense",
             "ln_attn": "attention.output.LayerNorm", "mlp_in": "intermediate.dense",
             "mlp_out": "output.dense", "ln_mlp": "output.LayerNorm"}
    for i in range(num_layers):
        hf = f"bert.encoder.layer.{i}"
        hidden = sd[f"{hf}.attention.self.query.weight"].shape[0]
        if hidden % num_heads:
            raise ValueError(f"hidden dim {hidden} not divisible by num_heads={num_heads}")
        for ours, theirs in pairs.items():
            for p in ("weight", "bias"):
                out[f"blocks.{i}.{ours}.{p}"] = t(f"{hf}.{theirs}.{p}")
    return out
