"""Hierarchical Co-Attention VQA model (port of vqa_tpu/models/coattention.py).

Module and parameter names follow the reference state dict that
``vqa_tpu.models.convert.coattention_to_torch`` emits, so a reference
``.pth`` (or :func:`vqa_tpu_torch.models.convert.from_jax`'s output) loads
with ``load_state_dict(strict=True)``. The three reference quirks that logit
parity depends on are kept (SURVEY.md M7/M8):

1. PhraseConvPool max-pools *adjacent channels of the n-gram concatenation*;
2. ``co_attention.W_b`` exists (zeros from the converter) and is never used;
3. the question softmax has no padding mask.

Precision: under the bf16 policy the question tower, co-attention and head
run under ``torch.autocast(bfloat16)``, with activations cast to bf16 where
the JAX package casts them; both softmaxes of the co-attention and the final
softmax run in fp32.

Training: the question tower, co-attention and head are trainable (fp32
parameters). The VGG is frozen unless ``vgg_trainable`` (``--vgg_train
true``, which also recomputes the conv stack in backward: ``remat``):
frozen, it runs without autograd (``models.base``) and its parameters have
``requires_grad=False``, the counterpart of vqa_tpu's ``stop_gradient`` on
the tower output (coattention.py:98-100) and its ``set_to_zero`` optimizer
label (train/state.py:48-55). Inference callers wrap the forward in
``torch.no_grad()``.

Sequence parallelism (``act_mesh``, ``--seq_parallel``): the head takes the
image features as a ``DTensor`` sharded on S over the mesh's ``model`` axis
(:func:`_seq_shard`), and the co-attention's affinity, softmax over S and
pooling run on the shards under tensor parallelism (``parallel.sharding``).
"""

from __future__ import annotations

import logging

import torch
import torch.nn as nn

from .base import VQANet
from .layers import LSTM, Embedding, Linear, uniform_
from .vgg import VGG11Encoder, VGGFeatures


def _seq_shard(x: torch.Tensor, mesh):
    """Sequence parallelism on [B, S, D] image features (vqa_tpu's
    ``_seq_shard``, coattention.py:39-64): with a ``("data", "model")`` mesh,
    the features become a ``DTensor`` sharded on S over ``model``. Every
    rank of a ``model`` group holds the same rows, so this is a local split;
    the affinity, the softmax over S and the pooling then run on the shards,
    with DTensor inserting the cross-shard reductions. A no-op without a
    model axis, and (with a warning) where S is not divisible."""
    if mesh is None:
        return x
    from ..parallel.mesh import MODEL_AXIS, axis_size
    mp = axis_size(mesh, MODEL_AXIS)
    if mp <= 1:
        return x
    if x.shape[1] % mp:
        logging.getLogger(__name__).warning(
            "seq_parallel: S=%d not divisible by model axis %d — replicating "
            "the sequence dim (sequence parallelism is OFF for this shape)",
            x.shape[1], mp)
        return x
    from torch.distributed.tensor import DTensor, Replicate, Shard
    model_mesh = mesh[MODEL_AXIS]
    return DTensor.from_local(x, model_mesh, [Replicate()], run_check=False).redistribute(
        model_mesh, [Shard(1)])


class ImageCoAttentionEncoder(nn.Module):
    """448x448 image -> [B, 196, 512] spatial features (s = h*14 + w)."""

    def __init__(self, *, generator=None, **vgg_kwargs):
        super().__init__()
        self.vgg11_encoder = VGG11Encoder(include_head=False, generator=generator,
                                          **vgg_kwargs)

    def forward(self, x_img: torch.Tensor, quant_stats: dict | None = None):
        x = self.vgg11_encoder(x_img, quant_stats)
        b, h, w, c = x.shape
        return x.reshape(b, h * w, c)


class _NGram(nn.Sequential):
    """Sequential(ConstantPad1d, Conv1d, Tanh): the reference layout, so the
    conv's keys are ``conv_{gram}.1.*``."""

    def __init__(self, emb_dim: int, k: int, pad: tuple, generator):
        conv = nn.Conv1d(emb_dim, emb_dim, k)
        uniform_(conv.weight, emb_dim * k, generator)
        uniform_(conv.bias, emb_dim * k, generator)
        super().__init__(nn.ConstantPad1d(pad, 0.0), conv, nn.Tanh())


class PhraseConvPool(nn.Module):
    """Uni/bi/tri-gram conv1d + tanh, then the quirky channel-group max-pool."""

    def __init__(self, emb_dim: int, generator=None):
        super().__init__()
        self.emb_dim = emb_dim
        self.conv_unigram = _NGram(emb_dim, 1, (0, 0), generator)
        self.conv_bigram = _NGram(emb_dim, 2, (1, 0), generator)
        self.conv_trigram = _NGram(emb_dim, 3, (1, 1), generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:            # [B, L, E]
        xc = x.transpose(1, 2)
        cat = torch.cat([self.conv_unigram(xc), self.conv_bigram(xc),
                         self.conv_trigram(xc)], dim=1)           # [B, 3E, L]
        b, _, l = cat.shape
        # quirk 1: regroup adjacent triples of the concatenated channels
        return cat.transpose(1, 2).reshape(b, l, self.emb_dim, 3).amax(dim=-1)


class QuestionCoAttentionEncoder(nn.Module):
    """Question ids -> (word, phrase, sentence) features, 3 x [B, L, H]."""

    def __init__(self, vocab_size: int, word_emb_dim: int = 512,
                 hidden_dim: int = 512, dtype=torch.float32, generator=None):
        super().__init__()
        self.dtype = dtype
        self.word_embedding = Embedding(vocab_size, word_emb_dim, generator)
        self.phrase_conv_pool = PhraseConvPool(word_emb_dim, generator)
        self.sentence_lstm = LSTM(word_emb_dim, hidden_dim, generator)

    def forward(self, x: torch.Tensor, x_lens: torch.Tensor):
        seq_len = x.shape[1]
        x_word = self.word_embedding(x).to(self.dtype)
        x_phrase = self.phrase_conv_pool(x_word)
        # pack/pad zeroing of phrase features beyond length
        valid = torch.arange(seq_len, device=x.device)[None, :] < x_lens[:, None]
        x_phrase = x_phrase * valid[..., None].to(x_phrase.dtype)
        x_sentence = self.sentence_lstm(x_phrase, x_lens)
        return x_word, x_phrase, x_sentence


class ParallelCoAttention(nn.Module):
    """Parallel co-attention over the 3 question levels (shared weights)."""

    def __init__(self, hidden_dim: int, generator=None):
        super().__init__()
        d = hidden_dim
        self.W_b = nn.Linear(d, d)          # quirk 2: created, never applied
        with torch.no_grad():
            self.W_b.weight.zero_()
            self.W_b.bias.zero_()
        self.W_v = Linear(d, d, generator)
        self.W_q = Linear(d, d, generator)
        self.w_v = Linear(d, 1, generator)
        self.w_q = Linear(d, 1, generator)

    def forward(self, V: torch.Tensor, x_ques_hierarchy):
        WvV = self.W_v(V)                                          # [B, S, D]
        img_feats, ques_feats = [], []
        for Q in x_ques_hierarchy:
            C = torch.tanh(torch.bmm(Q, V.transpose(1, 2)))         # [B, L, S]
            WqQ = self.W_q(Q)                                      # [B, L, D]
            H_v = torch.tanh(WvV + torch.bmm(C.transpose(1, 2), WqQ))
            H_q = torch.tanh(WqQ + torch.bmm(C, WvV))
            a_v = torch.softmax(self.w_v(H_v).float(), dim=1)     # [B, S, 1]
            a_q = torch.softmax(self.w_q(H_q).float(), dim=1)     # quirk 3
            img_feats.append((a_v.to(V.dtype) * V).sum(dim=1))
            ques_feats.append((a_q.to(Q.dtype) * Q).sum(dim=1))
        return img_feats, ques_feats


class MLPClassifier(nn.Module):
    """Recursive 3-level fusion head (reference model.py:400-434)."""

    def __init__(self, hidden_dim: int, mlp_dim: int = 1024, K: int = 1001,
                 generator=None):
        super().__init__()
        self.W_w = Linear(hidden_dim, hidden_dim, generator)
        self.W_p = Linear(2 * hidden_dim, hidden_dim, generator)
        self.W_s = Linear(2 * hidden_dim, mlp_dim, generator)
        self.W_h = Linear(mlp_dim, K, generator)

    def forward(self, x_img_feats, x_ques_feats):
        v_w, v_p, v_s = x_img_feats
        q_w, q_p, q_s = x_ques_feats
        h_w = torch.tanh(self.W_w(q_w + v_w))
        h_p = torch.tanh(self.W_p(torch.cat([q_p + v_p, h_w], dim=1)))
        h_s = torch.tanh(self.W_s(torch.cat([q_s + v_s, h_p], dim=1)))
        return self.W_h(h_s)


class HierarchicalCoAttentionNet(VQANet):
    """Top-level attention model: logits [B, K] (reference model.py:157-187)."""

    def __init__(self, vocab_size: int, K: int, *, word_emb_dim: int = 512,
                 hidden_dim: int = 512, mlp_dim: int = 1024,
                 vgg_trainable: bool = False, s2d_first: bool = False,
                 conv0_pallas: bool = False, int8_stages: tuple = (),
                 int8_amax: tuple = (), hpack_pool: bool = False,
                 fused_stem: bool = False, int8_handoff: bool = False,
                 remat: bool = False, dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.dtype = dtype
        self.vgg_trainable = vgg_trainable
        self.remat = remat
        self.act_mesh = None     # sequence-parallel mesh (see _seq_shard)
        self.question_encoder = QuestionCoAttentionEncoder(
            vocab_size, word_emb_dim, hidden_dim, dtype, generator)
        self.image_encoder = ImageCoAttentionEncoder(
            generator=generator, dtype=dtype, s2d_first=s2d_first,
            conv0_pallas=conv0_pallas, int8_stages=int8_stages,
            int8_amax=int8_amax, hpack_pool=hpack_pool, fused_stem=fused_stem,
            int8_handoff=int8_handoff)
        self.co_attention = ParallelCoAttention(hidden_dim, generator)
        self.mlp_classify = MLPClassifier(hidden_dim, mlp_dim, K, generator)
        self.image_encoder.requires_grad_(vgg_trainable)

    @property
    def vgg(self) -> VGGFeatures:
        return self.image_encoder.vgg11_encoder

    def frozen_features(self, x_img: torch.Tensor) -> torch.Tensor:
        """[B, 196, 512] spatial features; the VGG casts explicitly (its int8
        ops must not be autocast) and runs without autograd (frozen)."""
        return self.image_encoder(x_img)

    def cache_features(self, x_img: torch.Tensor) -> torch.Tensor:
        """The image encoder's [B, 196, 512]: all of the frozen tower."""
        return self.frozen_features(x_img)

    def features_from_cache(self, cached: torch.Tensor) -> torch.Tensor:
        return cached.to(self.dtype)

    def tower(self, x_img: torch.Tensor, batch_stats: bool) -> torch.Tensor:
        x = self.vgg.train_forward(x_img, batch_stats=batch_stats, remat=self.remat)
        b, h, w, c = x.shape
        return x.reshape(b, h * w, c)

    def head(self, feats, x_ques, x_ques_lens):
        feats = _seq_shard(feats, self.act_mesh)
        with self._autocast(feats.device):
            x_word, x_phrase, x_sentence = self.question_encoder(x_ques, x_ques_lens)
            img_attn, ques_attn = self.co_attention(
                feats, [x_word, x_phrase, x_sentence])
            return self.mlp_classify(img_attn, ques_attn)
