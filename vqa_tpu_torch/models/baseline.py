"""Baseline VQA model (port of vqa_tpu/models/baseline.py): VGG-11 image
tower x GRU question tower -> MLP head.

Module and parameter names follow the reference state dict that
``vqa_tpu.models.convert.baseline_to_torch`` emits (convert.py:277-296), so
a reference ``.pth`` loads with ``load_state_dict(strict=True)``:

- image: the VGG with its classifier head (frozen) -> 4096, an fp32 L2
  normalize with a 1e-12 floor, FC-1024, tanh (``image_encoder.
  vgg11_encoder.{conv_layers,fc_layers}``, ``image_encoder.embedding_layer.0``);
- question: Embedding(300) (row 0 not masked), tanh, GRU(1024) last valid
  hidden, FC-1024, tanh (``question_encoder.{word_embedding.0,gru,
  embedding_layer.0}``);
- fusion: element-wise product, FC-1000, Dropout(0.5) *before* tanh, FC-K
  (``mlp.0``, ``fc_final``).

Dropout is live in train mode at three places: the VGG head's two (the head
is frozen, but the reference keeps it in train mode) and the fusion's. The
masks come from the generator that ``layers.set_dropout_generator`` gives the
model (the training state's). Precision as in the co-attention model: the
trained part runs under bf16 autocast at ``--opt_lvl >= 1``.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from .base import VQANet
from .layers import GRU, Dropout, Embedding, Linear
from .vgg import VGG11HeadEncoder, VGGFeatures


class ImageBaselineEncoder(nn.Module):
    """224x224 image -> 1024-d embedding (reference model.py:41-105)."""

    def __init__(self, *, dtype: torch.dtype = torch.float32, generator=None,
                 **vgg_kwargs):
        super().__init__()
        self.dtype = dtype
        self.vgg11_encoder = VGG11HeadEncoder(dtype=dtype, generator=generator, **vgg_kwargs)
        self.embedding_layer = nn.Sequential(Linear(4096, 1024, generator), nn.Tanh())
        self.vgg11_encoder.requires_grad_(False)

    def embed(self, feats: torch.Tensor) -> torch.Tensor:
        """The trained part: the 4096-d VGG output -> [B, 1024]."""
        x = feats.float()
        norm = torch.sqrt((x * x).sum(dim=-1, keepdim=True))
        x = (x / norm.clamp_min(1e-12)).to(self.dtype)
        return self.embedding_layer(x)


class QuestionBaselineEncoder(nn.Module):
    """Question ids -> 1024-d embedding via a GRU (reference model.py:108-151)."""

    def __init__(self, vocab_size: int, word_emb_dim: int = 300, hidden_dim: int = 1024,
                 generator=None):
        super().__init__()
        self.word_embedding = nn.Sequential(
            Embedding(vocab_size, word_emb_dim, generator, zero_pad_idx=False), nn.Tanh())
        self.gru = GRU(word_emb_dim, hidden_dim, generator)
        self.embedding_layer = nn.Sequential(Linear(hidden_dim, 1024, generator), nn.Tanh())

    def forward(self, x: torch.Tensor, x_lens: torch.Tensor) -> torch.Tensor:
        return self.embedding_layer(self.gru(self.word_embedding(x), x_lens))


class VQABaselineNet(VQANet):
    """logits = fc_final(tanh(dropout(mlp_fc(img_emb * ques_emb))))."""

    def __init__(self, vocab_size: int, K: int, *, word_emb_dim: int = 300,
                 hidden_dim: int = 1024, vgg_trainable: bool = False,
                 s2d_first: bool = False, conv0_pallas: bool = False,
                 int8_stages: tuple = (), int8_amax: tuple = (),
                 hpack_pool: bool = False, fused_stem: bool = False,
                 int8_handoff: bool = False, dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None, question_encoder=None):
        super().__init__()
        if vgg_trainable:
            raise NotImplementedError("a trainable VGG (batch-stats BatchNorm) is not "
                                      "ported yet (ROADMAP.md queue 1 item 2)")
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.dtype = dtype
        self.image_encoder = ImageBaselineEncoder(
            dtype=dtype, generator=generator, s2d_first=s2d_first,
            conv0_pallas=conv0_pallas, int8_stages=int8_stages, int8_amax=int8_amax,
            hpack_pool=hpack_pool, fused_stem=fused_stem, int8_handoff=int8_handoff)
        self.question_encoder = question_encoder if question_encoder is not None else \
            QuestionBaselineEncoder(vocab_size, word_emb_dim, hidden_dim, generator)
        self.mlp = nn.Sequential(Linear(1024, 1000, generator), Dropout(0.5), nn.Tanh())
        self.fc_final = Linear(1000, K, generator)

    @property
    def vgg(self) -> VGGFeatures:
        return self.image_encoder.vgg11_encoder.conv_layers

    def frozen_features(self, x_img: torch.Tensor) -> torch.Tensor:
        """The VGG with its classifier head: [B, 4096], no autograd."""
        return self.image_encoder.vgg11_encoder(x_img)

    def head(self, feats, x_ques, x_ques_lens):
        with self._autocast(feats.device):
            x = self.image_encoder.embed(feats) * self.question_encoder(x_ques, x_ques_lens)
            return self.fc_final(self.mlp(x))
