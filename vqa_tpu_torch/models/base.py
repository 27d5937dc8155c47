"""What the three model families share.

Each model is a VGG tower followed by a trained head. The forward is split
in two so the profile script (and any caller) can run either half:
:meth:`VQANet.features` (the tower) and :meth:`VQANet.head` (the rest). The
frozen running-stats tower is :meth:`VQANet.frozen_features` (the VGG,
without autograd), the path of serving, evaluation and default training.
:meth:`VQANet.tower` is the tower with autograd, which ``features`` takes
when the VGG trains (``vgg_trainable``) or BatchNorm uses batch statistics
(``use_running_stats=False``); a frozen VGG runs it without autograd, the
counterpart of vqa_tpu's ``stop_gradient`` on the tower output
(baseline.py:67-70, coattention.py:98-100). The int8 fields of the VGG's
conv stack and the precision policy are exposed the same way for every
family.

The feature cache (``data.feature_cache``) splits the frozen tower once
more: :meth:`VQANet.cache_features` is its frozen, deterministic part (what
a build pass stores: the attention model's image encoder output, the conv
stack for baseline and bert), :meth:`VQANet.features_from_cache` the rest
(nothing, or the classifier head with its live dropouts), and
``forward(..., image_is_features=True)`` takes cached values in place of
pixels (vqa_tpu's ``image_is_features``).

Under tensor parallelism (``parallel.sharding``, ``tp_active``) the head
runs on ``DTensor`` s with plain tensors replicated, and ``forward``
returns the logits as a full local tensor.

``forward`` times its two halves on the host as the spans
``vqa.model.tower`` and ``vqa.model.head`` (``train.profiling.span``).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..parallel.sharding import head_context
from ..train.profiling import span
from .layers import autocast
from .vgg import VGGFeatures


class VQANet(nn.Module):
    """Base of the three models: ``dtype`` and the conv stack ``vgg``."""

    dtype: torch.dtype
    vgg_trainable: bool = False
    remat: bool = False          # recompute the conv stack in backward
    tp_active: bool = False      # the head is tensor-parallel (parallel.sharding)

    @property
    def vgg(self) -> VGGFeatures:
        raise NotImplementedError

    @property
    def int8_stages(self) -> tuple:
        return self.vgg.int8_stages

    @property
    def int8_amax(self) -> tuple:
        return self.vgg.int8_amax

    @int8_amax.setter
    def int8_amax(self, amax: tuple) -> None:
        self.vgg.int8_amax = tuple(amax)

    def _autocast(self, device: torch.device):
        return autocast(self.dtype, device.type)

    def frozen_features(self, x_img: torch.Tensor) -> torch.Tensor:
        """The frozen tower's output for a preprocessed image batch."""
        raise NotImplementedError

    def tower(self, x_img: torch.Tensor, batch_stats: bool) -> torch.Tensor:
        """The tower's output under autograd (``VGGFeatures.train_forward``)."""
        raise NotImplementedError

    def features(self, x_img: torch.Tensor, use_running_stats: bool = True) -> torch.Tensor:
        """The tower's output as a train or eval step takes it: the frozen
        tower, or :meth:`tower` when the VGG trains or BatchNorm uses batch
        statistics (with autograd only when the VGG trains)."""
        if use_running_stats and not self.vgg_trainable:
            return self.frozen_features(x_img)
        with torch.set_grad_enabled(self.vgg_trainable and torch.is_grad_enabled()):
            return self.tower(x_img, batch_stats=not use_running_stats)

    def cache_features(self, x_img: torch.Tensor) -> torch.Tensor:
        """The frozen tower's cacheable part for a preprocessed image batch,
        in the compute dtype, without autograd (the cache's boundary)."""
        raise NotImplementedError

    def features_from_cache(self, cached: torch.Tensor) -> torch.Tensor:
        """:meth:`frozen_features`' value from :meth:`cache_features`' value."""
        raise NotImplementedError

    def head(self, feats: torch.Tensor, x_ques: torch.Tensor,
             x_ques_lens: torch.Tensor) -> torch.Tensor:
        """Logits [B, K] from the tower's features and the question."""
        raise NotImplementedError

    def forward(self, x_img: torch.Tensor, x_ques: torch.Tensor,
                x_ques_lens: torch.Tensor, use_running_stats: bool = True,
                image_is_features: bool = False) -> torch.Tensor:
        """x_img [B, H, W, 3] normalized, ids [B, L], lengths [B] -> logits [B, K].
        ``use_running_stats=False``: batch-stats BatchNorm (training only).
        ``image_is_features``: ``x_img`` holds :meth:`cache_features`' values."""
        with span("vqa.model.tower"):
            feats = (self.features_from_cache(x_img) if image_is_features
                     else self.features(x_img, use_running_stats))
        with span("vqa.model.head"), head_context(self.tp_active):
            logits = self.head(feats, x_ques, x_ques_lens)
            return logits.full_tensor() if self.tp_active else logits
