"""What the three model families share.

Each model is a frozen VGG tower followed by a trained head. The forward is
split in two so the profile script (and any caller) can run either half:
:meth:`VQANet.frozen_features` (the VGG, without autograd) and
:meth:`VQANet.head` (everything that trains). The int8 fields of the VGG's
conv stack and the precision policy are exposed the same way for every
family.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from .layers import autocast
from .vgg import VGGFeatures


class VQANet(nn.Module):
    """Base of the three models: ``dtype`` and the conv stack ``vgg``."""

    dtype: torch.dtype

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

    def head(self, feats: torch.Tensor, x_ques: torch.Tensor,
             x_ques_lens: torch.Tensor) -> torch.Tensor:
        """Logits [B, K] from the frozen features and the question."""
        raise NotImplementedError

    def forward(self, x_img: torch.Tensor, x_ques: torch.Tensor,
                x_ques_lens: torch.Tensor) -> torch.Tensor:
        """x_img [B, H, W, 3] normalized, ids [B, L], lengths [B] -> logits [B, K]."""
        return self.head(self.frozen_features(x_img), x_ques, x_ques_lens)
