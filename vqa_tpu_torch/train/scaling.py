"""Dynamic loss scaling for fp16 experiments (port of vqa_tpu/train/scaling.py).

bf16, the port's mixed-precision policy, needs no scaling (fp32's exponent
range), so no entry point calls this, as in vqa_tpu; it is the building
block for the reference's Apex fp16 semantics (O2/O3 with a dynamic loss
scale, reference main.py:185,219-220). Multiply the loss by ``scale`` before
``backward``, divide the gradients by it after; if any gradient is
non-finite, skip the optimizer step and halve the scale; after
``growth_interval`` consecutive finite steps, double it.

The state is immutable, as vqa_tpu's pytree: each check returns the next
state. Gradients are a dict of tensors (``{name: p.grad}``)::

    scaler = DynamicLossScale.create()
    scaler.scale(loss).backward()
    grads, finite, scaler = scaler.unscale_and_check(grads)
    new_params = DynamicLossScale.select(finite, updated_params, params)
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import torch


@dataclass(frozen=True)
class DynamicLossScale:
    scale_value: torch.Tensor     # f32 0-d
    good_steps: torch.Tensor      # int32 0-d, consecutive finite steps
    growth_interval: int = 2000
    growth_factor: float = 2.0
    shrink_factor: float = 0.5
    min_scale: float = 1.0
    max_scale: float = 2.0 ** 24

    @classmethod
    def create(cls, init_scale: float = 2.0 ** 15, device=None, **kwargs):
        return cls(torch.tensor(init_scale, dtype=torch.float32, device=device),
                   torch.tensor(0, dtype=torch.int32, device=device), **kwargs)

    def scale(self, loss: torch.Tensor) -> torch.Tensor:
        return loss * self.scale_value.to(loss.dtype)

    def unscale_and_check(self, grads: dict):
        """(grads / scale, all finite as a 0-d bool tensor, next state)."""
        inv = 1.0 / self.scale_value
        grads = {k: (g.float() * inv).to(g.dtype) for k, g in grads.items()}
        finite = torch.ones((), dtype=torch.bool, device=self.scale_value.device)
        for g in grads.values():
            finite = finite & torch.isfinite(g).all()
        grown = self.good_steps + 1 >= self.growth_interval
        next_scale = torch.where(
            finite,
            torch.where(grown, torch.clamp(self.scale_value * self.growth_factor,
                                           max=self.max_scale), self.scale_value),
            torch.clamp(self.scale_value * self.shrink_factor, min=self.min_scale))
        next_good = torch.where(finite & ~grown, self.good_steps + 1,
                                torch.zeros_like(self.good_steps))
        return grads, finite, replace(self, scale_value=next_scale, good_steps=next_good)

    @staticmethod
    def select(finite: torch.Tensor, updated: dict, old: dict) -> dict:
        """Per entry ``where``: the update only when the gradients were finite."""
        return {k: torch.where(finite, updated[k], old[k]) for k in updated}
