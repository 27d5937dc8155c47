"""The arithmetic of the reference's products: float32, or, for the control,
float8 (e4m3) operands.

``F32`` leaves every operand as it is; the caller turns TF32 off, so a
float32 product is a float32 product. ``FP8`` is the step below the
configurations' bfloat16 head: each operand of a product, its result, and
in the backward pass each incoming gradient, is rounded to float8 e4m3 with
one scale per tensor (its largest magnitude maps to 448), and the product
itself is taken in float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    s = torch.clamp_min(t.detach().abs().amax().float(), 1e-30) / E4M3_MAX
    return (t / s).to(torch.float8_e4m3fn).float() * s


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        return fp8_round(t)

    @staticmethod
    def backward(ctx, g):
        return fp8_round(g)


class Precision:
    """float32 products (``fp8=False``) or float8 e4m3 ones."""

    def __init__(self, fp8: bool = False):
        self.fp8 = fp8

    def r(self, t: torch.Tensor) -> torch.Tensor:
        return _Fp8.apply(t) if self.fp8 else t

    def matmul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.r(torch.matmul(self.r(a), self.r(b)))

    def linear(self, x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None) -> torch.Tensor:
        y = self.matmul(x, w.t())
        return y if b is None else y + b

    def conv1d(self, x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.r(F.conv1d(self.r(x), self.r(w))) + b[None, :, None]


F32 = Precision(False)
FP8 = Precision(True)
