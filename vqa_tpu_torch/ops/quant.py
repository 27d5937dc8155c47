"""int8 PTQ arithmetic shared by the conv ops (plain PyTorch, any device).

The JAX package repeats these few lines in every int8 op
(vqa_tpu/ops/conv_stage1.py:61-76, conv_hpack.py:203-218, models/vgg.py:
343-361); here they live once. Every step is an exactly rounded IEEE op, so
the same inputs give the same bits on the CPU and on the card:

- division is always tensor / tensor: PyTorch's CUDA true division by a CPU
  scalar multiplies by the reciprocal instead, which is not the JAX
  package's ``x / s``;
- rounding is ``torch.round`` (half to even, as ``jnp.round``);
- integer convolution sums are taken in float64, which holds every int32
  sum of this network exactly (|acc| <= 127^2 * 4608 < 2^53), with cuDNN
  off so no transform-based algorithm is chosen.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=64)
def _const(values: tuple, device: str) -> torch.Tensor:
    return torch.tensor(values, dtype=torch.float32, device=device)


def const(values, device) -> torch.Tensor:
    """A float32 tensor of Python floats (each rounded to f32, as
    ``jnp.asarray(tuple, float32)`` does), cached per device. While
    ``torch.export`` traces, the tensor is made afresh: one made there is a
    fake tensor, which the cache must not hand to a later eager call."""
    values = tuple(values) if isinstance(values, (tuple, list)) else values
    if torch.compiler.is_compiling():
        return _const.__wrapped__(values, str(device))
    return _const(values, str(device))


def div(a: torch.Tensor, s) -> torch.Tensor:
    """IEEE ``a / s`` with ``s`` made a tensor on ``a``'s device."""
    if not isinstance(s, torch.Tensor):
        s = const(float(s), a.device)
    return a / s.to(a.device)


def quantize(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """``clip(round(x / s), -127, 127)`` as int8 (``x`` read as float32)."""
    return torch.clamp(torch.round(div(x.float(), s)), -127, 127).to(torch.int8)


def activation_quant(x: torch.Tensor, s_x):
    """Quantize a stage input as the JAX package does.

    ``s_x``: tuple = static per-input-channel scales (they
    fold into the weights, ``s_out`` = 1); float = static per-tensor;
    None = dynamic per-batch ``max(max|x|, 1e-12) / 127``.
    Returns ``(x_q, s_c, s_out)``: ``s_c`` is the per-channel fold vector or
    None, ``s_out`` a 0-d tensor or None (== 1.0).
    """
    if isinstance(s_x, tuple):
        s_c = const(s_x, x.device)
        return quantize(x, s_c), s_c, None
    if s_x is None:
        s = div(torch.clamp_min(x.abs().amax().float(), 1e-12), 127.0)
    else:
        s = const(float(s_x), x.device)
    return quantize(x, s), None, s


def weight_quant(w32: torch.Tensor):
    """Per-output-channel symmetric int8 weights of an HWIO kernel.

    Returns ``(w_q int8 [3, 3, C, O], s_w float32 [O])``."""
    s_w = div(torch.clamp_min(w32.abs().amax(dim=(0, 1, 2)), 1e-12), 127.0)
    return quantize(w32, s_w), s_w


def int8_operands(x: torch.Tensor, w: torch.Tensor, s_x):
    """An int8 conv stage's operands as the JAX package quantizes them: x
    through :func:`activation_quant`, the f32 HWIO weights folded with the
    per-channel scales (if any) and quantized per output channel, and the
    epilogue's scale (``s_out * s_w``, or ``s_w`` with per-channel ``s_x``).

    Returns ``(x_q, w_q, scale)``."""
    x_q, s_c, s_out = activation_quant(x, s_x)
    w32 = w.float()
    if s_c is not None:
        w32 = w32 * s_c[None, None, :, None]
    w_q, s_w = weight_quant(w32)
    return x_q, w_q, s_w if s_out is None else s_out * s_w


def fold_scale(scale: torch.Tensor, var: torch.Tensor) -> torch.Tensor:
    """BatchNorm running-stats fold factor ``scale / sqrt(var + 1e-5)``.

    Written as ``scale * (1 / sqrt(var + eps))`` with every step exactly
    rounded, so it is the same on every device. Two CPU details: eps is an
    f32 tensor (a Python scalar is added in double), and the square root is
    taken in float64 and rounded once, since PyTorch's vectorized f32 sqrt on
    the CPU is off by an ulp for about 0.5% of inputs. The JAX package uses
    ``jax.lax.rsqrt``, which XLA on the CPU approximates: it differs from
    ``1 / sqrt`` by one f32 ulp for about a third of inputs (ROADMAP.md,
    faults).
    """
    v = var.float() + const(1e-5, var.device)
    root = torch.sqrt(v.double()).float()
    return scale.float() * (torch.ones_like(root) / root)


def int_conv3x3(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """Exact int8 conv3x3 (pad 1) sums: NHWC x HWIO -> NCHW float64."""
    with torch.backends.cudnn.flags(enabled=False):
        return F.conv2d(x_q.permute(0, 3, 1, 2).double(),
                        w_q.permute(3, 2, 0, 1).double(), padding=1)


def epilogue(acc: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
             out_dtype: torch.dtype, s_next: torch.Tensor | None) -> torch.Tensor:
    """The kernels' epilogue as separate eager ops on NCHW sums -> NHWC.

    ``relu(float(acc) * scale + bias)``, then ``out_dtype`` or, with
    ``s_next``, int8 ``clip(round(y / s_next), -127, 127)``. No op is fused,
    so there is no FMA: this is the contract the CUDA epilogues keep with
    ``__fmul_rn`` / ``__fadd_rn`` / ``__fdiv_rn`` / ``rintf``.
    """
    y = acc.float() * scale.float()[:, None, None]
    y = torch.relu(y + bias.float()[:, None, None])
    if s_next is not None:
        y = quantize(y, s_next.float()[:, None, None])
    else:
        y = y.to(out_dtype)
    return y.permute(0, 2, 3, 1).contiguous()
