"""VGG-11-bn conv stack, NHWC, running-stats mode (port of vqa_tpu/models/vgg.py).

The module is an ``nn.Sequential`` of torchvision's ``vgg11_bn().features``
layers, so its state-dict keys are the reference's (``0.weight``,
``1.running_mean``, ... ``25.weight``) and a reference ``.pth`` loads
unchanged. Its ``forward`` is the JAX package's ``VGGFeatures.__call__`` in
running-stats mode, with the same routing predicates, so both packages send a
config down the same branches:

- BN folds into the conv in fp32 (eps 1e-5); the image is cast to the
  compute dtype before any quantization;
- conv0 with ``conv0_pallas`` runs ``ops.conv_stage1.conv0_bn_relu_pool``
  (kernel A when int8), with the BN-folded weights cast to the compute dtype
  first, as vqa_tpu does;
- the fused int8 stem (``_take_fused_stem``: flags, static per-channel
  calibration, ``stem_supported``) runs ``ops.conv_stem.fused_stem``;
- a pooled int8 stage with C_in <= 64 runs ``ops.conv_hpack.conv_bn_relu_pool``;
- the other int8 stages run kernel B through ``ops.conv_hpack.int8_conv3x3``
  with the per-input-channel weight fold, static or dynamic scales, and the
  int8 hand-off. Where vqa_tpu pools the stage output afterwards (on int8 or
  on x.dtype), the port pools the int32 sums inside the kernel: the same
  values, since every epilogue step is non-decreasing;
- a calibration pass (``quant_stats`` given) records each int8 stage's
  running per-input-channel max|input| in f32 and turns the fused stem and
  the hand-offs off, as vqa_tpu's mutable ``quant_stats`` collection does.

- with ``s2d_first`` (and no fused conv0), conv0 + pool runs as one conv
  over the 2x2 space-to-depth input with the phase-rewritten kernel
  (:func:`_space_to_depth_kernel`), then bias, ReLU and the max over the four
  pool phases (vgg.py:281-287).

:meth:`VGGFeatures.train_forward` is the tower with autograd, for a
trainable VGG or batch-stats BatchNorm (``--vgg_train true``, ``--bn_mode
batch``; vgg.py:397-424): the conv in the compute dtype without a fused
bias, the bias added in the compute dtype, f32 mean and biased variance
over every axis but channels (and the pool phases under ``s2d_first``) and,
under data parallelism (``stats_group``), over every rank's rows,
``rsqrt(var + 1e-5)``, the affine, the cast back, then ReLU. No int8 stage
and no kernel runs there. In training mode the running stats take
``0.9 * running + 0.1 * batch`` with the same biased variance, in place in
the ``nn.BatchNorm2d`` buffers (``num_batches_tracked`` stays as loaded).
With ``remat`` the conv stack is recomputed in backward
(``torch.utils.checkpoint``); the checkpointed function returns the batch
statistics and the update is applied outside it, so the recomputation does
not apply it a second time (flax's ``nn.remat`` drops the recomputed
update). Without batch statistics it is the running-stats forward above,
with autograd (a trainable VGG under ``--bn_mode running``).

The baseline and bert models add the classifier head
(:class:`VGG11HeadEncoder`: adaptive average pool to 7x7, then torchvision's
``classifier[:-1]``, vgg.py:497-568).
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops.conv_hpack import conv_bn_relu_pool, int8_conv3x3
from ..ops.conv_stage1 import conv0_bn_relu_pool
from ..ops.conv_stem import fused_stem, stem_supported
from ..ops.quant import activation_quant, const, fold_scale, weight_quant
from .layers import Dropout, autocast

# torchvision configuration "A": channels per conv, 'M' = 2x2/2 max-pool
VGG11_CFG = (64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M")


def _maxpool2x2(x: torch.Tensor) -> torch.Tensor:
    """NHWC 2x2/2 max-pool, VALID (floors odd sizes), any dtype."""
    b, h, w, c = x.shape
    x = x[:, :h // 2 * 2, :w // 2 * 2]
    return x.reshape(b, h // 2, 2, w // 2, 2, c).amax(dim=(2, 4))


def _conv3x3(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """NHWC x HWIO -> NHWC 3x3 stride-1 SAME conv, no bias, in x's dtype. The
    NCHW views keep x's channels-last strides, which cuDNN takes as they are."""
    return F.conv2d(x.permute(0, 3, 1, 2), kernel.permute(3, 2, 0, 1),
                    padding=1).permute(0, 2, 3, 1)


def _space_to_depth_kernel(w: torch.Tensor) -> torch.Tensor:
    """A 3x3 kernel [3, 3, C, O] rewritten for a 2x2 space-to-depth input:
    [3, 3, 4C, 4O], output group P = 2p + q holding pool phase (p, q), the
    conv at position (2i + p, 2j + q) (vgg.py:71-91). Differentiable."""
    c, o = w.shape[2], w.shape[3]
    w4 = w.new_zeros((3, 3, 4, c, 4, o))
    for p in range(2):
        for q in range(2):
            for a in range(3):           # tap offsets -1..1 as 0..2
                for b in range(3):
                    ta, tb = p + a - 1, q + b - 1
                    r, s = ta % 2, tb % 2
                    w4[(ta - r) // 2 + 1, (tb - s) // 2 + 1, r * 2 + s, :, p * 2 + q] = w[a, b]
    return w4.reshape(3, 3, 4 * c, 4 * o)


def _space_to_depth_2x2(x: torch.Tensor) -> torch.Tensor:
    """NHWC [B, H, W, C] -> [B, H/2, W/2, 4C]; channel group (r * 2 + s) * C + c
    (vgg.py:94-99)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h // 2, w // 2, 4 * c)


def _s2d_conv(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """conv0 on the space-to-depth input: [B, H/2, W/2, 4, O] (phase axis 3)."""
    y = _conv3x3(_space_to_depth_2x2(x), _space_to_depth_kernel(kernel))
    b, h, w, _ = y.shape
    return y.reshape(b, h, w, 4, kernel.shape[3])


def _global_moments(yf: torch.Tensor, dims: tuple, group):
    """Mean and biased variance over ``dims`` of the batch that every rank of
    ``group`` holds a block of (SyncBatchNorm semantics): the sums and then
    the squared deviations all-reduced, with autograd through both, so the
    forward and the backward see the global statistics."""
    import warnings

    from torch.distributed.nn.functional import all_reduce
    warnings.filterwarnings("ignore", "torch.distributed.nn.functional.all_reduce is deprecated")

    n = yf.numel() // yf.shape[-1] * torch.distributed.get_world_size(group)
    mean = all_reduce(yf.sum(dims), group=group) / n
    d = yf - mean
    var = all_reduce((d * d).sum(dims), group=group) / n
    return mean, var


class VGGFeatures(nn.Sequential):
    """The conv stack (torch ``vgg11_bn().features``): 5 pool stages.

    448x448 -> [B, 14, 14, 512]. Fields as in vqa_tpu's ``VGGFeatures``;
    ``int8_amax`` may be replaced after calibration.
    """

    def __init__(self, *, dtype: torch.dtype = torch.float32,
                 s2d_first: bool = False, conv0_pallas: bool = False,
                 int8_stages: tuple = (), int8_amax: tuple = (),
                 hpack_pool: bool = False, fused_stem: bool = False,
                 int8_handoff: bool = False,
                 generator: torch.Generator | None = None):
        layers, in_c = [], 3
        for v in VGG11_CFG:
            if v == "M":
                layers.append(nn.MaxPool2d(2, 2))
            else:
                conv = nn.Conv2d(in_c, v, 3, padding=1)
                with torch.no_grad():
                    # kaiming_normal(fan_out, relu), bias 0 (torchvision init)
                    conv.weight.normal_(0.0, math.sqrt(2.0 / (9 * v)),
                                        generator=generator)
                    conv.bias.zero_()
                layers += [conv, nn.BatchNorm2d(v), nn.ReLU(inplace=True)]
                in_c = v
        super().__init__(*layers)
        self.dtype = dtype
        self.s2d_first = s2d_first
        self.conv0_pallas = conv0_pallas
        self.int8_stages = tuple(int8_stages)
        self.int8_amax = tuple(int8_amax)
        self.hpack_pool = hpack_pool
        self.fused_stem = fused_stem
        self.int8_handoff = int8_handoff
        self.stats_group = None    # data-parallel group of the batch statistics
        self._conv_bn = [(m, self[i + 1]) for i, m in enumerate(self)
                         if isinstance(m, nn.Conv2d)]

    @property
    def int8_amax(self) -> tuple:
        return self._int8_amax

    @int8_amax.setter
    def int8_amax(self, amax) -> None:
        """Set the calibration table; its quant scales (max(amax, 1e-12) / 127
        per stage, a tuple per channel or a legacy per-tensor float) are
        derived once here, not on every forward."""
        self._int8_amax = tuple(amax)
        self._s_x = {
            s: (tuple(max(float(t), 1e-12) / 127.0 for t in a)
                if isinstance(a, (tuple, list)) else max(float(a), 1e-12) / 127.0)
            for s, a in zip(self.int8_stages, self._int8_amax)}

    def _amax(self, conv_idx: int):
        return self.int8_amax[self.int8_stages.index(conv_idx)]

    def _params(self, conv_idx: int):
        """(HWIO f32 kernel, BN fold factor, folded f32 bias)."""
        conv, bn = self._conv_bn[conv_idx]
        s = fold_scale(bn.weight, bn.running_var)
        kernel = conv.weight.float().permute(2, 3, 1, 0)
        b32 = (conv.bias.float() - bn.running_mean.float()) * s + bn.bias.float()
        return kernel, s, b32

    @torch.no_grad()
    def forward(self, x: torch.Tensor, quant_stats: dict | None = None):
        """x [B, H, W, 3] -> [B, H/32, W/32, 512] in the compute dtype.

        ``quant_stats``: a dict to record each int8 stage's per-input-channel
        amax into (the calibration pass); None for a normal forward.
        """
        return self._running_stats_forward(x, quant_stats)

    def train_forward(self, x: torch.Tensor, *, batch_stats: bool,
                      remat: bool = False) -> torch.Tensor:
        """The tower under autograd (when grad mode is on): batch-stats
        BatchNorm, with the running stats updated once in training mode, or
        the running-stats forward. ``remat``: recompute the stack in
        backward instead of keeping its activations."""
        fn = self._batch_stats_forward if batch_stats else self._running_stats_forward
        if remat and torch.is_grad_enabled():
            out = checkpoint(fn, x, use_reentrant=False)
        else:
            out = fn(x)
        if not batch_stats:
            return out
        y, stats = out
        if self.training:
            self._update_running_stats(stats)
        return y

    @torch.no_grad()
    def _update_running_stats(self, stats) -> None:
        """``running = 0.9 * running + 0.1 * batch`` in f32 (vgg.py:417-418)."""
        for (_, bn), (mean, var) in zip(self._conv_bn, stats):
            bn.running_mean.copy_(0.9 * bn.running_mean + 0.1 * mean)
            bn.running_var.copy_(0.9 * bn.running_var + 0.1 * var)

    def _batch_stats_forward(self, x: torch.Tensor):
        """Batch-stats mode (vgg.py:397-424): -> (features, [(mean, var)]
        per conv), the statistics f32 with the biased variance. Pure: the
        caller applies the running update."""
        x = x.to(self.dtype)
        cfg = VGG11_CFG
        stats = []
        conv_idx = idx = 0
        while idx < len(cfg):
            v = cfg[idx]
            if v == "M":
                x = _maxpool2x2(x)
                idx += 1
                continue
            conv, bn = self._conv_bn[conv_idx]
            kernel = conv.weight.permute(2, 3, 1, 0).to(self.dtype)
            bias = conv.bias.to(self.dtype)
            pool_next = idx + 1 < len(cfg) and cfg[idx + 1] == "M"
            phase_max = (conv_idx == 0 and pool_next and self.s2d_first
                         and x.shape[1] % 2 == 0 and x.shape[2] % 2 == 0)
            if phase_max:
                y = _s2d_conv(x, kernel) + bias
                idx += 2
            else:
                y = _conv3x3(x, kernel) + bias
                idx += 1
            yf = y.float()
            dims = tuple(range(yf.dim() - 1))
            if self.stats_group is None:
                mean = yf.mean(dims)
                var = yf.var(dims, correction=0)
            else:
                mean, var = _global_moments(yf, dims, self.stats_group)
            stats.append((mean, var))
            yn = (yf - mean) * torch.rsqrt(var + 1e-5) * bn.weight + bn.bias
            x = torch.relu(yn.to(self.dtype))
            if phase_max:
                x = x.amax(dim=3)
            conv_idx += 1
        return x, stats

    def _running_stats_forward(self, x: torch.Tensor, quant_stats: dict | None = None):
        recording = quant_stats is not None
        x = x.to(self.dtype)
        cfg = VGG11_CFG
        conv_idx = idx = 0
        xq_in = None
        while idx < len(cfg):
            v = cfg[idx]
            if v == "M":
                x = _maxpool2x2(x)
                idx += 1
                continue
            if idx == 0 and self._take_fused_stem(x, recording):
                x = self._fused_stem(x, recording)
                if x.dtype == torch.int8:
                    xq_in = x
                idx += 4
                conv_idx += 2
                continue
            kernel, s, b32 = self._params(conv_idx)
            pool_next = idx + 1 < len(cfg) and cfg[idx + 1] == "M"
            first_stage_2x2 = (conv_idx == 0 and pool_next
                               and x.shape[1] % 2 == 0 and x.shape[2] % 2 == 0)
            int8 = conv_idx in self.int8_stages
            if int8 and recording:
                am = x.abs().amax(dim=(0, 1, 2)).float()
                prev = quant_stats.get(conv_idx)
                quant_stats[conv_idx] = am if prev is None else torch.maximum(prev, am)
            s_x_static = self._s_x.get(conv_idx) if int8 else None
            if first_stage_2x2 and self.conv0_pallas:
                x = conv0_bn_relu_pool(x, (kernel * s).to(self.dtype),
                                       b32.to(self.dtype), int8=int8,
                                       s_x=s_x_static)
                idx += 2
            elif first_stage_2x2 and self.s2d_first:
                y = _s2d_conv(x, (kernel * s).to(self.dtype)) + b32.to(self.dtype)
                x = torch.relu(y).amax(dim=3)
                idx += 2
            elif (int8 and self.hpack_pool and pool_next and x.shape[-1] <= 64
                  and x.shape[1] % 2 == 0 and x.shape[2] % 2 == 0):
                s_next = self._handoff_scales(conv_idx + 1, v, recording)
                x = conv_bn_relu_pool(x, kernel * s, b32, int8=True,
                                      s_x=s_x_static, s_next=s_next)
                if s_next is not None:
                    xq_in = x
                idx += 2
            elif int8:
                w32 = kernel * s
                if xq_in is not None:
                    # input already quantized (and pooled) by the previous
                    # stage's hand-off with THIS stage's scales
                    s_c = const(s_x_static, x.device)
                    x_q, xq_in, s_out = xq_in, None, None
                else:
                    x_q, s_c, s_out = activation_quant(x, s_x_static)
                if s_c is not None:
                    w32 = w32 * s_c[None, None, :, None]
                w_q, s_w = weight_quant(w32)
                scale = s_w if s_out is None else s_out * s_w
                s_next = self._handoff_scales(conv_idx + 1, v, recording) \
                    if isinstance(s_x_static, tuple) else None
                x = int8_conv3x3(
                    x_q, w_q, scale, b32, pool=pool_next,
                    s_next=None if s_next is None else const(s_next, x.device),
                    out_dtype=self.dtype)
                if s_next is not None:
                    xq_in = x
                idx += 2 if pool_next else 1
            else:
                y = F.conv2d(x.permute(0, 3, 1, 2),
                             (kernel * s).to(self.dtype).permute(3, 2, 0, 1),
                             b32.to(self.dtype), padding=1)
                x = torch.relu(y).permute(0, 2, 3, 1).contiguous()
                idx += 1
            conv_idx += 1
        return x

    def _handoff_scales(self, next_idx: int, out_ch: int, recording: bool):
        """Next stage's per-channel quant scales, or None if the int8
        hand-off cannot engage (vqa_tpu/models/vgg.py:427-441)."""
        if not (self.int8_handoff and next_idx in self.int8_stages
                and self.int8_amax) or recording:
            return None
        a = self._amax(next_idx)
        if not (isinstance(a, (tuple, list)) and len(a) == out_ch):
            return None
        return self._s_x[next_idx]

    def _take_fused_stem(self, x: torch.Tensor, recording: bool) -> bool:
        """vqa_tpu's static routing rule for the fused stem (vgg.py:443-465)."""
        if not (self.fused_stem and self.conv0_pallas and self.hpack_pool
                and 0 in self.int8_stages and 1 in self.int8_stages
                and self.int8_amax) or recording:
            return False
        a0, a1 = self._amax(0), self._amax(1)
        if not (isinstance(a0, (tuple, list))
                and isinstance(a1, (tuple, list)) and len(a1) == 64):
            return False
        return stem_supported(tuple(x.shape), (3, 3, x.shape[-1], 64),
                              (3, 3, 64, 128))

    def _fused_stem(self, x: torch.Tensor, recording: bool):
        k0, f0, b0 = self._params(0)
        k1, f1, b1 = self._params(1)
        return fused_stem(x, k0 * f0, b0, k1 * f1, b1, s_x0=self._s_x[0], s_x1=self._s_x[1],
                          s_next=self._handoff_scales(2, 128, recording))


def adaptive_avg_pool(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """torch ``AdaptiveAvgPool2d`` on NHWC input (vgg.py:49-68): window i
    spans [floor(i*H/out), ceil((i+1)*H/out)). The identity when the input
    already has the target size (7x7 at 224²)."""
    if tuple(x.shape[1:3]) == tuple(out_hw):
        return x
    return F.adaptive_avg_pool2d(x.permute(0, 3, 1, 2), out_hw).permute(0, 2, 3, 1)


class VGGClassifierHead(nn.Sequential):
    """The reference's ``fc_layers``: Sequential(Flatten, Linear(25088, 4096),
    ReLU, Dropout(0.5), Linear(4096, 4096), ReLU, Dropout(0.5)), torchvision's
    ``classifier[:-1]`` with its N(0, 0.01) init and zero bias. It takes the
    NCHW map, so it flattens in the reference's CHW order; vqa_tpu flattens
    NHWC and permutes fc0's input axis when it converts (convert.py:258-261).
    """

    def __init__(self, generator: torch.Generator | None = None):
        fc0, fc1 = nn.Linear(512 * 7 * 7, 4096), nn.Linear(4096, 4096)
        with torch.no_grad():
            for fc in (fc0, fc1):
                fc.weight.normal_(0.0, 0.01, generator=generator)
                fc.bias.zero_()
        super().__init__(nn.Flatten(), fc0, nn.ReLU(), Dropout(0.5), fc1, nn.ReLU(),
                         Dropout(0.5))


class VGG11HeadEncoder(nn.Module):
    """``VGG11Encoder(include_head=True)``: image -> 4096-d vector (the
    baseline and bert image tower). Keys as the reference's:
    ``conv_layers.{i}.*`` (the conv stack) and ``fc_layers.{1,4}.*``.

    ``forward`` is the frozen tower: it runs without autograd, but the
    head's two Dropouts follow the module's train/eval mode, as the reference
    keeps the frozen head in train mode and vqa_tpu stops the gradient after
    it (baseline.py:69-70). ``train_forward`` runs the conv stack's
    :meth:`VGGFeatures.train_forward` and the head under autograd (a
    trainable VGG trains both).
    """

    def __init__(self, *, dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None, **feature_kwargs):
        super().__init__()
        self.dtype = dtype
        self.conv_layers = VGGFeatures(dtype=dtype, generator=generator, **feature_kwargs)
        self.fc_layers = VGGClassifierHead(generator)

    @torch.no_grad()
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, H, W, 3] -> [B, 4096] (f32 under fp32, else autocast's dtype)."""
        return self._head(self.conv_layers(x))

    @torch.no_grad()
    def from_features(self, feats: torch.Tensor) -> torch.Tensor:
        """:meth:`forward` from the conv stack's output (a feature cache's
        rows, vgg.py:544-568 ``skip_features``): the head alone."""
        return self._head(feats.to(self.dtype))

    def train_forward(self, x: torch.Tensor, *, batch_stats: bool,
                      remat: bool = False) -> torch.Tensor:
        """The tower under autograd; ``remat`` covers the conv stack only,
        as vqa_tpu's (vgg.py:551-556)."""
        return self._head(self.conv_layers.train_forward(x, batch_stats=batch_stats,
                                                         remat=remat))

    def _head(self, feats: torch.Tensor) -> torch.Tensor:
        x = adaptive_avg_pool(feats, (7, 7))
        with autocast(self.dtype, x.device.type):
            return self.fc_layers(x.permute(0, 3, 1, 2))


def VGG11Encoder(include_head: bool = False, **kwargs) -> nn.Module:  # noqa: N802
    """vqa_tpu's ``VGG11Encoder``: the conv stack alone (the co-attention
    tower, whose keys are the stack's own ``{i}.*``) or, with
    ``include_head``, :class:`VGG11HeadEncoder`."""
    return VGG11HeadEncoder(**kwargs) if include_head else VGGFeatures(**kwargs)
