"""2-D ``("data", "model")`` mesh: tensor parallelism and FSDP (port of
vqa_tpu/parallel/sharding.py).

vqa_tpu gives each parameter a ``PartitionSpec`` and lets GSPMD insert the
collectives. Here the same rule table places each trainable parameter as a
``DTensor``:

- **TP** on ``model``: ``parallelize_module`` with ``ColwiseParallel`` /
  ``RowwiseParallel`` on the Megatron-paired ``nn.Linear`` and
  ``nn.Embedding`` layers, and :class:`RuleParallel` (the rule's placement
  for each parameter of any other module: convs, the LSTM, LayerNorm). The
  head's activations stay ``DTensor`` s (``use_local_output=False``) and
  DTensor's propagation inserts every reduction and redistribution; plain
  tensors inside the head (masks, initial states) are replicated
  (``implicit_replication``).
- **FSDP** on ``data``: ``fully_shard`` (FSDP2) on each trainable unit, each
  parameter sharded on the dim :func:`param_spec` names (the first free dim
  divisible by the axis, in vqa_tpu's layout order). A parameter with no
  such dim stays replicated over ``data`` (``ignored_params``), and its
  gradient is averaged by :func:`all_reduce_grads`, with the replicated
  VGG's when it trains.
- The frozen VGG is never a ``DTensor``: its kernels (the registered
  operators ``vqa_tpu_torch::*``) run on each rank's rows with replicated
  weights, as vqa_tpu's ``custom_partitioning`` wrappers declare.

Adam's moments follow their parameter's placement: the optimizer is built
after sharding. :func:`param_spec` returns a parameter's placement as a
tuple of axis names per dim of the port's (torch) layout, so a test can hold
it against vqa_tpu's table under the name mapping.

Exceptions to vqa_tpu's table (:data:`EXCEPTIONS`): DTensor has no sharding
rule for the cuDNN GRU (``nn.GRU``, the baseline's question tower), so its
weights stay replicated over ``model`` (still sharded over ``data``); and
where vqa_tpu's layout splits one of the port's dims in two (the bert
attention's heads and head dim), the port cannot shard both halves, so
``data`` takes the next free dim or none.
"""

from __future__ import annotations

import contextlib
import re

import torch
import torch.distributed as dist
import torch.nn as nn
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard, distribute_tensor
from torch.distributed.tensor.parallel import ColwiseParallel, RowwiseParallel
from torch.distributed.tensor.parallel.style import ParallelStyle

from .mesh import DATA_AXIS, MODEL_AXIS, axis_size, data_group

# (torch-name regex, dim of the port's layout that ``model`` shards) — first
# match wins; vqa_tpu's _TP_RULES (sharding.py:53-95) in the port's names
# (models/convert.py) and layouts ([out, in] weights, [out, in, k] convs)
TP_RULES: tuple[tuple[str, int | None], ...] = (
    (r"vgg11_encoder\.", None),
    # question tower: embedding + phrase convs shard the feature dim
    (r"question_encoder\.word_embedding\.(0\.)?weight$", 1),
    (r"phrase_conv_pool\.conv_\w+\.1\.weight$", 0),
    (r"phrase_conv_pool\.conv_\w+\.1\.bias$", 0),
    # LSTM: column-parallel gate blocks
    (r"sentence_lstm\.weight_[ih]h_l0$", 0),
    (r"sentence_lstm\.bias_[ih]h_l0$", 0),
    # co-attention: Megatron pair, W_* column-parallel, w_* row-parallel
    (r"co_attention\.W_[qv]\.weight$", 0),
    (r"co_attention\.W_[qv]\.bias$", 0),
    (r"co_attention\.w_[qv]\.weight$", 1),
    (r"co_attention\.w_[qv]\.bias$", None),
    # classifier: W_w/W_p column-parallel into the W_s column / W_h row pair
    (r"mlp_classify\.W_[wps]\.weight$", 0),
    (r"mlp_classify\.W_[wps]\.bias$", 0),
    (r"mlp_classify\.W_h\.weight$", 1),
    (r"mlp_classify\.W_h\.bias$", None),
    # baseline family: embedding_fc column-parallel -> mlp_fc / fc_final row
    (r"(image_encoder|question_encoder)\.embedding_(layer\.0|fc)\.weight$", 0),
    (r"(image_encoder|question_encoder)\.embedding_(layer\.0|fc)\.bias$", 0),
    (r"question_encoder\.gru\.weight_[ih]h_l0$", 0),
    (r"question_encoder\.gru\.bias_[ih]h_l0$", 0),
    (r"mlp\.0\.weight$", 1),
    (r"mlp\.0\.bias$", None),
    (r"fc_final\.weight$", 1),
    (r"fc_final\.bias$", None),
    # bert question tower: head-parallel attention, Megatron MLP pair
    (r"attention\.(query|key|value)\.weight$", 0),
    (r"attention\.(query|key|value)\.bias$", 0),
    (r"attention\.out\.weight$", 1),
    (r"attention\.out\.bias$", None),
    (r"mlp_in\.weight$", 0),
    (r"mlp_in\.bias$", 0),
    (r"mlp_out\.weight$", 1),
    (r"mlp_out\.bias$", None),
    (r"(token_embedding\.weight|position_embedding)$", 1),
)

# parameters whose placement differs from vqa_tpu's, and why
EXCEPTIONS: tuple[tuple[str, str], ...] = (
    (r"question_encoder\.gru\.", "nn.GRU (cuDNN) has no DTensor rule: replicated "
                                 "over model, sharded over data"),
    (r"attention\.(query|key|value)\.bias$|attention\.out\.weight$",
     "vqa_tpu's [H, hd] split of one port dim: model takes the heads, and data "
     "cannot take the head dim inside them"),
)

_NO_TP_MODULES = (nn.GRU,)


def _reference_order(name: str, ndim: int) -> list[int]:
    """The port's dims in the order of vqa_tpu's layout (its FSDP fill-in
    order): flax kernels are [in, out] ([k, in, out] for convs), the port's
    [out, in] ([out, in, k]); bert's attention kernels merge [D, H, hd] into
    [H*hd, D] and [H, hd, D] into [D, H*hd]."""
    if ndim == 1:
        return [0]
    if re.search(r"(embedding\.(0\.)?weight|position_embedding)$", name):
        return [0, 1]
    return list(range(ndim))[::-1]


def _tp_dim(name: str, shape, model_size: int) -> int | None:
    for pat, dim in TP_RULES:
        if re.search(pat, name):
            if dim is None or dim >= len(shape) or shape[dim] % model_size:
                return None
            return dim
    return None


def is_exception(name: str) -> str | None:
    for pat, why in EXCEPTIONS:
        if re.search(pat, name):
            return why
    return None


def param_spec(name: str, shape, mesh, tp: bool = True, fsdp: bool = True) -> tuple:
    """The placement of one parameter: an axis name (or None) per dim of the
    port's layout, trailing Nones dropped; vqa_tpu's ``param_spec``
    (sharding.py:115-141): TP rule first, then FSDP on the first free dim
    (in vqa_tpu's layout order) divisible by ``data`` and larger than 1.
    ``mesh``: a ``DeviceMesh`` or a ``{axis: size}`` dict."""
    sizes = mesh if isinstance(mesh, dict) else \
        {a: axis_size(mesh, a) for a in (DATA_AXIS, MODEL_AXIS)}
    shape = tuple(shape)
    if not shape:
        return ()
    dims: list[str | None] = [None] * len(shape)
    m = sizes.get(MODEL_AXIS, 1)
    if tp and m > 1 and not re.search(r"question_encoder\.gru\.", name):
        d = _tp_dim(name, shape, m)
        if d is not None:
            dims[d] = MODEL_AXIS
    n = sizes.get(DATA_AXIS, 1)
    if fsdp and n > 1 and "vgg11_encoder" not in name:
        for i in _reference_order(name, len(shape)):
            if dims[i] is None and shape[i] % n == 0 and shape[i] > 1:
                dims[i] = DATA_AXIS
                break
    while dims and dims[-1] is None:
        dims.pop()
    return tuple(dims)


def _is_tower(m: nn.Module) -> bool:
    from ..models.vgg import VGG11HeadEncoder, VGGFeatures
    return isinstance(m, (VGGFeatures, VGG11HeadEncoder))


def trainable_units(model: nn.Module) -> list[tuple[str, nn.Module]]:
    """The largest submodules outside the VGG tower: the FSDP units and the
    head that TP parallelizes."""
    units = []

    def walk(prefix: str, mod: nn.Module):
        for name, child in mod.named_children():
            fqn = f"{prefix}{name}"
            if _is_tower(child):
                continue
            if any(_is_tower(m) for m in child.modules()):
                walk(fqn + ".", child)
            elif any(True for _ in child.parameters()):
                units.append((fqn, child))

    walk("", model)
    return units


class RuleParallel(ParallelStyle):
    """A ``ParallelStyle`` for any module: each of its own parameters becomes
    a ``DTensor`` on the ``model`` mesh, sharded on the rule table's dim
    (replicated where the table has none); plain tensor inputs become
    replicated ``DTensor`` s and the outputs stay ``DTensor`` s."""

    def __init__(self, dims: dict):
        super().__init__()
        self.dims = dims

    def _apply(self, module, device_mesh):
        for pname, p in list(module.named_parameters(recurse=False)):
            d = self.dims.get(pname)
            module.register_parameter(pname, nn.Parameter(
                distribute_tensor(p.detach(), device_mesh,
                                  [Shard(d)] if d is not None else [Replicate()]),
                requires_grad=p.requires_grad))

        def hook(mod, args):
            return tuple(DTensor.from_local(a, device_mesh, [Replicate()], run_check=False)
                         if isinstance(a, torch.Tensor) and not isinstance(a, DTensor)
                         else a for a in args)
        module.register_forward_pre_hook(hook)
        return module


class LocalReplicated(ParallelStyle):
    """A ``ParallelStyle`` for a module DTensor cannot run sharded (the cuDNN
    GRU): ``DTensor`` inputs are gathered to full local tensors and its
    parameters stay plain."""

    def _apply(self, module, device_mesh):
        def hook(mod, args):
            return tuple(a.full_tensor() if isinstance(a, DTensor) else a for a in args)
        module.register_forward_pre_hook(hook)
        return module


class ColwiseConv(ParallelStyle):
    """A ``ParallelStyle`` for a column-parallel ``nn.Conv1d``, or a
    ``Sequential`` around one (the phrase convs: pad, conv, tanh). DTensor's
    own convolution rule shards the spatial dim, not the channels, so here
    the weight and bias are sharded on the output channels, the input is
    gathered to a full local tensor (its gradient summed over ``model`` in
    backward), the layers run locally on the local channels, and the output
    is a ``DTensor`` sharded on channels."""

    def _apply(self, module, device_mesh):
        layers = list(module) if isinstance(module, nn.Sequential) else [module]
        conv = next(m for m in layers if isinstance(m, nn.Conv1d))
        for pname, p in list(conv.named_parameters(recurse=False)):
            conv.register_parameter(pname, nn.Parameter(
                distribute_tensor(p.detach(), device_mesh, [Shard(0)]),
                requires_grad=p.requires_grad))

        def forward(x):
            if not isinstance(x, DTensor):
                x = DTensor.from_local(x, device_mesh, [Replicate()], run_check=False)
            x = x.redistribute(device_mesh, [Replicate()]).to_local(
                grad_placements=[Partial()])
            for layer in layers:
                x = (conv._conv_forward(x, conv.weight.to_local(), conv.bias.to_local())
                     if layer is conv else layer(x))
            return DTensor.from_local(x, device_mesh, [Shard(1)], run_check=False)

        module.forward = forward
        return module


def _tp_plan(model: nn.Module, units, model_size: int) -> dict:
    plan = {}
    for unit_name, unit in units:
        for sub, mod in unit.named_modules():
            fqn = f"{unit_name}.{sub}" if sub else unit_name
            own = dict(mod.named_parameters(recurse=False))
            if isinstance(mod, _NO_TP_MODULES):
                plan[fqn] = LocalReplicated()
                continue
            if isinstance(mod, nn.Sequential) and any(isinstance(m, nn.Conv1d) for m in mod):
                conv = next(i for i, m in enumerate(mod) if isinstance(m, nn.Conv1d))
                cdims = [_tp_dim(f"{fqn}.{conv}.{p}", t.shape, model_size)
                         for p, t in mod[conv].named_parameters()]
                if cdims == [0, 0]:             # the conv and its pad, locally
                    plan[fqn] = ColwiseConv()
                    continue
            if not own or any(fqn.startswith(k + ".") for k, v in plan.items()
                              if isinstance(v, ColwiseConv)):
                continue
            dims = {p: _tp_dim(f"{fqn}.{p}", t.shape, model_size) for p, t in own.items()}
            if isinstance(mod, nn.Conv1d) and dims.get("weight") == 0 \
                    and dims.get("bias") == 0:
                plan[fqn] = ColwiseConv()
            elif isinstance(mod, nn.Linear) and dims.get("weight") == 0 \
                    and dims.get("bias", 0) == 0:
                plan[fqn] = ColwiseParallel(use_local_output=False)
            elif isinstance(mod, nn.Linear) and dims.get("weight") == 1 \
                    and dims.get("bias") is None:
                plan[fqn] = RowwiseParallel(input_layouts=Replicate(), use_local_output=False)
            elif isinstance(mod, nn.Embedding) and set(own) == {"weight"} \
                    and dims["weight"] == 1:
                plan[fqn] = ColwiseParallel(use_local_output=False)
            else:
                plan[fqn] = RuleParallel(dims)
    return plan


def head_context(tp: bool):
    """The context the head runs in: under TP, plain tensors count as
    replicated ``DTensor`` s."""
    if not tp:
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication
    return implicit_replication()


def shard_model(model: nn.Module, mesh, *, tp: bool, fsdp: bool) -> list[nn.Parameter]:
    """Place ``model``'s trainable head on ``mesh``: TP over ``model`` (when
    ``tp``), FSDP2 over ``data`` (when ``fsdp``). Returns the parameters
    replicated over ``data`` that need :func:`all_reduce_grads` after
    backward (every trainable one outside FSDP: the VGG's when it trains,
    and the FSDP units' ``ignored_params``)."""
    units = trainable_units(model)
    names = mesh.mesh_dim_names
    model_mesh = mesh[MODEL_AXIS] if MODEL_AXIS in names else None
    data_mesh = mesh[DATA_AXIS] if len(names) > 1 else mesh
    m_size = axis_size(mesh, MODEL_AXIS)
    if tp:
        if model_mesh is None:
            raise ValueError("tensor parallelism needs the 2-D ('data', 'model') mesh")
        from torch.distributed.tensor.parallel import parallelize_module
        parallelize_module(model, model_mesh, _tp_plan(model, units, m_size))
        model.tp_active = True
    replicated = []
    if fsdp:
        from torch.distributed.fsdp import fully_shard

        sizes = {DATA_AXIS: axis_size(mesh, DATA_AXIS), MODEL_AXIS: m_size}
        for unit_name, unit in units:
            specs = {}
            for pname, p in unit.named_parameters():
                spec = param_spec(f"{unit_name}.{pname}", p.shape, sizes, tp=tp)
                specs[id(p)] = spec.index(DATA_AXIS) if DATA_AXIS in spec else None
            if sizes[DATA_AXIS] == 1:       # (1, m): shard everything on its first dim
                specs = {k: 0 for k in specs}
            ignored = {p for p in unit.parameters() if specs[id(p)] is None}
            gru = [mod for mod in unit.modules() if isinstance(mod, _NO_TP_MODULES)]
            for mod in gru:                 # its own unit: plain tensors when gathered
                fully_shard(mod, mesh=data_mesh, reshard_after_forward=True,
                            shard_placement_fn=lambda p: Shard(specs[id(p)]),
                            ignored_params=ignored & set(mod.parameters()))
            fully_shard(unit, mesh=data_mesh, reshard_after_forward=True,
                        shard_placement_fn=lambda p: Shard(specs[id(p)]),
                        ignored_params=ignored)
            replicated += [p for p in unit.parameters() if p in ignored and p.requires_grad]
    elif tp:        # TP alone: the whole head is replicated over data
        for _, unit in units:
            replicated += [p for p in unit.parameters() if p.requires_grad]
    replicated += [p for n, p in model.named_parameters()
                   if p.requires_grad and "vgg11_encoder" in n]
    return replicated


def all_reduce_grads(params, mesh) -> None:
    """Average the gradients of data-replicated parameters over ``data``, in
    one bucket (the local shards of ``DTensor`` gradients)."""
    if mesh is None or axis_size(mesh, DATA_AXIS) == 1:
        return
    grads = [p.grad.to_local() if isinstance(p.grad, DTensor) else p.grad
             for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1).float() for g in grads])
    dist.all_reduce(flat, group=data_group(mesh))
    flat /= axis_size(mesh, DATA_AXIS)
    offset = 0
    for g in grads:
        n = g.numel()
        g.copy_(flat[offset:offset + n].view_as(g))
        offset += n
