"""The port's three CUDA kernels as registered PyTorch operators.

Each public kernel wrapper (``conv_stage1.conv0_i8``, ``conv_hpack.
int8_conv3x3``, ``conv_stage1.conv0_f``) calls one operator of the namespace
``vqa_tpu_torch``, defined here when ``vqa_tpu_torch.ops`` is imported (no
CUDA work at import):

- ``vqa_tpu_torch::conv0_i8`` (kernel A), ``vqa_tpu_torch::int8_conv3x3``
  (kernel B), ``vqa_tpu_torch::conv0_f`` (kernel C), with the wrappers'
  arguments in their order (:data:`SCHEMAS`).

Each operator has three implementations, chosen by the dispatcher from the
device of its tensors:

- CUDA: the wrapper's checks, the weight packing and the ``launch_*``
  function, which launches the hand-written kernel (the launch count goes up
  in ``_build.CudaKernel.launch``, for real launches only);
- CPU: the kernel's plain PyTorch version. A CUDA tensor never reaches it;
- fake: the output's shape and dtype only, which is what ``torch.export``
  traces with. It builds and launches nothing.

So a program exported by ``torch.export`` holds these operators as nodes
and runs the kernels when it is loaded on the card, once this module is
imported (``vqa_tpu_torch.export`` writes its name into the manifest).

The operators are defined with ``torch.library.Library`` (``define`` /
``impl`` / ``register_fake``), not ``torch.library.custom_op``, which adds
Python layers of its own around the dispatcher: on an H100's host a
``custom_op`` call cost several times the dispatch of this route over a
direct call of the CUDA implementation (PERF.md, section 6). The operators have no backward (no autograd kernel is
registered): the kernels run only on the frozen VGG stages, under
``no_grad`` (``VGGFeatures.train_forward`` launches none).
"""

import torch

from . import conv_hpack, conv_stage1

NAMESPACE = "vqa_tpu_torch"


def _need_cuda(name: str, x: torch.Tensor) -> None:
    if not x.is_cuda:
        raise ValueError(f"{name}: the image is on {x.device} but another operand is on "
                         f"the card; put every operand on one device")


# -- kernel A ----------------------------------------------------------------

def _conv0_i8_cpu(x_q, w_q, scale, bias, out_dtype, s1):
    return conv_stage1.conv0_i8_plain(x_q, w_q, scale, bias, out_dtype=out_dtype, s1=s1)


def _conv0_i8_cuda(x_q, w_q, scale, bias, out_dtype, s1):
    _need_cuda("conv0_i8", x_q)
    b, h, w, c = x_q.shape
    if x_q.dtype != torch.int8 or c != 3 or w_q.shape != (3, 3, 3, 64):
        raise ValueError(f"conv0_i8: need int8 x [B,H,W,3] and w [3,3,3,64], "
                         f"got x{tuple(x_q.shape)} {x_q.dtype} w{tuple(w_q.shape)}")
    if h % 2 or w % 2:
        raise ValueError(f"conv0_i8: H and W must be even, got {h}x{w}")
    if s1 is None and out_dtype not in conv_stage1._MODES:
        raise ValueError(f"conv0_i8: out_dtype {out_dtype} not supported")
    return conv_stage1.launch_conv0_i8(
        x_q.contiguous(), conv_stage1.pack_conv0_i8_weights(w_q.to(x_q.device)),
        scale, bias, out_dtype=out_dtype, s1=s1)


def _conv0_i8_fake(x_q, w_q, scale, bias, out_dtype, s1):
    b, h, w, _ = x_q.shape
    return x_q.new_empty((b, h // 2, w // 2, 64),
                         dtype=torch.int8 if s1 is not None else out_dtype)


# -- kernel B ----------------------------------------------------------------

def _int8_conv3x3_cpu(x_q, w_q, scale, bias, pool, s_next, out_dtype):
    return conv_hpack.int8_conv3x3_plain(x_q, w_q, scale, bias, pool=pool, s_next=s_next,
                                         out_dtype=out_dtype)


def _int8_conv3x3_cuda(x_q, w_q, scale, bias, pool, s_next, out_dtype):
    _need_cuda("int8_conv3x3", x_q)
    b, h, w, c = x_q.shape
    o = w_q.shape[-1]
    if x_q.dtype != torch.int8 or tuple(w_q.shape) != (3, 3, c, o):
        raise ValueError(f"int8_conv3x3: need int8 x [B,H,W,C] and w [3,3,C,O], "
                         f"got x{tuple(x_q.shape)} {x_q.dtype} w{tuple(w_q.shape)}")
    if c % 32 or o % 64:
        raise ValueError(f"int8_conv3x3: the CUDA kernel needs C % 32 == 0 and "
                         f"O % 64 == 0, got C={c} O={o}")
    if s_next is None and out_dtype not in conv_hpack._MODES:
        raise ValueError(f"int8_conv3x3: out_dtype {out_dtype} not supported")
    return conv_hpack.launch_int8_conv3x3(
        x_q.contiguous(), conv_hpack.pack_conv3x3_weights(w_q.to(x_q.device)),
        scale, bias, pool=pool, s_next=s_next, out_dtype=out_dtype)


def _int8_conv3x3_fake(x_q, w_q, scale, bias, pool, s_next, out_dtype):
    b, h, w, _ = x_q.shape
    ho, wo = (h // 2, w // 2) if pool else (h, w)
    return x_q.new_empty((b, ho, wo, w_q.shape[-1]),
                         dtype=torch.int8 if s_next is not None else out_dtype)


# -- kernel C ----------------------------------------------------------------

def _conv0_f_cpu(x, w, b):
    return conv_stage1.conv0_f_plain(x, w, b)


def _conv0_f_cuda(x, w, b):
    _need_cuda("conv0_f", x)
    bsz, h, wd, c = x.shape
    if x.dtype not in conv_stage1._MODES or c != 3 or tuple(w.shape) != (3, 3, 3, 64):
        raise ValueError(f"conv0_f: need float32/bfloat16 x [B,H,W,3] and w [3,3,3,64], "
                         f"got x{tuple(x.shape)} {x.dtype} w{tuple(w.shape)}")
    if h % 2 or wd % 2:
        raise ValueError(f"conv0_f: H and W must be even, got {h}x{wd}")
    x = x.contiguous()
    w32, b32 = conv_stage1.conv0_f_operands(x, w, b)
    return conv_stage1.launch_conv0_f(x, conv_stage1.conv0_f_kernel_weights(x, w32), b32)


def _conv0_f_fake(x, w, b):
    bsz, h, wd, _ = x.shape
    return x.new_empty((bsz, h // 2, wd // 2, 64))


SCHEMAS = {
    "conv0_i8": "conv0_i8(Tensor x_q, Tensor w_q, Tensor scale, Tensor bias, "
                "ScalarType out_dtype, Tensor? s1) -> Tensor",
    "int8_conv3x3": "int8_conv3x3(Tensor x_q, Tensor w_q, Tensor scale, Tensor bias, "
                    "bool pool, Tensor? s_next, ScalarType out_dtype) -> Tensor",
    "conv0_f": "conv0_f(Tensor x, Tensor w, Tensor b) -> Tensor",
}
# the CUDA implementations, also for timing a launch without the operator's dispatch
CUDA_IMPLS = {"conv0_i8": _conv0_i8_cuda, "int8_conv3x3": _int8_conv3x3_cuda,
              "conv0_f": _conv0_f_cuda}
_CPU_IMPLS = {"conv0_i8": _conv0_i8_cpu, "int8_conv3x3": _int8_conv3x3_cpu,
              "conv0_f": _conv0_f_cpu}
_FAKES = {"conv0_i8": _conv0_i8_fake, "int8_conv3x3": _int8_conv3x3_fake,
          "conv0_f": _conv0_f_fake}

_LIBRARY = torch.library.Library(NAMESPACE, "DEF")
for _name, _schema in SCHEMAS.items():
    _LIBRARY.define(_schema)
    _LIBRARY.impl(_name, _CPU_IMPLS[_name], "CPU")
    _LIBRARY.impl(_name, CUDA_IMPLS[_name], "CUDA")
    torch.library.register_fake(f"{NAMESPACE}::{_name}", _FAKES[_name], lib=_LIBRARY)

# {name: the operator} (``torch.ops.vqa_tpu_torch.<name>.default``)
OPS = {name: getattr(getattr(torch.ops, NAMESPACE), name).default for name in SCHEMAS}
