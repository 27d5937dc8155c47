"""The port's six CUDA kernels as registered PyTorch operators.

Each public kernel wrapper (``conv_stage1.conv0_i8``, ``conv_hpack.
int8_conv3x3``, ``conv_stage1.conv0_f``, ``conv_hpack.conv3x3_f``,
``coattention_kernel.coattention_fwd``, ``mma_rate.mma_rate``) calls one
operator of the namespace ``vqa_tpu_torch``, defined here when
``vqa_tpu_torch.ops`` is imported (no CUDA work at import):

- ``vqa_tpu_torch::conv0_i8`` (kernel A), ``vqa_tpu_torch::int8_conv3x3``
  (kernel B), ``vqa_tpu_torch::conv0_f`` (kernel C),
  ``vqa_tpu_torch::conv3x3_f`` (kernel D), ``vqa_tpu_torch::coattention_fwd``
  (kernel E), ``vqa_tpu_torch::mma_rate`` (kernel F, the timing probe of the
  tensor cores), with the wrappers' arguments in their order
  (:data:`SCHEMAS`).

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
registered): kernels A-C run only on the frozen VGG stages, under
``no_grad`` (``VGGFeatures.train_forward`` launches none), D has no
training caller, F computes no model function, and E's gradient is ``coattention_kernel.coattention_fused``'s
``autograd.Function``, which recomputes through plain PyTorch.
"""

import torch

from . import coattention_kernel, conv_hpack, conv_stage1, mma_rate

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


# -- kernel D ----------------------------------------------------------------

def _conv3x3_f_cpu(x, w, b, pool=True):
    return conv_hpack.conv3x3_f_plain(x, w, b, pool)


def _conv3x3_f_cuda(x, w, b, pool=True):
    _need_cuda("conv3x3_f", x)
    bsz, h, wd, c = x.shape
    o = w.shape[-1]
    if x.dtype not in conv_hpack._MODES or tuple(w.shape) != (3, 3, c, o) or b.shape != (o,):
        raise ValueError(f"conv3x3_f: need float32/bfloat16 x [B,H,W,C], w [3,3,C,O] and "
                         f"b [O], got x{tuple(x.shape)} {x.dtype} w{tuple(w.shape)} "
                         f"b{tuple(b.shape)}")
    if c % 8 or o % 8:
        raise ValueError(f"conv3x3_f: the CUDA kernel needs C % 8 == 0 and O % 8 == 0, "
                         f"got C={c} O={o}")
    x = x.contiguous()
    if x.data_ptr() % 16:
        x = x.clone()            # the launcher refuses an image that is not 16-byte aligned
    return conv_hpack.launch_conv3x3_f(x, *conv_hpack.conv3x3_f_operands(x, w, b), pool=pool)


def _conv3x3_f_fake(x, w, b, pool=True):
    bsz, h, wd, _ = x.shape
    ho, wo = (h // 2, wd // 2) if pool else (h, wd)
    return x.new_empty((bsz, ho, wo, w.shape[-1]))


# -- kernel E ----------------------------------------------------------------

def _coattention_fwd_cpu(x_img, q, W_v, b_v, W_q, b_q, w_v, w_q):
    return coattention_kernel.coattention_plain(x_img, q, W_v, b_v, W_q, b_q, w_v, w_q)


def _coattention_fwd_cuda(x_img, q, W_v, b_v, W_q, b_q, w_v, w_q):
    _need_cuda("coattention_fwd", x_img)
    b, s, d = x_img.shape
    if (x_img.dtype not in coattention_kernel._MODES or q.dim() != 4 or q.dtype != x_img.dtype
            or tuple(q.shape[::3]) != (b, d) or q.shape[1] != coattention_kernel.NUM_LEVELS
            or tuple(W_v.shape) != (d, d) or tuple(W_q.shape) != (d, d)
            or any(t.numel() != d for t in (b_v, b_q, w_v, w_q))):
        raise ValueError(f"coattention_fwd: need float32/bfloat16 x_img [B,S,D], q [B,3,L,D] "
                         f"of its dtype, W_v/W_q [D,D] and b_v, b_q, w_v, w_q of D values, got "
                         f"x_img{tuple(x_img.shape)} {x_img.dtype} q{tuple(q.shape)} {q.dtype} "
                         f"W_v{tuple(W_v.shape)} W_q{tuple(W_q.shape)}")
    if d % 32 or s == 0 or q.shape[2] == 0:
        raise ValueError(f"coattention_fwd: the CUDA kernel needs D % 32 == 0 and S, L > 0, "
                         f"got S={s} L={q.shape[2]} D={d}")
    x_img, q = x_img.contiguous(), q.to(x_img.device).contiguous()
    x_img, q = (t.clone() if t.data_ptr() % 16 else t for t in (x_img, q))
    return coattention_kernel.launch_coattention_fwd(
        x_img, q, *coattention_kernel.coattention_kernel_operands(x_img, W_v, b_v, W_q, b_q,
                                                                  w_v, w_q))


def _coattention_fwd_fake(x_img, q, W_v, b_v, W_q, b_q, w_v, w_q):
    b, _, d = x_img.shape
    return (x_img.new_empty((b, coattention_kernel.NUM_LEVELS, d)),
            x_img.new_empty((b, coattention_kernel.NUM_LEVELS, d)))


# -- kernel F ----------------------------------------------------------------

def _mma_rate_cpu(x, w):
    return mma_rate.mma_rate_plain(x, w)


def _mma_rate_cuda(x, w):
    _need_cuda("mma_rate", x)
    if (x.dim() != 4 or w.dim() != 3 or x.dtype not in mma_rate._MODES or w.dtype != x.dtype
            or w.shape[1] != x.shape[3] or w.shape[2] != mma_rate.N):
        raise ValueError(f"mma_rate: need x [G,R,W,K] and w [ndots,K,{mma_rate.N}] of one type, "
                         f"int8 or bfloat16, got x{tuple(x.shape)} {x.dtype} "
                         f"w{tuple(w.shape)} {w.dtype}")
    cluster = mma_rate.CLUSTER[x.dtype]
    if not mma_rate.k_chunk(x.shape[3] * x.element_size(), cluster) \
            or (x.shape[1] * x.shape[2]) % mma_rate.UNIT_ROWS:
        raise ValueError(f"mma_rate: the CUDA kernel splits K across {cluster} blocks, so K "
                         f"must be a multiple of {mma_rate.SHARE_ALIGN * cluster} bytes, and "
                         f"R W a multiple of {mma_rate.UNIT_ROWS}, got x{tuple(x.shape)}")
    x = x.contiguous()
    if x.data_ptr() % 16:
        x = x.clone()            # the launcher refuses operands that are not 16-byte aligned
    return mma_rate.launch_mma_rate(x, mma_rate.pack_mma_rate_weights(w.to(x.device)),
                                    w.shape[0])


def _mma_rate_fake(x, w):
    return x.new_empty((x.shape[0], x.shape[2], w.shape[2]), dtype=mma_rate._MODES[x.dtype][0])


SCHEMAS = {
    "conv0_i8": "conv0_i8(Tensor x_q, Tensor w_q, Tensor scale, Tensor bias, "
                "ScalarType out_dtype, Tensor? s1) -> Tensor",
    "int8_conv3x3": "int8_conv3x3(Tensor x_q, Tensor w_q, Tensor scale, Tensor bias, "
                    "bool pool, Tensor? s_next, ScalarType out_dtype) -> Tensor",
    "conv0_f": "conv0_f(Tensor x, Tensor w, Tensor b) -> Tensor",
    "conv3x3_f": "conv3x3_f(Tensor x, Tensor w, Tensor b, bool pool=True) -> Tensor",
    "coattention_fwd": "coattention_fwd(Tensor x_img, Tensor q, Tensor W_v, Tensor b_v, "
                       "Tensor W_q, Tensor b_q, Tensor w_v, Tensor w_q) -> (Tensor, Tensor)",
    "mma_rate": "mma_rate(Tensor x, Tensor w) -> Tensor",
}
# the CUDA implementations, also for timing a launch without the operator's dispatch
CUDA_IMPLS = {"conv0_i8": _conv0_i8_cuda, "int8_conv3x3": _int8_conv3x3_cuda,
              "conv0_f": _conv0_f_cuda, "conv3x3_f": _conv3x3_f_cuda,
              "coattention_fwd": _coattention_fwd_cuda, "mma_rate": _mma_rate_cuda}
_CPU_IMPLS = {"conv0_i8": _conv0_i8_cpu, "int8_conv3x3": _int8_conv3x3_cpu,
              "conv0_f": _conv0_f_cpu, "conv3x3_f": _conv3x3_f_cpu,
              "coattention_fwd": _coattention_fwd_cpu, "mma_rate": _mma_rate_cpu}
_FAKES = {"conv0_i8": _conv0_i8_fake, "int8_conv3x3": _int8_conv3x3_fake,
          "conv0_f": _conv0_f_fake, "conv3x3_f": _conv3x3_f_fake,
          "coattention_fwd": _coattention_fwd_fake, "mma_rate": _mma_rate_fake}

_LIBRARY = torch.library.Library(NAMESPACE, "DEF")
for _name, _schema in SCHEMAS.items():
    _LIBRARY.define(_schema)
    _LIBRARY.impl(_name, _CPU_IMPLS[_name], "CPU")
    _LIBRARY.impl(_name, CUDA_IMPLS[_name], "CUDA")
    torch.library.register_fake(f"{NAMESPACE}::{_name}", _FAKES[_name], lib=_LIBRARY)

# {name: the operator} (``torch.ops.vqa_tpu_torch.<name>.default``)
OPS = {name: getattr(getattr(torch.ops, NAMESPACE), name).default for name in SCHEMAS}
