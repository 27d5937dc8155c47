"""Build the port's CUDA kernels with nvcc at first use and bind them with ctypes.

Each ``csrc/*.cu`` file exports a plain C launcher that returns
``cudaGetLastError()`` after its launch. It is compiled on its own into
``build/vqa_tpu_torch/<name>.<hash>.so`` (``-gencode arch=compute_90a,
code=sm_90a``, ``-fmad=false``), keyed by the content hash of the source and
of the shared headers (``csrc/*.cuh``), so an edited source never loads a
stale library. :func:`build_all` starts one nvcc
per source at once; a file lock beside each library keeps processes that
start together (the ranks of one host) from building it twice. Nothing
here runs when the module is imported.

A :class:`CudaKernel` holds one launcher and its ``launches`` count: the count
goes up by one for each launch that CUDA accepted, and nowhere else.
A failed build or a refused launch raises.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading

import torch

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "build", "vqa_tpu_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH): "
                       "the port's CUDA kernels are built from source at first use")


def _lib_path(source: str) -> str:
    """The library's path, keyed by the source, the headers it may include
    (``csrc/*.cuh``) and the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in [source] + sorted(n for n in os.listdir(CSRC) if n.endswith(".cuh")):
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(f.read())
    digest = h.hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"{os.path.splitext(source)[0]}.{digest}.so")


@contextlib.contextmanager
def _file_lock(lib_path: str):
    """An exclusive lock beside a library, held while it is built: processes
    that start together (the ranks of one host) build each source once."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(f"{lib_path}.lock", "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


class CudaKernel:
    """One hand-written CUDA launcher from ``csrc/``, built at first use.

    ``argtypes`` lists every argument, the stream last: pointers and the
    stream are ``c_void_p``, sizes ``c_int``; the C function returns a
    ``cudaError_t`` as an int. ``replaces`` names the TPU kernel it ports.
    """

    def __init__(self, source: str, symbol: str, argtypes: list, replaces: str):
        self.source = source
        self.symbol = symbol
        self.argtypes = argtypes
        self.replaces = replaces
        self.launches = 0
        self.plain_on_cuda = 0     # plain-version calls on CUDA tensors
        self.build_log = ""
        self._fn = None
        self._err = None
        self._lock = threading.Lock()

    def start_build(self):
        """Start nvcc for this source unless its library exists; returns the
        process (or None) so several builds can run at once."""
        path = _lib_path(self.source)
        if os.path.exists(path):
            return None
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        return subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, self.source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    def finish_build(self, proc) -> None:
        if proc is None:
            return
        out, _ = proc.communicate()
        self.build_log = out
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {self.source}:\n{out}")
        tmp = proc.args[proc.args.index("-o") + 1]
        os.replace(tmp, _lib_path(self.source))

    def _load(self):
        with self._lock:
            if self._fn is None:
                with _file_lock(_lib_path(self.source)):   # one nvcc across processes
                    self.finish_build(self.start_build())
                lib = ctypes.CDLL(_lib_path(self.source))
                fn = getattr(lib, self.symbol)
                fn.argtypes = self.argtypes
                fn.restype = ctypes.c_int
                err = lib.vqa_cuda_error_string
                err.argtypes = [ctypes.c_int]
                err.restype = ctypes.c_char_p
                self._fn, self._err = fn, err
        return self._fn

    def launch(self, *args) -> None:
        """Launch on the current stream (the last argument is filled in)."""
        fn = self._load()
        rc = fn(*args, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{self.symbol} launch failed: "
                               f"{self._err(rc).decode()} (cudaError {rc})")
        self.launches += 1


_P, _I = ctypes.c_void_p, ctypes.c_int

CONV0_S2D_I8 = CudaKernel(
    "conv0_s2d_i8.cu", "conv0_s2d_i8",
    [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    replaces="vqa_tpu/ops/conv_stage1.py:147 (_kernel_i8), "
             "vqa_tpu/ops/conv_stem.py:45 (_kernel_conv0_packed)")
CONV3X3_I8 = CudaKernel(
    "conv3x3_i8.cu", "conv3x3_i8",
    [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    replaces="vqa_tpu/ops/conv_hpack.py:104 (_kernel)")

CONV0_F = CudaKernel(
    "conv0_f.cu", "conv0_f",
    [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    replaces="vqa_tpu/ops/conv_stage1.py:111 (_kernel), "
             "vqa_tpu/ops/conv_stage1.py:178 (_kernel_v2), "
             "vqa_tpu/ops/conv_stage1.py:209 (_kernel_wide)")

CONV3X3_F = CudaKernel(
    "conv3x3_f.cu", "conv3x3_f",
    [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    replaces="vqa_tpu/ops/conv_hpack.py:104 (_kernel with int8=False)")

COATTENTION_FWD = CudaKernel(
    "coattention_fwd.cu", "coattention_fwd",
    [_P] * 14 + [_I, _I, _I, _I, _I, _P],
    replaces="tools/retired/coattention_kernel.py:45 (_kernel)")

KERNELS = (CONV0_S2D_I8, CONV3X3_I8, CONV0_F, CONV3X3_F, COATTENTION_FWD)


def build_all() -> None:
    """Compile every kernel source at once (one nvcc each) and load them."""
    with contextlib.ExitStack() as locks:
        for k in KERNELS:
            locks.enter_context(_file_lock(_lib_path(k.source)))
        procs = [(k, k.start_build()) for k in KERNELS]
        for k, proc in procs:
            k.finish_build(proc)
    for k in KERNELS:
        k._load()


def reset_counts() -> None:
    for k in KERNELS:
        k.launches = 0
        k.plain_on_cuda = 0
