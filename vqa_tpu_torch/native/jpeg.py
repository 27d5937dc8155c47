"""ctypes binding of the native batched JPEG decoder (``jpeg_decoder.cpp``;
the port's copy of vqa_tpu/native/jpeg.py).

The decoder decodes and resizes a whole batch on a C++ thread pool with
libjpeg's DCT-domain scaling; the interpreter lock is released for the
whole call. It is a host library, built with g++ at first use into
``build/vqa_tpu_torch/libvqa_jpeg.<hash>.so``, where the hash covers the
source, the compiler command and the target that ``-march=native``
resolves to on this host, so an edited source or another CPU never loads a
stale library. The build is tried once per process; when it fails,
:func:`native_available` answers False and :func:`decode_batch_native`
raises with the compiler's output. Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "jpeg_decoder.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "build", "vqa_tpu_torch")
# the compiler command (the output path, the source and LIBS follow it)
CXX = ("g++", "-O3", "-march=native", "-shared", "-fPIC")
LIBS = ("-ljpeg", "-pthread")


def _run(cmd: list[str]) -> str:
    """Run a compiler command; its output, or RuntimeError with the output."""
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"{' '.join(cmd)}: {e}") from e
    if proc.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)} exited {proc.returncode}:\n"
                           f"{proc.stdout}{proc.stderr}")
    return proc.stdout


def _lib_path() -> str:
    # what -march=native means on this host is part of the library's identity
    target = _run([CXX[0], "-march=native", "-Q", "--help=target"])
    with open(SRC, "rb") as f:
        h = hashlib.sha256(f.read())
    h.update(" ".join(CXX + LIBS).encode())
    h.update(target.encode())
    return os.path.join(BUILD_DIR, f"libvqa_jpeg.{h.hexdigest()[:12]}.so")


def _build_and_load() -> ctypes.CDLL:
    path = _lib_path()
    if not os.path.exists(path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        _run([*CXX, SRC, "-o", tmp, *LIBS])
        os.replace(tmp, path)          # atomic: concurrent builds never collide
    lib = ctypes.CDLL(path)
    lib.vqa_decode_batch.restype = ctypes.c_int
    lib.vqa_decode_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int, ctypes.c_int]
    return lib


class _Library:
    """The library of this process: one build attempt, its error text kept."""

    def __init__(self):
        self._lock = threading.Lock()
        self._tried = False
        self.lib: ctypes.CDLL | None = None
        self.error = ""

    def load(self) -> ctypes.CDLL | None:
        with self._lock:
            if not self._tried:
                self._tried = True
                try:
                    self.lib = _build_and_load()
                except (RuntimeError, OSError) as e:
                    self.error = str(e)
        return self.lib


_LIBRARY = _Library()


def native_available() -> bool:
    """Whether the decoder library built and loaded (one attempt a process)."""
    return _LIBRARY.load() is not None


def require_native() -> ctypes.CDLL:
    """The loaded library, or RuntimeError with the build's error."""
    lib = _LIBRARY.load()
    if lib is None:
        raise RuntimeError("the native JPEG decoder could not be built:\n" + _LIBRARY.error)
    return lib


def decode_batch_native(paths: list[str], host_size: int,
                        threads: int = 8) -> tuple[np.ndarray, np.ndarray]:
    """Decode a batch of JPEGs to uint8 [N, S, S, 3] on ``threads`` threads.

    Returns (images, ok_mask); a failed decode (missing or corrupt file) is
    zero-filled with ok False, so the caller can substitute a PIL or
    synthetic fallback.
    """
    lib = require_native()
    if host_size < 1:
        raise ValueError(f"host_size must be positive, got {host_size}")
    n = len(paths)
    out = np.empty((n, host_size, host_size, 3), np.uint8)
    status = np.zeros((n,), np.uint8)
    names = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    lib.vqa_decode_batch(names, n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                         status.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                         host_size, max(int(threads), 1))
    return out, status.astype(bool)
