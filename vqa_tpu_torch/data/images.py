"""Host-side image decode (the port's copy of vqa_tpu/data/images.py).

The host decodes JPEG/PNG to uint8 RGB at the model's size; the device
converts to float and normalizes (``data.pipeline.preprocess_images``).
Missing files can fall back to a deterministic hash-seeded synthetic image,
so smoke runs and tests need no COCO archive; the synthetic bytes equal
vqa_tpu's for the same file name.

Backends of :func:`decode_batch`, as vqa_tpu's:

- ``pil``: PIL with libjpeg's "draft" scaled decode, optionally on a thread
  pool (PIL's decoders release the interpreter lock);
- ``native``: the C++ decoder (``vqa_tpu_torch.native``), a thread pool
  inside one call that releases the lock for the whole batch;
- ``native_mp``: a pool of worker processes (``_decode_worker``), each a
  single-threaded native decoder: the torch DataLoader's worker model;
- ``auto``: ``native`` when the library is built and every path is
  ``.jpg``/``.jpeg``, else ``pil``.

A file libjpeg rejects falls back, per image, to PIL or the synthetic
image, as in vqa_tpu. ``native`` and ``native_mp`` raise with the
compiler's output when the library cannot be built: nothing falls back
silently to another engine.
"""

from __future__ import annotations

import atexit
import hashlib
import os
import subprocess
import sys
import threading

import numpy as np
from PIL import Image

BACKENDS = ("auto", "pil", "native", "native_mp")
_PACKAGE_PARENT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def synthetic_image(name: str, size: int) -> np.ndarray:
    """Deterministic pseudo-image for a file name (tests/smoke runs without COCO)."""
    seed = int.from_bytes(hashlib.sha1(name.encode()).digest()[:4], "little")
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (size, size, 3), dtype=np.uint8)


def decode_image(path: str, host_size: int, synthetic_fallback: bool = False) -> np.ndarray:
    """Decode one image to uint8 RGB [host_size, host_size, 3].

    PIL ``draft`` mode lets libjpeg decode at a reduced scale when the
    target is much smaller than the source.
    """
    if not os.path.exists(path):
        if synthetic_fallback:
            return synthetic_image(os.path.basename(path), host_size)
        raise FileNotFoundError(path)
    with Image.open(path) as im:
        im.draft("RGB", (host_size, host_size))
        im = im.convert("RGB")
        if im.size != (host_size, host_size):
            im = im.resize((host_size, host_size), Image.BILINEAR)
        return np.asarray(im, dtype=np.uint8)


def all_jpeg(paths) -> bool:
    return all(p.lower().endswith((".jpg", ".jpeg")) for p in paths)


class _SubprocPool:
    """Persistent decode-worker subprocesses (see ``_decode_worker.py``).

    Not a ``multiprocessing`` pool, on purpose: ``fork`` of a process that
    already runs threads (the loader's, CUDA's) copies their held locks
    into the child, and ``spawn``/``forkserver`` re-execute the parent's
    ``__main__`` in every worker. Plain subprocesses that run a known entry
    point have neither failure mode. The parent writes every request before
    it reads any reply; a worker reads its whole request before replying,
    so the pipes cannot deadlock.
    """

    CMD = "from vqa_tpu_torch.data._decode_worker import serve; serve()"

    def __init__(self, n: int):
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (_PACKAGE_PARENT, env.get("PYTHONPATH", "")) if p)
        self.size = n
        self.procs = [subprocess.Popen([sys.executable, "-c", self.CMD], env=env,
                                       stdin=subprocess.PIPE, stdout=subprocess.PIPE)
                      for _ in range(n)]

    def decode(self, chunks, host_size: int, synth: bool) -> np.ndarray:
        sent = []
        for proc, paths in zip(self.procs, chunks):
            req = b"REQ %d %d %d\n" % (len(paths), host_size, int(synth))
            req += b"".join(os.fsencode(p) + b"\n" for p in paths)
            proc.stdin.write(req)
            proc.stdin.flush()
            sent.append(proc)
        outs = []
        for proc in sent:
            hdr = proc.stdout.readline()
            if hdr.startswith(b"OK"):
                _, n_imgs, size = hdr.split()
                n_imgs, size = int(n_imgs), int(size)
                buf = proc.stdout.read(n_imgs * size * size * 3)
                if len(buf) != n_imgs * size * size * 3:
                    raise RuntimeError("decode worker died (short reply)")
                outs.append(np.frombuffer(buf, np.uint8).reshape(n_imgs, size, size, 3))
            elif hdr.startswith(b"ERR"):
                msg = proc.stdout.read(int(hdr.split()[1])).decode()
                raise RuntimeError(f"decode worker error: {msg}")
            else:
                raise RuntimeError("decode worker died (empty reply)")
        return np.concatenate(outs)

    def terminate(self) -> None:
        """Close the workers' stdin (their clean shutdown: they ignore
        SIGTERM) and reap them, killing any that outlives a few seconds."""
        for proc in self.procs:
            try:
                proc.stdin.close()
            except OSError:
                pass
        for proc in self.procs:
            try:
                proc.wait(timeout=5)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
            proc.stdout.close()


_MP_POOL: _SubprocPool | None = None      # the process's native_mp pool
_MP_LOCK = threading.Lock()               # one batch at a time through it


def _close_mp_pool() -> None:
    global _MP_POOL
    with _MP_LOCK:
        if _MP_POOL is not None:
            _MP_POOL.terminate()
            _MP_POOL = None


def _decode_native_mp(paths, host_size: int, synth: bool, n: int) -> np.ndarray:
    """Decode on the process pool of ``n`` workers, spawned at first use and
    respawned after a failure or a change of size. A pool that failed a
    batch is dropped (replies may be left in its pipes)."""
    global _MP_POOL
    from ..native.jpeg import require_native

    require_native()        # build once here, not in every worker; raise if impossible
    with _MP_LOCK:
        if _MP_POOL is not None and _MP_POOL.size != n:
            _MP_POOL.terminate()
            _MP_POOL = None
        if _MP_POOL is None:
            atexit.unregister(_close_mp_pool)       # registered once at most
            atexit.register(_close_mp_pool)
            _MP_POOL = _SubprocPool(n)
        chunk = -(-len(paths) // n)
        chunks = [paths[i:i + chunk] for i in range(0, len(paths), chunk)]
        try:
            return _MP_POOL.decode(chunks, host_size, synth)
        except (RuntimeError, OSError, ValueError):
            _MP_POOL.terminate()
            _MP_POOL = None
            raise


def decode_batch(paths: list[str], host_size: int, pool=None,
                 synthetic_fallback: bool = False, backend: str = "auto",
                 native_threads: int = 8) -> np.ndarray:
    """Decode a batch of images to uint8 [N, S, S, 3].

    ``backend``: 'auto', 'pil', 'native' or 'native_mp' (module docstring).
    ``pool``: an executor whose ``map`` runs PIL decodes in parallel.
    ``native_threads``: the native decoder's threads, or ``native_mp``'s
    worker processes.
    """
    if backend not in BACKENDS:
        raise ValueError(f"decode backend {backend!r} is not one of {BACKENDS}")
    if backend == "native_mp":
        return _decode_native_mp(paths, host_size, synthetic_fallback, max(native_threads, 1))
    if backend in ("auto", "native"):
        from ..native.jpeg import decode_batch_native, native_available

        if backend == "native" and not all_jpeg(paths):
            raise ValueError("decode backend 'native' takes .jpg/.jpeg files only")
        if backend == "native" or (all_jpeg(paths) and native_available()):
            out, ok = decode_batch_native(paths, host_size, threads=native_threads)
            for i in np.nonzero(~ok)[0]:
                out[i] = decode_image(paths[i], host_size, synthetic_fallback)
            return out

    def one(p):
        return decode_image(p, host_size, synthetic_fallback)

    imgs = [one(p) for p in paths] if pool is None else list(pool.map(one, paths))
    return np.stack(imgs)
