"""Frozen-tower feature cache: the VGG tower once per image (port of
vqa_tpu/data/feature_cache.py).

With a frozen VGG (``--vgg_train false``, the reference's configuration)
and running-stats BatchNorm, the image tower is a constant function of each
image, yet an uncached run decodes the image and runs the tower in every
step of every epoch. ``--cache_features true`` runs them once:

- a build pass streams every *unique* image of a dataset through host
  decode -> device preprocess -> the frozen tower (the port's kernels A and
  B on the int8 route, kernel C on the float route) and writes the result
  into a disk-backed memory map (``features.bin`` + ``meta.json``);
- training and evaluation batches then gather rows of it; no VGG forward
  runs in a cached step.

The cache boundary (``VQANet.cache_features``) is the last frozen,
deterministic tensor of the tower:

- attention: the image encoder's ``[B, 196, 512]`` (at 448²);
- baseline and bert: the conv stack's ``[B, S/32, S/32, 512]``, not the
  4096-wide head: the head's two dropouts are live in training, so the
  adaptive pool, the flatten and the classifier run in the step and draw
  their masks from the checkpointed generator in the uncached order.

Stored values are exactly what the head receives on the uncached path, in
its dtype: the VGG returns the compute dtype on every route, so the file
holds bfloat16 at ``--opt_lvl >= 1`` (the int8 route and the float bf16
route) and float32 at ``--opt_lvl 0``; cached training equals uncached
training bit for bit. bfloat16 is stored as raw 2-byte words (a uint16
memmap read back with ``Tensor.view(torch.bfloat16)``), so no numpy
extension type is needed; ``meta.json`` names the dtype as vqa_tpu does
(``"bfloat16"``, ``"float32"``) with vqa_tpu's keys.

The directory key covers everything that changes the stored values: the
fingerprint of the boundary encoder's tensors, the image size, the dtype,
the boundary (with the int8 routing and calibration tag), the dataset's
image names and the input pipeline (host size, synthetic fallback, decode
backend). A stale cache is rebuilt, never reused.
"""

from __future__ import annotations

import contextlib
import glob
import hashlib
import json
import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .images import decode_batch

_META = "meta.json"
_BIN = "features.bin"
# torch dtype -> (meta.json name, numpy storage dtype)
_STORAGE = {torch.float32: ("float32", np.float32), torch.bfloat16: ("bfloat16", np.uint16)}
_TORCH_DTYPE = {name: dt for dt, (name, _) in _STORAGE.items()}


def variables_fingerprint(state_dict: dict) -> str:
    """Digest of a module's tensors (parameters and BatchNorm buffers),
    order-insensitive: each as (name, shape, dtype, raw bytes), sorted by
    name, so any weight edit, statistics update or change of structure
    moves it."""
    h = hashlib.blake2b(digest_size=16)
    for name in sorted(state_dict):
        t = state_dict[name].detach().cpu().contiguous()
        h.update(name.encode())
        h.update(str(tuple(t.shape)).encode())
        h.update(str(t.dtype).encode())
        h.update(t.reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def _to_storage(feats: torch.Tensor) -> np.ndarray:
    """Device features -> host numpy words of the storage dtype."""
    x = feats.detach().cpu().contiguous()
    if x.dtype == torch.bfloat16:
        return x.view(torch.int16).numpy().view(np.uint16)
    return x.numpy()


class FeatureCache:
    """Read view of a built cache: image name -> feature row (a memmap).
    ``build_seconds``: the build pass's host seconds when this process built
    it, else None."""

    def __init__(self, cache_dir: str):
        self.cache_dir = cache_dir
        self.build_seconds: float | None = None
        with open(os.path.join(cache_dir, _META)) as f:
            self.meta = json.load(f)
        names = self.meta["names"]
        self.row_of = {n: i for i, n in enumerate(names)}
        self.dtype = _TORCH_DTYPE[self.meta["dtype"]]
        self.features = np.memmap(
            os.path.join(cache_dir, _BIN), dtype=_STORAGE[self.dtype][1], mode="r",
            shape=tuple([len(names)] + self.meta["feature_shape"]))

    def gather(self, rows: np.ndarray) -> torch.Tensor:
        """Feature rows by index, as a CPU tensor of the stored dtype (the
        memmap's fancy index is a fresh in-memory array)."""
        t = torch.from_numpy(np.ascontiguousarray(self.features[rows]))
        return t.view(torch.bfloat16) if self.dtype == torch.bfloat16 else t

    def rows(self, names: list[str]) -> torch.Tensor:
        """Feature rows of a batch of image names."""
        return self.gather(np.fromiter((self.row_of[n] for n in names), np.int64,
                                       count=len(names)))

    @property
    def feature_shape(self) -> tuple:
        return tuple(self.meta["feature_shape"])


def cache_key(fingerprint: str, image_size: int, dtype: torch.dtype, boundary: str,
              names_digest: str, pipeline_tag: str) -> str:
    """The cache directory's name: a digest of everything that changes the
    stored values. ``names_digest`` keeps datasets apart (train and val
    never share a directory); ``pipeline_tag`` holds the input-path knobs
    that change the pixels the encoder sees."""
    h = hashlib.blake2b(digest_size=8)
    h.update(f"{fingerprint}|{image_size}|{_STORAGE[dtype][0]}|{boundary}"
             f"|{names_digest}|{pipeline_tag}".encode())
    return h.hexdigest()


def _remove_orphans(cache_dir: str, max_age_s: float = 86400.0) -> None:
    """Delete temporary files of builds killed midway. Only those older than
    a day: a live concurrent build's file is never pulled from under it."""
    for stale in glob.glob(os.path.join(cache_dir, "*.tmp.*")):
        try:
            if time.time() - os.path.getmtime(stale) > max_age_s:
                os.remove(stale)
        except OSError:
            pass


def build_or_open(cache_root: str, samples, encode_fn, *, fingerprint: str,
                  image_size: int, dtype: torch.dtype, boundary: str, batch_size: int,
                  host_size: int, num_workers: int = 4, synthetic_images: bool = False,
                  decode_backend: str = "auto", log=print) -> FeatureCache:
    """Open the valid cache of (``samples``' images x the encoder), building
    it first if there is none.

    ``encode_fn``: host uint8 [B, S, S, 3] -> features [B, ...] in
    ``dtype`` (decode -> preprocess -> frozen tower, on the caller's
    device). The build writes a pid-unique temporary file, pads the tail
    batch to a full batch (one shape for every encoder call), and publishes
    atomically: the bin first, then the meta, whose presence marks the
    cache valid.
    """
    if dtype not in _STORAGE:
        raise ValueError(f"feature cache: unsupported dtype {dtype}")
    names = sorted(set(samples.image_names))
    if not names:
        raise ValueError("feature cache: dataset has no images to cache")
    nh = hashlib.blake2b(digest_size=8)
    nh.update("\n".join(names).encode())
    pipeline_tag = f"h{host_size}|syn{int(synthetic_images)}|{decode_backend}"
    cache_dir = os.path.join(cache_root, cache_key(fingerprint, image_size, dtype, boundary,
                                                   nh.hexdigest(), pipeline_tag))
    meta_path = os.path.join(cache_dir, _META)
    if os.path.exists(meta_path):
        cache = FeatureCache(cache_dir)
        if cache.meta["fingerprint"] == fingerprint and cache.meta["names"] == names:
            log(f"feature cache: reusing {cache_dir} ({len(names)} images, "
                f"{cache.meta['dtype']})")
            return cache
        # only a digest collision or a hand-edited file gets here
        log("feature cache: integrity mismatch at keyed dir, rebuilding")

    os.makedirs(cache_dir, exist_ok=True)
    _remove_orphans(cache_dir)
    name, storage = _STORAGE[dtype]
    tmp_bin = os.path.join(cache_dir, f"{_BIN}.tmp.{os.getpid()}")
    n = len(names)
    mm = None
    t0 = time.perf_counter()
    with ThreadPoolExecutor(num_workers) if num_workers > 0 \
            else contextlib.nullcontext() as pool:
        for start in range(0, n, batch_size):
            batch_names = names[start:start + batch_size]
            paths = [os.path.join(samples.img_dir, b) for b in batch_names]
            paths += [paths[-1]] * (batch_size - len(paths))
            images = decode_batch(paths, host_size, pool=pool,
                                  synthetic_fallback=synthetic_images, backend=decode_backend,
                                  native_threads=max(num_workers, 1))
            feats = encode_fn(images)
            if feats.dtype != dtype:
                raise TypeError(f"feature cache: the encoder returned {feats.dtype}, "
                                f"the cache stores {dtype}")
            rows = _to_storage(feats)
            if mm is None:
                mm = np.memmap(tmp_bin, dtype=storage, mode="w+",
                               shape=tuple([n] + list(rows.shape[1:])))
            mm[start:start + len(batch_names)] = rows[:len(batch_names)]
            if start // batch_size % 50 == 0:
                log(f"feature cache: {min(start + batch_size, n)}/{n} images")
    feat_shape = list(mm.shape[1:])
    mm.flush()
    del mm
    seconds = time.perf_counter() - t0

    os.replace(tmp_bin, os.path.join(cache_dir, _BIN))
    tmp_meta = f"{meta_path}.tmp.{os.getpid()}"
    with open(tmp_meta, "w") as f:
        json.dump({"names": names, "feature_shape": feat_shape, "dtype": name,
                   "fingerprint": fingerprint, "boundary": boundary,
                   "image_size": image_size}, f)
    os.replace(tmp_meta, meta_path)
    log(f"feature cache: built {cache_dir} ({n} images, {name}, "
        f"{os.path.getsize(os.path.join(cache_dir, _BIN)) / 1e6:.1f} MB, "
        f"{seconds:.2f} s, {n / seconds:.1f} images/s)")
    cache = FeatureCache(cache_dir)
    cache.build_seconds = seconds
    return cache

