"""Input pipeline: batch loader, host decode, device preprocess (port of
vqa_tpu/data/pipeline.py).

:class:`DataLoader` (vqa_tpu/data/pipeline.py:61-218) assembles batches on
a background thread: pre-tokenized question arrays (``VQASamples``) plus
images decoded by ``images.decode_batch``, pushed onto a bounded queue. The
decode engine is vqa_tpu's choice: ``auto`` resolves to ``native_mp`` (a
process pool of native decoders) for a loader on real data with
``num_workers > 1`` when the native library builds, else to ``native``
threads (every file a JPEG) or PIL threads; the loader prints what it chose.
In feature mode (``feature_cache``: ``data.feature_cache.FeatureCache``)
a batch gathers the cached rows of its images instead of decoding pixels;
neither that mode nor ``native_mp`` keeps a decode thread pool. The epoch
order is vqa_tpu's, a pure function of ``(seed, epoch)``, so a run resumed
with ``set_epoch(epoch, skip_batches)`` sees the batches an uninterrupted
run would. With ``pin_memory`` the producer thread also copies each image
(or feature) batch into pinned host memory, so the H2D copy in
:func:`device_batch` is an asynchronous DMA. ``shard_index`` / ``num_shards`` give each host
(node) a disjoint, equal share of every epoch's order, as vqa_tpu's do, and
``rows`` a rank its block of the host's batches.

:func:`preprocess_images` (vqa_tpu/data/pipeline.py:37-58), on the device:
uint8 [B, H, W, 3] -> /255 -> ImageNet normalize, on the target device. A
resize runs only when the sizes differ (bilinear, antialiased, as
``jax.image.resize`` is on a downscale); serving decodes straight to the
model's size, so the serving path never resizes.

Arithmetic: the JAX package's jitted preprocess compiles to
``fma(x, f32(1/255), -mean) * f32(1/std)`` (XLA folds both divisions by
constants into multiplies by reciprocals, and the CPU backend contracts the
first pair into an FMA). The port computes the same values: ``x * r - mean``
is exact in float64 (an 8-bit integer times a 24-bit constant, plus a
24-bit constant), so rounding it once to f32 is the FMA. Every op is exactly
rounded, so the CPU and the card give the same bits.

Spans (``train.profiling.span``): ``vqa.data.wait``, the consumer blocked on
the loader's queue; ``vqa.data.device_batch``, the H2D copies and preprocess.
"""

from __future__ import annotations

import queue
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.quant import const
from ..parallel.mesh import row_block
from ..train.profiling import span
from .dataset import VQASamples
from .images import all_jpeg, decode_batch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
_INV_255 = float(np.float32(1.0) / np.float32(255.0))
_INV_STD = tuple(float(np.float32(1.0) / np.float32(s)) for s in IMAGENET_STD)


def preprocess_images(raw_uint8, image_size: int, compute_dtype=torch.float32,
                      device="cuda") -> torch.Tensor:
    """uint8 [B, H, W, 3] (numpy or tensor) -> normalized [B, S, S, 3]."""
    x = raw_uint8 if isinstance(raw_uint8, torch.Tensor) \
        else torch.from_numpy(np.asarray(raw_uint8))
    # non_blocking: an asynchronous DMA when the loader pinned the batch
    x = x.to(device, non_blocking=True)
    mean = const(IMAGENET_MEAN, x.device)
    b, h, w, c = x.shape
    if (h, w) != (image_size, image_size):
        x = x.float() * const(_INV_255, x.device)
        x = F.interpolate(x.permute(0, 3, 1, 2), size=(image_size, image_size),
                          mode="bilinear", align_corners=False, antialias=True
                          ).permute(0, 2, 3, 1)
        x = x - mean
    else:
        x = (x.double() * const(_INV_255, x.device).double() - mean.double()).float()
    return (x * const(_INV_STD, x.device)).to(compute_dtype)


def make_image_preprocessor(image_size: int, compute_dtype=torch.float32,
                            device="cuda"):
    """Bind the static arguments of :func:`preprocess_images`."""
    def fn(raw_uint8):
        return preprocess_images(raw_uint8, image_size, compute_dtype, device)
    return fn


def _resolve_auto(image_names, synthetic_images: bool, num_workers: int) -> str:
    """vqa_tpu's resolution of ``auto`` for a loader: the native process pool
    on real data with more than one worker (it beat both thread-pool engines
    in vqa_tpu's measurements, BASELINE.md r3), else native threads when
    every file is a JPEG, else PIL. Each native engine needs the library
    built (one attempt a process)."""
    from ..native.jpeg import native_available

    if not synthetic_images and num_workers > 1 and native_available():
        return "native_mp"
    if all_jpeg(image_names) and native_available():
        return "native"
    return "pil"


class DataLoader:
    """Shuffling, prefetching batch loader over :class:`VQASamples`.

    Yields dicts ``{image: uint8 [B,S,S,3], question: int32 [B,L],
    ques_len: int32 [B], label: int32 [B]}``; ``image`` is a numpy array,
    or a pinned uint8 tensor with ``pin_memory``, and the rest are numpy.
    In feature mode ``image`` is a tensor of cached feature rows in the
    cache's dtype. Same arguments as vqa_tpu's loader, and ``rows = (index,
    count)``: each batch keeps only block ``index`` of ``count`` equal
    blocks of its rows, a rank's share of its host's batch (nothing else is
    decoded).
    """

    def __init__(self, samples: VQASamples, batch_size: int, *, host_size: int,
                 shuffle: bool = True, drop_last: bool = True, num_workers: int = 4,
                 seed: int = 0, synthetic_images: bool = False, prefetch: int = 2,
                 shard_index: int = 0, num_shards: int = 1,
                 decode_backend: str = "auto", feature_cache=None,
                 pin_memory: bool = False, rows: tuple[int, int] = (0, 1)):
        if not 0 <= shard_index < num_shards:
            raise ValueError(f"shard_index {shard_index} not in [0, {num_shards})")
        if not 0 <= rows[0] < rows[1]:
            raise ValueError(f"rows {rows}: need 0 <= index < count")
        self.samples = samples
        self.shard_index = shard_index
        self.num_shards = num_shards
        self.rows = rows
        self.feature_cache = feature_cache
        if feature_cache is not None:
            self._feature_rows = np.fromiter(
                (feature_cache.row_of[n] for n in samples.image_names),
                np.int64, count=len(samples.image_names))
        elif decode_backend == "auto":
            decode_backend = _resolve_auto(samples.image_names, synthetic_images,
                                           num_workers)
            print(f"data loader: --decode_backend auto -> {decode_backend}")
        self.batch_size = batch_size
        self.host_size = host_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.synthetic_images = synthetic_images
        self.prefetch = max(1, prefetch)
        self.decode_backend = decode_backend
        self.num_workers = num_workers
        self.pin_memory = pin_memory
        self._epoch = 0
        self._skip_batches = 0
        # feature mode gathers memmap rows, and native_mp owns its processes
        self._pool = ThreadPoolExecutor(num_workers) \
            if (num_workers > 0 and feature_cache is None
                and decode_backend not in ("native", "native_mp")) else None

    def __len__(self) -> int:
        n = len(self.samples) // self.num_shards
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def set_epoch(self, epoch: int, skip_batches: int = 0) -> None:
        """Position the shuffle sequence at ``epoch``; the next iteration
        (only) skips its first ``skip_batches`` batches, the ones an
        interrupted run already trained on, without decoding them."""
        self._epoch = int(epoch)
        self._skip_batches = int(skip_batches)

    def _epoch_order(self) -> np.ndarray:
        order = np.arange(len(self.samples))
        if self.shuffle:
            rng = np.random.default_rng((self.seed, self._epoch))
            rng.shuffle(order)
        # this host's shard: truncated to a multiple of num_shards first, so
        # every host takes the same number of steps (vqa_tpu/data/pipeline.py:144-149)
        n_even = (len(order) // self.num_shards) * self.num_shards
        return order[:n_even][self.shard_index::self.num_shards]

    def _make_batch(self, idx: np.ndarray) -> dict:
        idx = idx[row_block(len(idx), *self.rows)]    # this rank's block
        if self.feature_cache is not None:
            images = self.feature_cache.gather(self._feature_rows[idx])
            if self.pin_memory:
                images = images.pin_memory()
        else:
            paths = [self.samples.image_path(i) for i in idx]
            images = decode_batch(paths, self.host_size, pool=self._pool,
                                  synthetic_fallback=self.synthetic_images,
                                  backend=self.decode_backend,
                                  native_threads=max(self.num_workers, 1))
            if self.pin_memory:
                images = torch.from_numpy(images).pin_memory()
        return {
            "image": images,
            "question": self.samples.questions[idx],
            "ques_len": self.samples.ques_len[idx],
            "label": self.samples.labels[idx],
        }

    def __iter__(self):
        order = self._epoch_order()
        self._epoch += 1
        bs = self.batch_size
        n_full = len(order) // bs
        starts = [i * bs for i in range(n_full)]
        if not self.drop_last and n_full * bs < len(order):
            starts.append(n_full * bs)
        if self._skip_batches:
            starts = starts[self._skip_batches:]
            self._skip_batches = 0

        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put_or_stop(item) -> bool:
            # a bounded put that gives up once the consumer is gone, so an
            # abandoned iterator never leaves this thread blocked
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for s in starts:
                    if not put_or_stop(self._make_batch(order[s:s + bs])):
                        return
            except BaseException as e:  # surface it to the consumer, not as
                put_or_stop(e)          # a clean end of the epoch
                return
            put_or_stop(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                with span("vqa.data.wait"):
                    batch = q.get()
                if batch is None:
                    break
                if isinstance(batch, BaseException):
                    raise batch
                yield batch
        finally:
            stop.set()
            t.join(timeout=10.0)

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=True)


def device_batch(batch: dict, preprocess, device) -> dict:
    """Host batch -> device batch: the image through ``preprocess`` (H2D +
    normalize on ``device``), or, with ``preprocess=None``, cached feature
    rows copied as they are; the int arrays as int64 tensors there."""
    with span("vqa.data.device_batch"):
        out = {k: torch.from_numpy(np.asarray(batch[k])).long().to(device, non_blocking=True)
               for k in ("question", "ques_len", "label")}
        out["image"] = (batch["image"].to(device, non_blocking=True) if preprocess is None
                        else preprocess(batch["image"]))
        return out


def device_prefetch(batch_iter, prepare_batch, depth: int = 2):
    """Map ``prepare_batch`` over ``batch_iter`` ``depth`` batches ahead
    (vqa_tpu/data/pipeline.py:221-252): the H2D copies and preprocess of
    the next batches are enqueued on the stream before the current step's
    kernels, so the host never waits on them. ``depth <= 1`` maps lazily."""
    it = iter(batch_iter)
    if depth <= 1:
        for batch in it:
            yield prepare_batch(batch)
        return
    pending = deque()

    def fill():
        while len(pending) < depth:
            try:
                pending.append(prepare_batch(next(it)))
            except StopIteration:
                return

    fill()
    while pending:
        out = pending.popleft()
        fill()
        yield out
