"""Host-side image decode (the port's copy of vqa_tpu/data/images.py).

The host decodes JPEG/PNG to uint8 RGB at the model's size (PIL, with
libjpeg's "draft" scaled decode when the source is much larger); the device
converts to float and normalizes (``data.pipeline.preprocess_images``).
Missing files can fall back to a deterministic hash-seeded synthetic image,
so smoke runs and tests need no COCO archive; the synthetic bytes equal
vqa_tpu's for the same file name.

PIL is the only decode backend here. vqa_tpu's C++ decoder
(``vqa_tpu/native/jpeg.py``) and its process pool (``native_mp``) are not
ported yet: asking for them raises.
"""

from __future__ import annotations

import hashlib
import os

import numpy as np
from PIL import Image

BACKENDS = ("auto", "pil")


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


def decode_batch(paths: list[str], host_size: int, pool=None,
                 synthetic_fallback: bool = False, backend: str = "auto") -> np.ndarray:
    """Decode a batch of images to uint8 [N, S, S, 3] with PIL.

    ``pool``: an executor whose ``map`` decodes in parallel (PIL's decoders
    release the GIL). ``backend``: 'auto' or 'pil' (the same thing here);
    vqa_tpu's 'native' and 'native_mp' raise.
    """
    if backend not in BACKENDS:
        raise NotImplementedError(
            f"decode backend {backend!r} is not ported yet (ROADMAP.md queue 1 "
            f"item 3): the port decodes with PIL ('auto' or 'pil')")

    def one(p):
        return decode_image(p, host_size, synthetic_fallback)

    imgs = [one(p) for p in paths] if pool is None else list(pool.map(one, paths))
    return np.stack(imgs)
