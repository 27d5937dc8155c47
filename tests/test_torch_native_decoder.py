"""The port's native JPEG decoder and its process pool vs vqa_tpu's.

On JPEGs that PIL writes from seeded numpy arrays (smooth gradient plus
noise, as tests/test_native_decoder.py), the port's library (its own copy of
``jpeg_decoder.cpp``, built with g++ into ``build/vqa_tpu_torch``) decodes
bit for bit what vqa_tpu's does, with the same status mask for a missing
file; ``native_mp`` equals ``native``; ``auto`` falls back per image; a
worker imports neither torch nor jax; a failed build raises with the
compiler's output instead of falling back; and two loaders decoding through
the one ``native_mp`` pool at once each get their own images (vqa_tpu's
unguarded pool swaps them: ROADMAP.md, faults).
"""

import importlib
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
from PIL import Image

from vqa_tpu.native import decode_batch_native as j_decode_native
from vqa_tpu.native import native_available as j_native_available
from vqa_tpu_torch.data import images as t_images
from vqa_tpu_torch.data import pipeline as t_pipeline
from vqa_tpu_torch.data.dataset import VQASamples
from vqa_tpu_torch.native import jpeg as t_jpeg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jpegs(tmp_path_factory):
    root = tmp_path_factory.mktemp("jpegs")
    rng = np.random.default_rng(0)
    paths = []
    for i, (w, h) in enumerate([(320, 240), (240, 320), (96, 64), (500, 375), (64, 64),
                                (320, 240)]):
        g = np.linspace(0, 255, w, dtype=np.uint8)
        img = np.stack([np.tile(g, (h, 1))] * 3, axis=-1)
        img = np.clip(img.astype(int) + rng.integers(-20, 20, img.shape), 0, 255)
        p = root / f"im{i}.jpg"
        Image.fromarray(img.astype(np.uint8)).save(p, quality=90)
        paths.append(str(p))
    return paths


@pytest.fixture(scope="module")
def built():
    if not t_jpeg.native_available():
        pytest.fail(f"the port's native decoder did not build:\n{t_jpeg._LIBRARY.error}")
    if not j_native_available():
        pytest.fail("vqa_tpu's native decoder did not build")


@pytest.mark.parametrize("size", [32, 64, 128, 300])
def test_bit_equal_to_vqa_tpu(built, jpegs, tmp_path, size):
    """DCT-scaled decode (1/8 .. 1/1) then the bilinear resize, up and down."""
    paths = jpegs + [str(tmp_path / "missing.jpg")]
    ref, ref_ok = j_decode_native(paths, size, threads=2)
    out, ok = t_jpeg.decode_batch_native(paths, size, threads=3)
    assert out.shape == (len(paths), size, size, 3) and out.dtype == np.uint8
    assert ok.tolist() == ref_ok.tolist() == [True] * len(jpegs) + [False]
    assert out.tobytes() == ref.tobytes()
    assert out[-1].max() == 0


def test_native_mp_equals_native_and_recovers(built, jpegs, tmp_path):
    mp = t_images.decode_batch(jpegs, 96, backend="native_mp", native_threads=2)
    th = t_images.decode_batch(jpegs, 96, backend="native", native_threads=2)
    assert mp.tobytes() == th.tobytes()
    # a worker's error surfaces and the pool is dropped; the next call respawns it
    with pytest.raises(RuntimeError, match="decode worker error"):
        t_images.decode_batch([jpegs[0], str(tmp_path / "missing.jpg")], 64,
                              backend="native_mp", native_threads=2)
    assert t_images._MP_POOL is None
    again = t_images.decode_batch(jpegs, 96, backend="native_mp", native_threads=2)
    assert again.tobytes() == th.tobytes()
    procs = t_images._MP_POOL.procs
    t_images._close_mp_pool()
    assert t_images._MP_POOL is None and all(p.poll() is not None for p in procs)


def test_auto_falls_back_per_image(built, jpegs, tmp_path):
    """``auto`` decodes JPEGs natively; a missing file becomes vqa_tpu's
    synthetic image, and non-JPEG input goes to PIL, as in vqa_tpu."""
    from vqa_tpu.data.images import decode_batch as j_decode_batch

    missing = str(tmp_path / "gone.jpg")
    out = t_images.decode_batch(jpegs[:2] + [missing], 48, synthetic_fallback=True)
    ref = j_decode_batch(jpegs[:2] + [missing], 48, synthetic_fallback=True, backend="auto")
    assert out.tobytes() == ref.tobytes()
    assert np.array_equal(out[2], t_images.synthetic_image("gone.jpg", 48))
    assert np.array_equal(out[:2], t_jpeg.decode_batch_native(jpegs[:2], 48)[0])
    png = str(tmp_path / "x.png")
    Image.open(jpegs[2]).save(png)
    mixed = t_images.decode_batch([jpegs[0], png], 40)
    assert np.array_equal(mixed, t_images.decode_batch([jpegs[0], png], 40, backend="pil"))
    with pytest.raises(ValueError, match="jpg"):
        t_images.decode_batch([png], 40, backend="native")


def test_loader_resolves_auto_as_vqa_tpu(built, jpegs, tmp_path, capsys):
    """Real data with more than one worker: ``native_mp``; synthetic JPEG
    names: ``native``; otherwise ``pil``; printed once per loader."""
    root = os.path.dirname(jpegs[0])
    data = tmp_path / "d.txt"
    data.write_text("".join(f"{os.path.basename(p)}\tis,it\tyes\n" for p in jpegs))
    samples = VQASamples(str(data), root, {"<PAD>": 0, "<UNKNOWN>": 1, "is": 2, "it": 3},
                         {"UNKNOWN": 0, "yes": 1}, 3)
    cases = [(dict(num_workers=2), "native_mp"), (dict(num_workers=1), "native"),
             (dict(num_workers=2, synthetic_images=True), "native")]
    for kw, want in cases:
        loader = t_pipeline.DataLoader(samples, 3, host_size=40, shuffle=False, **kw)
        assert loader.decode_backend == want
        assert capsys.readouterr().out.count(f"--decode_backend auto -> {want}") == 1
        batch = next(iter(loader))
        assert np.array_equal(batch["image"], t_jpeg.decode_batch_native(jpegs[:3], 40)[0])
        loader.close()
    png = tmp_path / "p.txt"
    png.write_text("a.png\tis\tyes\n" * 3)
    loader = t_pipeline.DataLoader(VQASamples(str(png), str(tmp_path),
                                              {"<PAD>": 0, "<UNKNOWN>": 1, "is": 2},
                                              {"UNKNOWN": 0, "yes": 1}, 2),
                                   3, host_size=8, synthetic_images=True)
    assert loader.decode_backend == "pil"
    loader.close()


def test_worker_imports_neither_torch_nor_jax(built, jpegs):
    """A worker serves a real request through the native decoder, and then
    holds no module of torch, jax or vqa_tpu."""
    code = ("import sys; from vqa_tpu_torch.data._decode_worker import serve; serve(); "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'jax', 'jaxlib', 'flax', 'vqa_tpu')]; "
            "sys.stderr.write('BAD=%r NATIVE=%r' % (bad, "
            "'vqa_tpu_torch.native.jpeg' in sys.modules))")
    req = b"REQ 2 16 0\n" + "".join(p + "\n" for p in jpegs[:2]).encode()
    proc = subprocess.run([sys.executable, "-c", code], input=req, cwd=REPO,
                          capture_output=True, timeout=120)
    assert proc.returncode == 0, proc.stderr.decode()
    assert proc.stdout.startswith(b"OK 2 16\n") and len(proc.stdout) == 8 + 2 * 16 * 16 * 3
    assert proc.stderr.decode().endswith("BAD=[] NATIVE=True")
    assert t_images._SubprocPool.CMD == code.split("; serve(); ")[0].split("; ", 1)[1] + \
        "; serve()"


def test_native_raises_when_the_build_fails(jpegs, tmp_path, monkeypatch):
    """A compiler command that cannot build: ``native`` and ``native_mp``
    raise with the compiler's output, ``auto`` decodes with PIL."""
    monkeypatch.setattr(t_jpeg, "CXX", (*t_jpeg.CXX, "-fno-such-option-for-this-test"))
    monkeypatch.setattr(t_jpeg, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(t_jpeg, "_LIBRARY", t_jpeg._Library())
    assert not t_jpeg.native_available()
    for backend in ("native", "native_mp"):
        with pytest.raises(RuntimeError, match="no-such-option-for-this-test") as e:
            t_images.decode_batch(jpegs[:2], 32, backend=backend)
        assert "could not be built" in str(e.value)
    assert not os.listdir(tmp_path / "build")
    out = t_images.decode_batch(jpegs[:2], 32)
    assert np.array_equal(out, t_images.decode_batch(jpegs[:2], 32, backend="pil"))


class _PausedReader:
    """A worker's stdout whose first ``readline`` from the thread ``owner``
    waits until ``release`` is set, after setting ``waiting``."""

    def __init__(self, stream, owner: str, waiting, release):
        self._stream, self._owner = stream, owner
        self._waiting, self._release = waiting, release

    def readline(self):
        if threading.current_thread().name == self._owner and not self._release.is_set():
            self._waiting.set()
            self._release.wait(60)
        return self._stream.readline()

    def __getattr__(self, name):
        return getattr(self._stream, name)


@pytest.mark.parametrize("package", ["vqa_tpu_torch", "vqa_tpu"])
def test_native_mp_concurrent_loaders(jpegs, package):
    """Two loaders (train and val) decode different batches through the one
    ``native_mp`` pool at once. Loader A has sent its requests and waits for
    its first reply when loader B decodes. The port's lock holds B until A
    has its replies, so each gets what ``native`` decodes. vqa_tpu's pool
    (vqa_tpu/data/images.py:85-113, :131-150) is unguarded: B reads A's
    replies, and A then reads B's (ROADMAP.md, faults)."""
    if not (t_jpeg.native_available() and j_native_available()):
        pytest.skip("the native decoder does not build on this host")
    images = t_images if package == "vqa_tpu_torch" else importlib.import_module(
        "vqa_tpu.data.images")
    batches = {"A": (jpegs[:3] * 2, 96), "B": (jpegs[3:] * 2, 64)}
    want = {k: t_images.decode_batch(p, s, backend="native", native_threads=2)
            for k, (p, s) in batches.items()}
    images.decode_batch(jpegs[:2], 32, backend="native_mp", native_threads=2)  # the pool
    waiting, release = threading.Event(), threading.Event()
    for proc in images._MP_POOL.procs:
        proc.stdout = _PausedReader(proc.stdout, "A", waiting, release)
    got = {}

    def decode(name):
        paths, size = batches[name]
        got[name] = images.decode_batch(paths, size, backend="native_mp", native_threads=2)

    threads = {k: threading.Thread(target=decode, args=(k,), name=k) for k in batches}
    try:
        threads["A"].start()
        assert waiting.wait(60)
        threads["B"].start()
        threads["B"].join(2)
        b_waited = threads["B"].is_alive()
    finally:
        release.set()
        for t in threads.values():
            t.join(60)
        assert not any(t.is_alive() for t in threads.values())
        if package == "vqa_tpu_torch":
            t_images._close_mp_pool()
        else:
            images._MP_POOL.terminate()
            images._MP_POOL = None
    if package == "vqa_tpu_torch":
        assert b_waited
        assert {k: v.tobytes() for k, v in got.items()} == \
            {k: v.tobytes() for k, v in want.items()}
    else:
        assert not b_waited
        assert got["B"].tobytes() == want["A"].tobytes()        # B answered with A's images
        assert got["A"].tobytes() == want["B"].tobytes()
