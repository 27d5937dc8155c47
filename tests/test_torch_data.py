"""The port's data contract (vqa_tpu_torch.{text,vocab,data}) vs vqa_tpu's.

The port keeps its own copies of vqa_tpu's text, vocab, image-decode,
dataset and loader modules; on the same inputs they must give the same
bytes: token lists, padded ids, vocab pickles, decoded pixels, tokenized
dataset arrays and the loader's batch order (seed, epoch, intra-epoch
resume). Also: the port imports nothing of vqa_tpu. The native decoders are
held against vqa_tpu's in tests/test_torch_native_decoder.py.
"""

import os
import pickle
import re
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from vqa_tpu import text as j_text
from vqa_tpu import vocab as j_vocab
from vqa_tpu.data import dataset as j_dataset
from vqa_tpu.data import images as j_images
from vqa_tpu.data import pipeline as j_pipeline
from vqa_tpu_torch import text as t_text
from vqa_tpu_torch import vocab as t_vocab
from vqa_tpu_torch.data import dataset as t_dataset
from vqa_tpu_torch.data import images as t_images
from vqa_tpu_torch.data import pipeline as t_pipeline

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

QUESTIONS = ["Man sleeping next to a cat on a bed.", "What's,on,the,table?",
             "Is,the,S,cat,s,black", "  ,,  ", "how,many,dogs,are,there,in,the,"
             "picture,today,at,noon"]

LINES = ["img1.jpg\tWhat,is,the,cat,doing\tsleeping",
         "img2.jpg\tIs,the,cat,black\tyes",
         "img3.jpg\tIs,the,zebra,striped\tno",
         "img4.jpg\tWhat,color,is,the,dog\tbrown",
         "img5.jpg\tIs,the,dog,asleep\tyes",
         "img6.jpg\tHow,many,cats\ttwo",
         "img7.jpg\tIs,it,S,raining\tno",
         "img8.jpg\tWhat,is,on,the,table\tcake",
         "img9.jpg\tIs,this,a,zebra\tyes",
         "img10.jpg\tWhat,animal,is,this\tdog",
         "img11.jpg\tIs,the,cat,black\tno"]


@pytest.fixture
def data_file(tmp_path):
    f = tmp_path / "data.txt"
    f.write_text("\n".join(LINES) + "\n")
    return str(f)


@pytest.mark.parametrize("q", QUESTIONS)
def test_preprocess_text_and_padding_equal(q):
    toks = t_text.preprocess_text(q)
    assert toks == j_text.preprocess_text(q)
    ids = list(range(1, len(toks) + 1))
    for n in (0, 3, 23):
        a, b = t_text.pad_sequences(ids, n), j_text.pad_sequences(ids, n)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_vocab_pickle_round_trip(data_file, tmp_path):
    j_file, t_file = str(tmp_path / "j.pkl"), str(tmp_path / "t.pkl")
    j_vocab.save_vocab(data_file, j_file, 1, 5)
    t_vocab.save_vocab(data_file, t_file, 1, 5)
    with open(j_file, "rb") as f, open(t_file, "rb") as g:
        assert f.read() == g.read()
    a, b = t_vocab.Vocab.load(j_file), j_vocab.Vocab.load(j_file)
    for key in t_vocab.VOCAB_KEYS:
        assert getattr(a, key) == getattr(b, key), key
    assert (a.size, a.num_labels) == (b.size, b.num_labels)


def test_decode_batch_equal(tmp_path):
    rng = np.random.default_rng(0)
    pix = rng.integers(0, 256, (40, 56, 3), dtype=np.uint8)
    Image.fromarray(pix).save(tmp_path / "a.png")
    Image.fromarray(pix).save(tmp_path / "b.jpg", quality=90)
    paths = [str(tmp_path / n) for n in ("a.png", "b.jpg", "missing.jpg")]
    for size in (32, 64):
        ref = j_images.decode_batch(paths, size, synthetic_fallback=True, backend="pil")
        out = t_images.decode_batch(paths, size, synthetic_fallback=True)
        assert out.dtype == np.uint8 and out.shape == (3, size, size, 3)
        assert out.tobytes() == ref.tobytes()


def test_samples_equal(data_file, tmp_path):
    voc = t_vocab.Vocab.from_dict(dict(zip(
        t_vocab.VOCAB_KEYS,
        (*t_vocab.build_vocab(LINES, 1)[:2], *t_vocab.build_answer(LINES, 4), 4))))
    args = (data_file, str(tmp_path), voc.word2idx, voc.label2idx, voc.max_seq_length)
    a, b = t_dataset.VQASamples(*args), j_dataset.VQASamples(*args)
    assert a.image_names == b.image_names
    for name in ("questions", "ques_len", "labels"):
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), name


@pytest.mark.parametrize("epoch,skip", [(0, 0), (1, 0), (0, 2), (1, 2)])
def test_loader_batch_order_equal(data_file, tmp_path, epoch, skip):
    voc = dict(zip(t_vocab.VOCAB_KEYS, (*t_vocab.build_vocab(LINES, 1)[:2],
                                        *t_vocab.build_answer(LINES, 4), 5)))
    args = (data_file, str(tmp_path), voc["word2idx"], voc["label2idx"], 5)
    kw = dict(host_size=16, num_workers=2, seed=0, synthetic_images=True)
    port = t_pipeline.DataLoader(t_dataset.VQASamples(*args), 3, **kw)
    ref = j_pipeline.DataLoader(j_dataset.VQASamples(*args), 3, decode_backend="pil", **kw)
    try:
        for loader in (port, ref):
            loader.set_epoch(epoch, skip_batches=skip)
        for _ in range(2):      # the skip applies to the first pass only
            got, want = list(port), list(ref)
            assert len(got) == len(want) == 3 - skip * (_ == 0)
            for g, w in zip(got, want):
                assert set(g) == set(w)
                for k in w:
                    assert np.asarray(g[k]).tobytes() == np.asarray(w[k]).tobytes(), k
    finally:
        port.close()
    assert len(port) == len(ref) == 3


def test_loader_pins_images(data_file, tmp_path):
    """With ``pin_memory`` the image batch is a uint8 tensor (pinned when a
    card exists; here only its values are checked)."""
    voc = dict(zip(t_vocab.VOCAB_KEYS, (*t_vocab.build_vocab(LINES, 1)[:2],
                                        *t_vocab.build_answer(LINES, 4), 5)))
    samples = t_dataset.VQASamples(data_file, str(tmp_path), voc["word2idx"],
                                   voc["label2idx"], 5)
    kw = dict(host_size=16, num_workers=0, synthetic_images=True, shuffle=False)
    plain = t_pipeline.DataLoader(samples, 4, **kw)
    if not torch.cuda.is_available():
        batch = next(iter(plain))
        assert isinstance(batch["image"], np.ndarray)
        return
    pinned = t_pipeline.DataLoader(samples, 4, pin_memory=True, **kw)
    a, b = next(iter(plain)), next(iter(pinned))
    assert b["image"].is_pinned() and np.array_equal(b["image"].numpy(), a["image"])


def _port_sources():
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(os.path.join(REPO, "vqa_tpu_torch")):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return paths


def test_port_imports_nothing_of_vqa_tpu():
    pattern = re.compile(r"^\s*(from|import) vqa_tpu(\.|\s|$)")
    bad = []
    for path in _port_sources():
        with open(path) as f:
            bad += [f"{path}:{i}" for i, line in enumerate(f, 1) if pattern.match(line)]
    assert not bad, bad


def test_port_modules_import_no_jax():
    code = ("import sys; import vqa_tpu_torch.main, vqa_tpu_torch.serve, "
            "vqa_tpu_torch.data.images, vqa_tpu_torch.train.checkpoint; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'vqa_tpu')]; assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)


def test_synthetic_vocab_pickle_loads_in_both(tmp_path):
    """A pickle written by hand (as chip_smoke.py writes its vocab) loads
    into both packages' ``Vocab`` with the same fields."""
    vocab = {"word2idx": {"<PAD>": 0, "<UNKNOWN>": 1, "a": 2},
             "idx2word": {0: "<PAD>", 1: "<UNKNOWN>", 2: "a"},
             "label2idx": {"UNKNOWN": 0, "x": 1}, "idx2label": {0: "UNKNOWN", 1: "x"},
             "max_seq_length": 4}
    path = tmp_path / "v.pkl"
    path.write_bytes(pickle.dumps(vocab))
    assert t_vocab.Vocab.load(str(path)).__dict__ == j_vocab.Vocab.load(str(path)).__dict__
