"""The inputs of a run, all made from its seed: images, questions, labels and
the vocabulary they are drawn from.

- Images: uint8 [B, S, S, 3], made on the device (smooth noise at a
  sixteenth of the size, bilinearly upsampled, plus pixel noise) and copied
  into pinned host memory, as a loader that decoded them would hold them.
- Question lengths: every batch holds the same multiset of lengths, the
  traffic file's distribution cut to the batch by largest remainders, with
  at least one question of the longest length; the seed only orders them.
  Words are drawn uniformly from the vocabulary.
- Questions as text: the dataset's form, comma-separated lowercase tokens
  with a question mark, which the port's tokenizer maps back to the ids.
- Labels: uniform over the answer classes.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

PAD, UNKNOWN, UNKNOWN_LABEL = "<PAD>", "<UNKNOWN>", "UNKNOWN"
_LETTERS = "abcdefghijklmnopqrstuvwxyz"


def subseed(seed: int, *tags: int) -> int:
    """A 63-bit seed for one stream of the run, from the run's seed and tags."""
    words = np.random.SeedSequence([abs(int(seed)) % 2 ** 64, *tags]).generate_state(2)
    return int((int(words[0]) << 31) ^ int(words[1])) & (2 ** 63 - 1)


def word(i: int) -> str:
    """The word of id ``i`` (>= 2): "w" and ``i`` in base 26 ("wa", "wb", ...)."""
    out = ""
    while True:
        i, r = divmod(i, 26)
        out = _LETTERS[r] + out
        if i == 0:
            return "w" + out


def vocab_dict(cfg: dict) -> dict:
    """The vocabulary in the dataset's pickle form: ids 0 and 1 are the pad
    and unknown tokens, answer 0 is UNKNOWN."""
    words = [PAD, UNKNOWN] + [word(i) for i in range(2, cfg["vocab_size"])]
    labels = [UNKNOWN_LABEL] + [f"answer{i}" for i in range(1, cfg["num_classes"])]
    return {"word2idx": {w: i for i, w in enumerate(words)},
            "idx2word": dict(enumerate(words)),
            "label2idx": {a: i for i, a in enumerate(labels)},
            "idx2label": dict(enumerate(labels)),
            "max_seq_length": cfg["max_seq_length"]}


def length_multiset(traffic: dict, batch: int) -> np.ndarray:
    """The question lengths of every batch, sorted."""
    dist = traffic["question_lengths"]
    lengths = np.arange(dist["min"], dist["min"] + len(dist["weights"]))
    w = np.asarray(dist["weights"], np.float64)
    quota = w / w.sum() * batch
    counts = np.floor(quota).astype(np.int64)
    counts[np.argsort(-(quota - counts), kind="stable")[:batch - counts.sum()]] += 1
    if counts[-1] == 0:                       # the longest length is always served
        counts[np.argmax(counts)] -= 1
        counts[-1] = 1
    return np.repeat(lengths, counts)


def questions(cfg: dict, traffic: dict, seed: int, tag: int, count: int, batch: int):
    """``count`` batches of questions: ids int32 [count, B, L] (0 pads) and
    lengths int32 [count, B]."""
    rng = np.random.default_rng(subseed(seed, tag))
    lengths = length_multiset(traffic, batch)
    seq = cfg["max_seq_length"]
    ids = np.zeros((count, batch, seq), np.int32)
    lens = np.zeros((count, batch), np.int32)
    for c in range(count):
        lens[c] = rng.permutation(lengths)
        draw = rng.integers(2, cfg["vocab_size"], (batch, seq), dtype=np.int32)
        ids[c] = np.where(np.arange(seq)[None, :] < lens[c][:, None], draw, 0)
    return ids, lens


def question_text(ids: np.ndarray, lens: np.ndarray) -> list[str]:
    """One batch's questions as the dataset writes them."""
    return [",".join(word(int(t)) for t in row[:n]) + "?" for row, n in zip(ids, lens)]


def labels(cfg: dict, seed: int, tag: int, count: int, batch: int) -> np.ndarray:
    rng = np.random.default_rng(subseed(seed, tag))
    return rng.integers(0, cfg["num_classes"], (count, batch), dtype=np.int32)


def image_ring(seed: int, tag: int, count: int, batch: int, size: int, device) -> list:
    """``count`` batches of uint8 [B, S, S, 3] images, pinned on the host when
    the device is a card."""
    device = torch.device(device)
    g = torch.Generator(device=device).manual_seed(subseed(seed, tag))
    ring = []
    for _ in range(count):
        low = torch.rand((batch, 3, max(size // 16, 1), max(size // 16, 1)), generator=g,
                         device=device)
        x = F.interpolate(low, size=(size, size), mode="bilinear", align_corners=False)
        x = x * 200.0 + 28.0 + 12.0 * torch.randn((batch, 3, size, size), generator=g,
                                                  device=device)
        img = torch.round(x).clamp_(0, 255).to(torch.uint8).permute(0, 2, 3, 1)
        host = torch.empty(img.shape, dtype=torch.uint8, pin_memory=device.type == "cuda")
        host.copy_(img)
        ring.append(host)
    return ring
