"""Question/answer vocabulary and the frozen pickle contract (the port's copy
of vqa_tpu/vocab.py).

The on-disk contract is byte-compatible with the reference (reference
utils.py:76-219) and with vqa_tpu: a pickle of
``{word2idx, idx2word, label2idx, idx2label, max_seq_length}`` where

- word ids are ``<PAD>``=0, ``<UNKNOWN>``=1, then words in order of first
  appearance in the training file that meet ``min_word_count``
  (utils.py:106-120);
- answer labels are the top-K most frequent answers (stable sort, ties broken
  by first appearance) with ``'UNKNOWN'`` prepended at index 0
  (utils.py:149-158);
- ``max_seq_length`` is the longest preprocessed question in the dataset
  (utils.py:101-103).
"""

from __future__ import annotations

import errno
import os
import pickle
from dataclasses import dataclass

from .text import preprocess_text

PAD_TOKEN = "<PAD>"
UNK_TOKEN = "<UNKNOWN>"
UNK_LABEL = "UNKNOWN"

VOCAB_KEYS = ("word2idx", "idx2word", "label2idx", "idx2label", "max_seq_length")


def build_vocab(data: list[str], min_word_count: int):
    """Build word->idx / idx->word maps + max sequence length from dataset lines.

    ``data`` is a list of ``img\\tquestion\\tanswer`` lines (reference
    utils.py:76-125: insertion-order ids, count threshold).
    """
    word_count: dict[str, int] = {}
    max_sequence_length = 0

    for sample in data:
        words = preprocess_text(sample.split("\t")[1].strip())
        for word in words:
            word_count[word] = word_count.get(word, 0) + 1
        max_sequence_length = max(max_sequence_length, len(words))

    word2idx = {PAD_TOKEN: 0, UNK_TOKEN: 1}
    idx = len(word2idx)
    for word, count in word_count.items():  # dict preserves first-appearance order
        if count >= min_word_count:
            word2idx[word] = idx
            idx += 1

    idx2word = {i: w for w, i in word2idx.items()}
    return word2idx, idx2word, max_sequence_length


def build_answer(data: list[str], K: int):
    """Top-K most-frequent answers with 'UNKNOWN' at index 0.

    Reference utils.py:128-159: ``sorted(..., reverse=True, key=count)`` is
    stable, so equal-count answers keep first-appearance order.
    """
    answer_frequency: dict[str, int] = {}
    for sample in data:
        answer = sample.split("\t")[2].strip()
        answer_frequency[answer] = answer_frequency.get(answer, 0) + 1

    top_k = sorted(answer_frequency.items(), reverse=True, key=lambda kv: kv[1])[:K]
    labels = [UNK_LABEL] + [ans for ans, _ in top_k]

    label2idx = {ans: i for i, ans in enumerate(labels)}
    idx2label = {i: ans for i, ans in enumerate(labels)}
    return label2idx, idx2label


def save_vocab(train_file: str, vocab_file_path: str, min_word_count: int, K: int) -> None:
    """Build the vocab from a training .txt file and pickle it (utils.py:162-198)."""
    with open(train_file, "r") as f:
        train_data = f.read().strip().split("\n")

    word2idx, idx2word, max_seq_length = build_vocab(train_data, min_word_count)
    label2idx, idx2label = build_answer(train_data, K)

    print(f"Vocab Size: {len(word2idx)} \nMax Sequence Length: {max_seq_length}\n")

    vocab = {
        "word2idx": word2idx,
        "idx2word": idx2word,
        "label2idx": label2idx,
        "idx2label": idx2label,
        "max_seq_length": max_seq_length,
    }
    with open(vocab_file_path, "wb") as handle:
        pickle.dump(vocab, handle, protocol=pickle.HIGHEST_PROTOCOL)
        print(f"Saving vocab data at {vocab_file_path}")


def load_vocab(vocab_file: str) -> dict:
    """Load a vocab pickle (reference- and vqa_tpu-written pickles load unchanged)."""
    if not os.path.exists(vocab_file):
        raise FileNotFoundError(errno.ENOENT, os.strerror(errno.ENOENT), vocab_file)
    with open(vocab_file, "rb") as handle:
        vocab = pickle.load(handle)
    print(f"Loading vocab data from {vocab_file}")
    print(f"Vocab data: {list(vocab.keys())}\n")
    return vocab


@dataclass(frozen=True)
class Vocab:
    """Typed view over the pickle-contract dict."""

    word2idx: dict
    idx2word: dict
    label2idx: dict
    idx2label: dict
    max_seq_length: int

    @classmethod
    def from_dict(cls, d: dict) -> "Vocab":
        return cls(**{k: d[k] for k in VOCAB_KEYS})

    @classmethod
    def load(cls, vocab_file: str) -> "Vocab":
        return cls.from_dict(load_vocab(vocab_file))

    @property
    def size(self) -> int:
        return len(self.word2idx)

    @property
    def num_labels(self) -> int:
        return len(self.label2idx)


def filter_samples_by_label(file_path: str, labels) -> list[str]:
    """Keep dataset lines whose answer is in ``labels`` (utils.py:223-249)."""
    labels = set(labels)
    with open(file_path, "r") as f:
        return [line for line in f if line.strip().split("\t")[2] in labels]
