"""VQA dataset: parse the flat ``.txt`` contract and pre-tokenize everything
(the port's copy of vqa_tpu/data/dataset.py).

The whole file is tokenized once into dense int32 arrays (questions
[N, L], lengths [N], labels [N]), so per-step work is an array gather plus
image decode. Semantics are the reference's (reference dataloader.py:9-74):

- unknown words -> ``<UNKNOWN>`` id (dataloader.py:58)
- zero-pad to ``max_seq_length`` (dataloader.py:61)
- ``ques_len`` = count of non-zero ids (dataloader.py:65): post-mapping ids,
  so a word mapped to ``<UNKNOWN>`` (id 1) still counts
- unknown answers -> ``'UNKNOWN'`` label (dataloader.py:69)
"""

from __future__ import annotations

import os

import numpy as np

from ..text import pad_sequences, preprocess_text
from ..vocab import UNK_LABEL, UNK_TOKEN


class VQASamples:
    """All (image_name, question_ids, ques_len, label) tuples of a dataset file."""

    def __init__(self, data_file: str, img_dir: str, word2idx: dict, label2idx: dict,
                 max_seq_length: int):
        self.data_file = data_file
        self.img_dir = img_dir
        self.max_seq_length = int(max_seq_length)

        with open(data_file, "r") as f:
            lines = f.read().strip().split("\n")

        n = len(lines)
        unk = word2idx[UNK_TOKEN]
        unk_label = label2idx[UNK_LABEL]

        self.image_names: list[str] = [""] * n
        self.questions = np.zeros((n, self.max_seq_length), np.int32)
        self.ques_len = np.zeros((n,), np.int32)
        self.labels = np.zeros((n,), np.int32)

        for i, line in enumerate(lines):
            img_name, question, answer = line.strip().split("\t")
            self.image_names[i] = img_name
            ids = [word2idx.get(w, unk) for w in preprocess_text(question)]
            padded = pad_sequences(ids, self.max_seq_length)
            self.questions[i] = padded
            self.ques_len[i] = int(np.count_nonzero(padded))
            self.labels[i] = label2idx.get(answer, unk_label)

    def __len__(self) -> int:
        return len(self.image_names)

    def image_path(self, idx: int) -> str:
        return os.path.join(self.img_dir, self.image_names[idx])
