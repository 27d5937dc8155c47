"""Utility surface: text/vocab helpers, logging, plotting, flag coercers
(port of vqa_tpu/utils/__init__.py).

One import for the reference's ``utils.py`` public names (SURVEY.md P10-P13,
P16-P18), on top of the port's own modules.
"""

from ..config import int_min_two, str2bool
from ..text import pad_sequences, preprocess_text
from ..train.logging import print_and_log
from ..vocab import build_answer, build_vocab, filter_samples_by_label, load_vocab, save_vocab
from .plotting import plot_data

__all__ = [
    "preprocess_text", "pad_sequences", "build_vocab", "build_answer",
    "save_vocab", "load_vocab", "filter_samples_by_label", "plot_data",
    "print_and_log", "str2bool", "int_min_two", "sort_batch",
]


def sort_batch(images, questions, answers, ques_seq_lens):
    """Sort a batch descending by question length (reference utils.py:33-45).

    API compatibility only: the port's masked recurrences need no sorted
    batch, and loss and accuracy do not depend on the order. Takes numpy
    arrays or CPU tensors and returns numpy arrays (a stable sort: equal
    lengths keep their order).
    """
    import numpy as np

    order = np.argsort(-np.asarray(ques_seq_lens), kind="stable")
    return (np.asarray(images)[order], np.asarray(questions)[order],
            np.asarray(answers)[order], np.asarray(ques_seq_lens)[order])
