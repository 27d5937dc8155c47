"""Text preprocessing for VQA questions (the port's copy of vqa_tpu/text.py).

Behaviour-parity with the reference's text pipeline (reference utils.py:
18-73): comma-separated token strings are re-joined on spaces, punctuation
is stripped, empty strings and the literal (pre-lowercase) token ``'s'``
are dropped, and survivors are lowercased.

Quirk reproduced deliberately: the reference filters ``word != 's'``
*before* lowercasing, so an uppercase ``'S'`` token survives and is emitted
as ``'s'`` (utils.py:71). Kept for vocab/token parity.
"""

from __future__ import annotations

import string

import numpy as np

_PUNCT_TABLE = str.maketrans("", "", string.punctuation)


def preprocess_text(text: str) -> list[str]:
    """Tokenize a comma-separated question string into lowercase words.

    >>> preprocess_text('Man sleeping next to a cat on a bed.')
    ['man', 'sleeping', 'next', 'to', 'a', 'cat', 'on', 'a', 'bed']
    >>> preprocess_text("What's,on,the,table?")  # apostrophe stripped in-word
    ['whats', 'on', 'the', 'table']
    """
    # comma-separated tokens -> space-joined sentence (reference utils.py:62-63)
    joined = " ".join(text.strip().split(","))
    words = [w.translate(_PUNCT_TABLE) for w in joined.strip().split()]
    # case-sensitive drop of '' and 's' BEFORE lowercase (reference utils.py:71)
    return [w.lower() for w in words if w != "" and w != "s"]


def pad_sequences(seq, max_len: int, dtype=np.int32) -> np.ndarray:
    """Zero-pad (or truncate) a token-id list to ``max_len``.

    Same semantics as reference utils.py:18-30; int32 as in vqa_tpu (the
    values are vocab ids, far below 2**31).
    """
    padded = np.zeros((max_len,), dtype)
    n = min(len(seq), max_len)
    padded[:n] = seq[:n]
    return padded
