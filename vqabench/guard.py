"""The run-time check that no JAX, and nothing of the JAX package, is loaded.

Names are compared by their top-level part, whole: ``vqa_tpu_torch.serve``
is ``vqa_tpu_torch``, which is not ``vqa_tpu``.
"""

from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "vqa_tpu")


def forbidden_loaded(modules=None) -> list[str]:
    """The forbidden top-level names among ``modules`` (default: ``sys.modules``)."""
    names = sys.modules if modules is None else modules
    return sorted({name.split(".", 1)[0] for name in names} & set(FORBIDDEN))
