"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

Importing the package registers the kernels as PyTorch operators
(:mod:`.library`)."""

from . import library  # noqa: F401
