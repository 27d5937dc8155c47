"""Milliseconds of the serving engine's question encoding a batch (host span
vqabench.encode)."""

from vqabench.metrics._readers import encode_ms as read  # noqa: F401
