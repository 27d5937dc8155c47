"""GiB of device memory allocated at most in the measured window."""

from vqabench.metrics._readers import peak_mem_gib as read  # noqa: F401
