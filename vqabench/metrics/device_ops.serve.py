"""Device kernels, copies and memsets a step (a count: it repeats exactly)."""

from vqabench.metrics._readers import device_ops as read  # noqa: F401
