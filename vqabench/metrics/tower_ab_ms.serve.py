"""Device milliseconds a step of kernels A and B (the int8 tower), by kernel
name."""

from vqabench.metrics._readers import tower_ab_ms as read  # noqa: F401
