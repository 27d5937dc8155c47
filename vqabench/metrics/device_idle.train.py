"""Percent of a step's wall time in which the device ran nothing."""

from vqabench.metrics._readers import device_idle as read  # noqa: F401
