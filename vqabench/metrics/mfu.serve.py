"""Percent of the chip's peaks that the whole step reaches: its operations from
the configuration's shapes at their peaks, over the step's wall time."""

from vqabench.metrics._readers import mfu as read  # noqa: F401
