"""Percent of the roofline that the grouped expert products reach: their least
time (operations at 989 TFLOP/s or bytes at 3.35 TB/s, the larger, at the
configuration's expected rows) over their device time."""

from vqabench.metrics._work_moe import expert_roofline as read  # noqa: F401
