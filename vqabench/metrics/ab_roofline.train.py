"""Percent of the roofline that kernels A and B reach: their least time from
the VGG's shapes over their device time."""

from vqabench.metrics._readers import ab_roofline as read  # noqa: F401
