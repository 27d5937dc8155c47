"""Milliseconds of host time a train_step call takes to return (host span
vqabench.train_step): its dispatch, without a synchronise."""

from vqabench.metrics._readers import step_host_ms as read  # noqa: F401
