"""Per-layer metrics: one reader a metric, ``<metric name>.py``, found by name.

A reader's ``read(ctx)`` takes the traced part of a run (``vqabench.tracing.
TraceContext``) and returns the metric's value, or None when the run holds
nothing for it to read. The arithmetic they share is frozen here
(``_trace``, ``_work``, ``_readers``).
"""
