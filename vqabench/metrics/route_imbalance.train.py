"""The busiest held expert's rows over the held experts' mean, in the worst
expert layer (the program's counters vqa.model.expert_rows.<layer>)."""

from vqabench.metrics._work_moe import route_imbalance as read  # noqa: F401
