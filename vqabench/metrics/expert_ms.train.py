"""Device ms a training step of the held experts' grouped products, forward
and backward: the kernels launched inside the program's span
vqa.model.experts (around the products' forward and their backward)."""

from vqabench.metrics._work_moe import expert_ms as read  # noqa: F401
