"""Multi-device training (port of vqa_tpu/parallel): process groups and
host sharding (``distributed``), the device mesh and data parallelism
(``mesh``), tensor parallelism and FSDP on the 2-D mesh (``sharding``)."""

from .mesh import DATA_AXIS, MODEL_AXIS, get_mesh, replicate_to_mesh, shard_batch

__all__ = ["DATA_AXIS", "MODEL_AXIS", "get_mesh", "shard_batch", "replicate_to_mesh"]
