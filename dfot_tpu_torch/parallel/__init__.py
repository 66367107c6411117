"""Multi-process runs: the process group and the mesh (``dfot_tpu/parallel``)."""

from .mesh import make_mesh, param_sharding_rule, shard_batch, shard_model
from .multihost import (
    barrier,
    broadcast_from_zero,
    gather_for_metrics,
    initialize,
    is_rank_zero,
    rank_zero_print,
)
