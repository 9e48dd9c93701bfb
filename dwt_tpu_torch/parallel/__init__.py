"""dwt_tpu_torch.parallel — process groups, rank meshes and replica-mode data parallelism.

The port of ``dwt_tpu.parallel``'s replica mode: one process per rank over
``torch.distributed`` (:mod:`.mesh`), the per-replica steps with their
collectives explicit (:mod:`.dp`: the norm sites' batch moments, the
gradients and the eval counters, each reduced over the mesh), and the run's
:class:`ShardingPlan` (:mod:`.plan`).  The ``gspmd`` mode (model-sharding
rules tables), restore-to-spec and the server's replica fan-out wait for
ROADMAP queue 1 item 8b.

Imports torch and numpy only.
"""

from dwt_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    DCN_AXIS,
    Mesh,
    choose_backend,
    cpu_group,
    dist_info,
    initialize_distributed,
    make_mesh,
    process_count,
    process_index,
    shutdown_distributed,
)
from dwt_tpu_torch.parallel.dp import (
    make_sharded_collect_step,
    make_sharded_eval_step,
    make_sharded_scanned_step,
    make_sharded_train_step,
    replicate_state,
    shard_batch,
)
from dwt_tpu_torch.parallel.plan import (
    ShardingPlan,
    parse_mesh_shape,
    plan_from_config,
    plan_from_flags,
    sharding_requested,
)

__all__ = [
    "DATA_AXIS",
    "DCN_AXIS",
    "Mesh",
    "ShardingPlan",
    "choose_backend",
    "cpu_group",
    "dist_info",
    "initialize_distributed",
    "make_mesh",
    "make_sharded_collect_step",
    "make_sharded_eval_step",
    "make_sharded_scanned_step",
    "make_sharded_train_step",
    "parse_mesh_shape",
    "plan_from_config",
    "plan_from_flags",
    "process_count",
    "process_index",
    "replicate_state",
    "shard_batch",
    "sharding_requested",
    "shutdown_distributed",
]
