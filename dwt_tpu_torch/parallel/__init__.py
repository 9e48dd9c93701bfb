"""dwt_tpu_torch.parallel — process groups, rank meshes, data parallelism and the sharding plan.

The port of ``dwt_tpu.parallel``: one process per rank over
``torch.distributed`` (:mod:`.mesh`), the replica mode's per-replica steps
with their collectives explicit (:mod:`.dp`: the norm sites' batch
moments, the gradients and the eval counters, each reduced over the mesh),
the run's :class:`ShardingPlan` with its rules tables (:mod:`.plan`), and
the gspmd mode's sharded state (:mod:`.gspmd`, over the JAX key paths of
:mod:`.paths`).  The server's fan-out over ranks (``serve.fanout``) reads
the plan's serving half: ``make_serve_forward``, ``place_serve``,
``serve_split``/``serve_join``, and the host collectives of
``mesh.RankGroup`` over ``mesh.host_group``.

Imports torch and numpy only.
"""

from dwt_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    DCN_AXIS,
    MODEL_AXIS,
    PLAN_AXES,
    Mesh,
    PlanMesh,
    RankGroup,
    choose_backend,
    cpu_group,
    dist_info,
    host_group,
    initialize_distributed,
    make_mesh,
    make_plan_mesh,
    process_count,
    process_index,
    shutdown_distributed,
)
from dwt_tpu_torch.parallel.dp import (
    make_sharded_collect_step,
    make_sharded_eval_step,
    make_sharded_scanned_step,
    make_sharded_serve_forward,
    make_sharded_train_step,
    replicate_state,
    shard_batch,
    slice_batch,
)
from dwt_tpu_torch.parallel.plan import (
    PRESETS,
    P,
    ShardingPlan,
    load_rules_file,
    match_partition_rules,
    parse_mesh_shape,
    plan_from_config,
    plan_from_flags,
    sharding_requested,
)

__all__ = [
    "DATA_AXIS",
    "DCN_AXIS",
    "MODEL_AXIS",
    "P",
    "PLAN_AXES",
    "PRESETS",
    "Mesh",
    "PlanMesh",
    "RankGroup",
    "ShardingPlan",
    "choose_backend",
    "cpu_group",
    "dist_info",
    "host_group",
    "initialize_distributed",
    "load_rules_file",
    "make_mesh",
    "make_plan_mesh",
    "make_sharded_collect_step",
    "make_sharded_eval_step",
    "make_sharded_scanned_step",
    "make_sharded_serve_forward",
    "make_sharded_train_step",
    "match_partition_rules",
    "parse_mesh_shape",
    "plan_from_config",
    "plan_from_flags",
    "process_count",
    "process_index",
    "replicate_state",
    "shard_batch",
    "sharding_requested",
    "slice_batch",
    "shutdown_distributed",
]
