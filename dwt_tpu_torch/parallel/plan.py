"""The run's sharding plan — the replica part of ``dwt_tpu.parallel.plan``.

One :class:`ShardingPlan` is the training loops' one authority on how a
step runs: ``single`` (one process, no collectives) or ``replica`` (the
``dp`` preset: every state tensor replicated, one process per rank over a
:class:`~dwt_tpu_torch.parallel.mesh.Mesh`, the step's collectives
explicit; ``dwt_tpu_torch.parallel.dp``).  It hands the model its group
(:attr:`ShardingPlan.step_axis_name`, the JAX name for what the port's
norm sites call ``group``, :attr:`ShardingPlan.group`), wraps the step factories, and decides the
dispatch: under gloo a chunk's steps run eagerly (:attr:`capture` False),
under NCCL the replica step is captured as a CUDA graph.

:func:`plan_from_flags` resolves the CLI surface (``--data_parallel``,
``--distributed``, ``--dcn_slices``, ``--mesh_shape``,
``--sharding_rules``) with the JAX package's decisions and error texts,
the group's size standing where JAX reads ``jax.device_count()``:

* ``--data_parallel`` on a one-rank group is ``single``, as JAX's is on
  one device; ``--data_parallel`` without ``--distributed`` on a host
  that shows more than one GPU raises (one process per device: nothing
  trains on one card of several by accident);
* the ``--pallas_whiten`` conflict, the dcn and mesh conflicts and the
  batch-divisibility errors are JAX's;
* a ``--mesh_shape`` must cover every rank of the group: a rank outside
  the mesh would train alone;
* a rules table other than ``dp`` (``model``, ``fsdp``, a rules file) is
  the ``gspmd`` mode, which is not ported (ROADMAP queue 1 item 8b): it
  raises, and never runs replicated in its place.
"""

from __future__ import annotations

import logging
from typing import Any, Callable, Optional, Tuple

import torch

from dwt_tpu_torch.parallel.mesh import Mesh, make_mesh, process_count

log = logging.getLogger(__name__)

_GSPMD = ("the gspmd mode (model-sharding rules tables on FSDP2/DTensor) "
          "is not ported (ROADMAP queue 1 item 8b)")


def parse_mesh_shape(text: str) -> Tuple[int, int, int]:
    """``"1,4,2"`` → ``(dcn, data, model)`` sizes; ``"4"`` → ``(1, 4, 1)``,
    ``"2,4"`` → ``(2, 4, 1)`` (JAX's parser)."""
    try:
        parts = [int(p) for p in str(text).split(",")]
    except ValueError:
        raise ValueError(
            f"--mesh_shape {text!r}: expected comma-separated ints "
            f"(dcn,data,model), e.g. 1,4,2"
        ) from None
    if not 1 <= len(parts) <= 3 or any(p < 1 for p in parts):
        raise ValueError(
            f"--mesh_shape {text!r}: need 1-3 positive sizes "
            f"(dcn,data,model)"
        )
    if len(parts) == 1:
        parts = [1, parts[0], 1]
    elif len(parts) == 2:
        parts = [parts[0], parts[1], 1]
    return tuple(parts)  # type: ignore[return-value]


class ShardingPlan:
    """``single`` (no mesh) or ``replica`` (a mesh of ranks)."""

    def __init__(self, mode: str, mesh: Optional[Mesh] = None):
        if mode not in ("single", "replica"):
            raise ValueError(f"unknown plan mode {mode!r} ({_GSPMD} for 'gspmd')")
        if (mode == "replica") != (mesh is not None):
            raise ValueError("a replica plan needs a mesh; a single plan has none")
        self.mode = mode
        self.mesh = mesh

    @classmethod
    def single(cls) -> "ShardingPlan":
        return cls("single")

    @classmethod
    def replica(cls, mesh: Mesh) -> "ShardingPlan":
        return cls("replica", mesh)

    @classmethod
    def from_mesh(cls, mesh: Optional[Mesh]) -> "ShardingPlan":
        return cls.single() if mesh is None else cls.replica(mesh)

    @property
    def group(self) -> Optional[Mesh]:
        """The group the model's norm sites and the steps reduce over (the
        mesh in replica mode, None in single): JAX's ``axis_name``."""
        return self.mesh

    step_axis_name = group

    @property
    def data_size(self) -> int:
        """The number of batch shards (1 in single mode)."""
        return 1 if self.mesh is None else self.mesh.size

    @property
    def capture(self) -> bool:
        """May a chunk's steps be captured as a CUDA graph?  Always in
        single mode; in replica mode when the mesh's collectives can be
        (NCCL)."""
        return self.mesh is None or self.mesh.capturable

    def describe(self) -> str:
        if self.mesh is None:
            return "single"
        return f"replica dp over {dict(self.mesh.shape)} ({self.mesh.backend})"

    def shard_batch(self, batch: Any, chunked: bool = False) -> Any:
        """This rank's slice of a host batch (identity in single mode)."""
        if self.mesh is None:
            return batch
        from dwt_tpu_torch.parallel import dp

        return dp.shard_batch(batch, self.mesh, chunked)

    def place_replicated(self, state):
        """Make every rank's state rank 0's (identity in single mode)."""
        if self.mesh is None:
            return state
        from dwt_tpu_torch.parallel import dp

        return dp.replicate_state(state, self.mesh)

    # ------------------------------------------------------ step factories

    def make_train_step(self, raw_step: Callable) -> Callable:
        if self.mesh is None:
            return raw_step
        from dwt_tpu_torch.parallel import dp

        return dp.make_sharded_train_step(raw_step, self.mesh)

    def make_scanned_step(self, raw_step: Callable, k: int) -> Callable:
        from dwt_tpu_torch.parallel import dp
        from dwt_tpu_torch.train.steps import make_scanned_step

        if self.mesh is None:
            return make_scanned_step(raw_step, k)
        return dp.make_sharded_scanned_step(raw_step, self.mesh, k)

    def make_eval_step(self, accum_eval: Callable) -> Callable:
        if self.mesh is None:
            return accum_eval
        from dwt_tpu_torch.parallel import dp

        return dp.make_sharded_eval_step(accum_eval, self.mesh)

    def make_collect_step(self, scanned_collect: Callable) -> Callable:
        if self.mesh is None:
            return scanned_collect
        from dwt_tpu_torch.parallel import dp

        return dp.make_sharded_collect_step(scanned_collect, self.mesh)


def _check_rules(sharding_rules: str, data_parallel: bool) -> None:
    if sharding_rules == "dp":
        return
    if data_parallel:
        raise ValueError(
            "--data_parallel conflicts with --sharding_rules "
            f"{sharding_rules!r}: the rules table owns placement on the "
            "gspmd path — drop --data_parallel (the table's data axis "
            "already shards the batch) or use the dp rules"
        )
    raise NotImplementedError(
        f"--sharding_rules {sharding_rules!r}: {_GSPMD}; the port runs the "
        "dp rules only")


def _local_gpus() -> int:
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def plan_from_flags(
    *,
    mesh_shape: Optional[str] = None,
    sharding_rules: str = "dp",
    data_parallel: bool = False,
    dcn_slices: int = 0,
    batch_size: Optional[int] = None,
    batch_size_flag: str = "--source_batch_size",
    pallas_whiten: bool = False,
    distributed: bool = False,
    world_size: Optional[int] = None,
    local_devices: Optional[int] = None,
) -> ShardingPlan:
    """Resolve the CLI surface into a plan (module docstring).
    ``world_size`` defaults to the process group's size (1 without one);
    ``local_devices`` to the GPUs this host shows (0 for a CPU run)."""
    sharding_rules = sharding_rules or "dp"
    dcn = int(dcn_slices or 0)
    world = process_count() if world_size is None else int(world_size)
    legacy = mesh_shape is None and sharding_rules == "dp"
    if pallas_whiten and (data_parallel or not legacy):
        raise ValueError(
            "--pallas_whiten is single-chip (no cross-replica moment "
            "pmean); drop it or the sharding flags"
        )
    if data_parallel and not distributed and world == 1:
        gpus = _local_gpus() if local_devices is None else int(local_devices)
        if gpus > 1:
            raise ValueError(
                f"--data_parallel without --distributed on a host with {gpus} "
                "GPUs: the port runs one process per device — launch one "
                "process per GPU with --distributed (torchrun, or the DWT_* "
                "variables); a single process would train on one of them")
    if legacy:
        if not data_parallel or world == 1:
            if dcn > 1:
                raise ValueError(
                    "--dcn_slices > 1 requires --data_parallel and more "
                    "than one device — the 2-D (dcn, data) mesh only "
                    "exists on the sharded path"
                )
            return ShardingPlan.single()
        if batch_size is not None and batch_size % world != 0:
            raise ValueError(
                f"--data_parallel shards the per-domain batch over "
                f"{world} devices, so {batch_size_flag} "
                f"must be divisible by it; got {batch_size}"
            )
        return ShardingPlan.replica(make_mesh(
            list(range(world)), dcn_slices=dcn if dcn > 1 else None))

    _check_rules(sharding_rules, data_parallel)
    shape = (1, world, 1) if mesh_shape is None else parse_mesh_shape(mesh_shape)
    if dcn > 1 and shape[0] != dcn:
        raise ValueError(
            f"--dcn_slices {dcn} conflicts with --mesh_shape dcn axis "
            f"{shape[0]}; pass the dcn size in --mesh_shape alone"
        )
    if shape[2] > 1:
        raise ValueError(
            "--sharding_rules dp replicates every state leaf; a model "
            f"axis of {shape[2]} would do nothing but waste chips — "
            "pass a model-sharding rules table (preset 'model', "
            "preset 'fsdp', or a rules file)"
        )
    need = shape[0] * shape[1]
    if need > world:
        raise ValueError(
            f"--mesh_shape {mesh_shape!r} needs {need} devices; only "
            f"{world} available"
        )
    if need < world:
        raise ValueError(
            f"--mesh_shape {mesh_shape!r} covers {need} ranks of the group's "
            f"{world}: every rank must be in the mesh (one outside it would "
            "train alone) — launch as many processes as the mesh has positions")
    plan = ShardingPlan.replica(make_mesh(
        list(range(need)), dcn_slices=shape[0] if shape[0] > 1 else None))
    if batch_size is not None and batch_size % plan.data_size != 0:
        raise ValueError(
            f"the plan shards the per-domain batch over {plan.data_size} "
            f"data-axis shards, so {batch_size_flag} must be divisible "
            f"by it; got {batch_size}"
        )
    return plan


def plan_from_config(cfg) -> ShardingPlan:
    """The training loops' entry: one plan from a Digits/OfficeHome
    config."""
    return plan_from_flags(
        mesh_shape=getattr(cfg, "mesh_shape", None),
        sharding_rules=getattr(cfg, "sharding_rules", "dp"),
        data_parallel=getattr(cfg, "data_parallel", False),
        dcn_slices=getattr(cfg, "dcn_slices", 0) or 0,
        batch_size=getattr(cfg, "source_batch_size", None),
        pallas_whiten=getattr(cfg, "pallas_whiten", False),
        distributed=getattr(cfg, "distributed", False),
        local_devices=0 if getattr(cfg, "device", "cuda") == "cpu" else None,
    )


def sharding_requested(cfg) -> bool:
    """Does this config ask for sharded execution?  (The multi-process
    data split's gate: without a sharded step there is no gradient sync.)"""
    return bool(
        getattr(cfg, "data_parallel", False)
        or getattr(cfg, "mesh_shape", None)
        or (getattr(cfg, "sharding_rules", "dp") or "dp") != "dp"
    )
