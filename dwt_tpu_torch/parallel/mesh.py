"""Process groups and rank meshes — the port of ``dwt_tpu.parallel.mesh``.

The JAX package's mesh is a grid of devices that one program spans; the
port runs one process per rank (``torch.distributed``), and its mesh is
the grid of those ranks (:class:`Mesh` for the replica mode, :class:`PlanMesh`
for the gspmd mode).  :func:`initialize_distributed` joins the
process group: its address, size and this process's rank come from the
JAX package's variables ``DWT_COORDINATOR_ADDRESS``, ``DWT_NUM_PROCESSES``
and ``DWT_PROCESS_ID``, or, where those are absent, from torchrun's
``MASTER_ADDR``/``MASTER_PORT``/``RANK``/``WORLD_SIZE`` (``LOCAL_RANK``,
``LOCAL_WORLD_SIZE``), as JAX auto-detects a pod.

**The backend follows from the topology, never from a failure**
(:func:`choose_backend`): gloo on the CPU and wherever two ranks of a
host share a device, NCCL where every rank owns its own device.  A rank's
device is ``cuda:(local_rank % device_count)``.  Under NCCL the group also
gets a gloo group over the same ranks (:func:`cpu_group`), which the
step-boundary consensus uses, so that a boundary decision never waits on
the card.  A rank that cannot join the group raises; nothing trains alone.

:class:`Mesh` is a 1-D ``(data,)`` or slice-major 2-D ``(dcn, data)``
grid of ranks.  Its collectives reduce over every axis — within a slice
over ``data``, then across slices over ``dcn`` — which is what the JAX
package's two-axis ``pmean``/``psum`` lowers to.  :meth:`Mesh.psum` is
differentiable (``torch.distributed.nn.functional.all_reduce``: its
backward is the all-reduce of the gradients), so a plain op written with
it has the global batch's gradient, as JAX's does under ``shard_map``.

:class:`PlanMesh` is the gspmd mode's slice-major ``(dcn, data, model)``
grid (:func:`make_plan_mesh`, ``dwt_tpu.parallel.plan.make_plan_mesh``'s
device order: rank ``r`` at position ``unravel(r)``, ``model`` innermost).
Its reductions run over rank groups (:class:`RankGroup`): one line of each axis, the
**data group** (the ranks that share a ``model`` index: the batch's
shards) and the **model group** (the ranks that share a ``(dcn, data)``
position: one batch shard, the blocks of every sharded tensor).  A rank's
batch shard is its **batch position**, its index among the ``(dcn,
data)`` positions — never its index in the whole grid, which would give
each model rank a batch slice of its own.

:func:`host_group` is every rank over the gloo group, whose
:class:`RankGroup` methods move host objects and tensors between the
first rank and the others (broadcast, scatter, gather): the serving
fan-out's wire (``dwt_tpu_torch.serve.fanout``).
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import warnings
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

# Axis names of the JAX package's meshes; the plan mesh's third axis is
# model (tensor) parallelism, which batches never shard over.
DATA_AXIS = "data"
DCN_AXIS = "dcn"
MODEL_AXIS = "model"
PLAN_AXES = (DCN_AXIS, DATA_AXIS, MODEL_AXIS)

# Seconds a collective may wait before it fails the run (a hang is an error,
# not a stall): DWT_DIST_TIMEOUT_S overrides it.
DEFAULT_TIMEOUT_S = 600.0


@dataclasses.dataclass(frozen=True)
class DistInfo:
    """What :func:`initialize_distributed` set up: the backend, this rank
    and the group's size, this process's device and every rank's device
    (``devices[r]``, gathered once at start)."""

    backend: str
    rank: int
    world_size: int
    local_rank: int
    local_world_size: int
    device: str
    devices: List[str]


_INFO: Optional[DistInfo] = None
_CPU_GROUP = None


def process_index() -> int:
    """This process's rank (0 without a group) — ``jax.process_index``."""
    return _INFO.rank if _INFO is not None else 0


def process_count() -> int:
    """The group's size (1 without a group) — ``jax.process_count``."""
    return _INFO.world_size if _INFO is not None else 1


def dist_info() -> Optional[DistInfo]:
    return _INFO


def cpu_group():
    """A gloo group over every rank, for collectives of host values (the
    consensus flags); None without a group."""
    return _CPU_GROUP


def choose_backend(device_type: str, local_world_size: int,
                   device_count: int) -> str:
    """gloo on the CPU and where ranks of one host share a device; NCCL
    where each rank of the host owns a device of its own."""
    if device_type != "cuda" or device_count < local_world_size:
        return "gloo"
    return "nccl"


def rank_device(device_type: str, local_rank: int, device_count: int) -> str:
    """``cuda:(local_rank % device_count)``, or ``cpu``."""
    if device_type != "cuda":
        return "cpu"
    if device_count < 1:
        raise RuntimeError("--distributed on CUDA: no CUDA device is visible")
    return f"cuda:{local_rank % device_count}"


def _timeout() -> datetime.timedelta:
    return datetime.timedelta(
        seconds=float(os.environ.get("DWT_DIST_TIMEOUT_S", DEFAULT_TIMEOUT_S)))


def _int_env(name: str) -> Optional[int]:
    value = os.environ.get(name)
    try:
        return int(value) if value else None
    except ValueError:
        raise RuntimeError(f"--distributed: {name}={value!r} is not an integer") from None


def cluster_from_env():
    """``(address, world_size, rank, local_rank, local_world_size,
    explicit)`` from the DWT_* variables, else torchrun's; None where
    neither names a cluster.  ``explicit`` is True for DWT_*."""
    coordinator = os.environ.get("DWT_COORDINATOR_ADDRESS")
    num = _int_env("DWT_NUM_PROCESSES")
    pid = _int_env("DWT_PROCESS_ID")
    if coordinator or num is not None or pid is not None:
        local = _int_env("LOCAL_RANK")
        return coordinator, num, pid, (pid if local is None else local), \
            _int_env("LOCAL_WORLD_SIZE") or num, True
    if os.environ.get("MASTER_ADDR") and os.environ.get("WORLD_SIZE"):
        rank = _int_env("RANK")
        world = _int_env("WORLD_SIZE")
        local = _int_env("LOCAL_RANK")
        address = f"{os.environ['MASTER_ADDR']}:{os.environ.get('MASTER_PORT', '29500')}"
        return address, world, rank, (rank if local is None else local), \
            _int_env("LOCAL_WORLD_SIZE") or world, False
    return None


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    device: str = "cuda",
) -> DistInfo:
    """Join the process group (``torch.distributed.init_process_group``
    over ``tcp://<coordinator_address>``) and return its :class:`DistInfo`.

    Arguments left None come from the environment (module docstring), as
    do the host's local rank and size (``LOCAL_RANK``,
    ``LOCAL_WORLD_SIZE``; by default the rank and the group's size: one
    host).
    ``device`` is the run's device type: ``cpu`` takes gloo, ``cuda`` the
    backend :func:`choose_backend` picks for this host.  Call once per
    process, before any collective; a second call returns the first's
    info."""
    global _INFO, _CPU_GROUP
    import torch.distributed as dist

    if _INFO is not None:
        return _INFO
    env = cluster_from_env()
    local_rank = local_world_size = None
    if env is not None:
        address, world, rank, local_rank, local_world_size, _ = env
        coordinator_address = coordinator_address or address
        num_processes = num_processes if num_processes is not None else world
        process_id = process_id if process_id is not None else rank
    if not coordinator_address or num_processes is None or process_id is None:
        raise ValueError(
            "no cluster to join: pass the coordinator address, the number "
            "of processes and this process's id, or set them in the "
            "environment")
    if not 0 <= int(process_id) < int(num_processes):
        raise ValueError(f"process id {process_id} is outside 0..{int(num_processes) - 1}")
    local_rank = int(process_id if local_rank is None else local_rank)
    local_world_size = int(num_processes if local_world_size is None else local_world_size)
    dtype = torch.device(device).type
    count = torch.cuda.device_count() if dtype == "cuda" else 0
    backend = choose_backend(dtype, local_world_size, count)
    mine = rank_device(dtype, local_rank, count)
    if dtype == "cuda":
        torch.cuda.set_device(torch.device(mine))
    dist.init_process_group(
        backend=backend, init_method=f"tcp://{coordinator_address}",
        world_size=int(num_processes), rank=int(process_id), timeout=_timeout())
    _CPU_GROUP = (dist.group.WORLD if backend == "gloo"
                  else dist.new_group(backend="gloo", timeout=_timeout()))
    devices: List[Optional[str]] = [None] * int(num_processes)
    dist.all_gather_object(devices, mine, group=_CPU_GROUP)
    _INFO = DistInfo(backend=backend, rank=int(process_id),
                     world_size=int(num_processes), local_rank=local_rank,
                     local_world_size=local_world_size, device=mine,
                     devices=[str(d) for d in devices])
    return _INFO


def join_from_flags(distributed: bool, device: str) -> Optional[DistInfo]:
    """The CLIs' ``--distributed``: join the process group from the DWT_*
    variables or torchrun's and return its :class:`DistInfo`; None
    without the flag (one process).  A failure names what to set."""
    if not distributed:
        return None
    if _INFO is not None:
        return _INFO
    env = cluster_from_env()
    explicit = env is not None and env[-1]
    try:
        if env is None:
            raise ValueError("no DWT_* or torchrun variables are set")
        return initialize_distributed(device=device)
    except (ValueError, RuntimeError) as e:
        if explicit:
            detail = ("explicit DWT_* configuration failed — check that all three "
                      "of DWT_COORDINATOR_ADDRESS, DWT_NUM_PROCESSES, and "
                      "DWT_PROCESS_ID are set and the coordinator is reachable.")
        else:
            detail = ("could not auto-detect the cluster (torchrun's MASTER_ADDR, "
                      "MASTER_PORT, RANK and WORLD_SIZE are read when it launches "
                      "every process). For bare-metal, set "
                      "DWT_COORDINATOR_ADDRESS, DWT_NUM_PROCESSES, and "
                      "DWT_PROCESS_ID; or drop --distributed for single-host runs.")
        raise RuntimeError(f"--distributed: {detail} Underlying error: {e}") from e


def shutdown_distributed() -> None:
    """Leave the process group (a no-op without one)."""
    global _INFO, _CPU_GROUP
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    _INFO = _CPU_GROUP = None


class Mesh:
    """A grid of ranks with named axes: ``(data,)`` or ``(dcn, data)``.

    ``ranks`` is the grid (a numpy int array); a rank's batch shard is its
    position in the flattened grid (:attr:`index`), the block that the
    JAX package's ``P(("dcn", "data"))`` gives the device at that
    position.  Inside a process group the mesh makes one subgroup per
    row and column of a 2-D grid (every rank takes part in every
    ``new_group`` call, in one order); outside one it only describes the
    layout and its collectives raise."""

    def __init__(self, ranks: np.ndarray, axis_names: Sequence[str]):
        self.ranks = np.asarray(ranks, dtype=np.int64)
        self.axis_names = tuple(axis_names)
        if self.ranks.ndim != len(self.axis_names):
            raise ValueError(f"rank grid {self.ranks.shape} vs axes {self.axis_names}")
        self.shape: Dict[str, int] = dict(zip(self.axis_names, self.ranks.shape))
        self.size = int(self.ranks.size)
        self.backend = _INFO.backend if _INFO is not None else None
        self._axis_groups: List = []
        if _INFO is not None:
            self._make_groups()

    def _make_groups(self) -> None:
        import torch.distributed as dist

        world = sorted(int(r) for r in self.ranks.reshape(-1))
        if world != list(range(process_count())):
            raise ValueError(
                f"mesh ranks {world} must be every rank of the group "
                f"(0..{process_count() - 1}): a rank outside the mesh would "
                "train alone")
        if self.ranks.ndim == 1:
            self._axis_groups = [dist.group.WORLD]
            return
        mine = process_index()
        # The data axis first (within a slice), then dcn (across slices).
        for axis in (1, 0):
            lines = np.moveaxis(self.ranks, axis, -1).reshape(-1, self.ranks.shape[axis])
            for line in lines:
                group = dist.new_group([int(r) for r in line], timeout=_timeout())
                if mine in line:
                    self._axis_groups.append(group)

    @property
    def index(self) -> int:
        """This rank's position in the flattened grid (its batch shard)."""
        flat = [int(r) for r in self.ranks.reshape(-1)]
        return flat.index(process_index())

    @property
    def capturable(self) -> bool:
        """Can a step with this mesh's collectives be captured as a CUDA
        graph?  NCCL's can; gloo stages through the host and cannot."""
        return self.backend == "nccl"

    def _groups(self):
        if not self._axis_groups:
            raise RuntimeError("this mesh has no process group (describe-only)")
        return self._axis_groups

    def psum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over every rank, differentiable: the backward
        all-reduces the incoming gradient the same way."""
        from torch.distributed.nn.functional import all_reduce

        for group in self._groups():
            with warnings.catch_warnings():
                # Its deprecation names a replacement whose backward is not
                # the all-reduce of the gradient; this one's is.
                warnings.filterwarnings("ignore", category=FutureWarning,
                                        message=".*all_reduce is deprecated")
                t = all_reduce(t, group=group)
        return t

    def psum_(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over every rank, in place, outside autograd."""
        import torch.distributed as dist

        for group in self._groups():
            dist.all_reduce(t, group=group)
        return t

    def broadcast_(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` of the grid's first rank, in place."""
        import torch.distributed as dist

        dist.broadcast(t, src=int(self.ranks.reshape(-1)[0]))
        return t

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, backend={self.backend})"


def make_mesh(ranks: Optional[Sequence[int]] = None,
              dcn_slices: Optional[int] = None) -> Mesh:
    """The data-parallel mesh over ``ranks`` (default: every rank of the
    group): 1-D ``(data,)``, or with ``dcn_slices = S > 1`` the slice-major
    ``(dcn, data)`` grid ``[S, n / S]``."""
    ranks = list(range(process_count()) if ranks is None else ranks)
    if dcn_slices and dcn_slices > 1:
        n = len(ranks)
        if n % dcn_slices:
            raise ValueError(f"{n} devices cannot split into {dcn_slices} equal slices")
        return Mesh(np.asarray(ranks).reshape(dcn_slices, n // dcn_slices),
                    (DCN_AXIS, DATA_AXIS))
    return Mesh(np.asarray(ranks), (DATA_AXIS,))


class RankGroup:
    """Ranks that reduce together over one process group, in the order of
    their coordinate along the grid: a line of a :class:`PlanMesh` axis,
    its data group or its model group.  A group of one rank needs no
    process group (its collectives are identities); a group of more built
    outside a process group only describes the layout, and its collectives
    raise.  The norm sites and the steps read ``size``, ``psum`` and
    ``psum_``, as they read a :class:`Mesh`'s."""

    def __init__(self, ranks: Sequence[int], group=None, backend: Optional[str] = None):
        self.ranks = tuple(int(r) for r in ranks)
        self.size = len(self.ranks)
        self.backend = backend
        self._group = group

    def _pg(self):
        if self._group is None:
            raise RuntimeError(f"rank group {self.ranks} has no process group (describe-only)")
        return self._group

    def psum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the group, differentiable (:meth:`Mesh.psum`)."""
        if self.size == 1:
            return t
        from torch.distributed.nn.functional import all_reduce

        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", category=FutureWarning,
                                    message=".*all_reduce is deprecated")
            return all_reduce(t, group=self._pg())

    def psum_(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the group, in place, outside autograd."""
        if self.size > 1:
            import torch.distributed as dist

            dist.all_reduce(t, group=self._pg())
        return t

    def all_gather(self, t: torch.Tensor) -> List[torch.Tensor]:
        """Every rank's ``t`` (one shape on all), in the group's order."""
        if self.size == 1:
            return [t]
        import torch.distributed as dist

        t = t.contiguous()
        out = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(out, t, group=self._pg())
        return out

    def broadcast_(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` of the group's first rank, in place."""
        if self.size > 1:
            import torch.distributed as dist

            dist.broadcast(t, src=self.ranks[0], group=self._pg())
        return t

    # Host values between the group's first rank and the others: the
    # serving fan-out's wire (``serve.fanout``), on a gloo group.

    def broadcast_object(self, obj: Any = None) -> Any:
        """The first rank's picklable ``obj``, on every rank."""
        if self.size == 1:
            return obj
        import torch.distributed as dist

        box = [obj]
        dist.broadcast_object_list(box, src=self.ranks[0], group=self._pg())
        return box[0]

    def gather_object(self, obj: Any) -> Optional[List[Any]]:
        """Every rank's picklable ``obj`` in the group's order on the first
        rank; None on the others."""
        if self.size == 1:
            return [obj]
        import torch.distributed as dist

        first = process_index() == self.ranks[0]
        out = [None] * self.size if first else None
        dist.gather_object(obj, out, dst=self.ranks[0], group=self._pg())
        return out

    def scatter_host(self, chunks: Optional[Sequence[torch.Tensor]], shape: Sequence[int],
                     dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """This rank's host tensor of ``shape`` from the first rank's
        ``chunks`` (one per rank, in the group's order; None elsewhere)."""
        if self.size == 1:
            return chunks[0]
        import torch.distributed as dist

        out = torch.empty(tuple(shape), dtype=dtype)
        first = process_index() == self.ranks[0]
        dist.scatter(out, [c.contiguous() for c in chunks] if first else None,
                     src=self.ranks[0], group=self._pg())
        return out

    def gather_host(self, t: torch.Tensor) -> Optional[List[torch.Tensor]]:
        """Every rank's host tensor ``t`` (one shape on all) in the group's
        order on the first rank; None on the others."""
        if self.size == 1:
            return [t]
        import torch.distributed as dist

        t = t.contiguous()
        first = process_index() == self.ranks[0]
        out = [torch.empty_like(t) for _ in range(self.size)] if first else None
        dist.gather(t, out, dst=self.ranks[0], group=self._pg())
        return out

    def __repr__(self) -> str:
        return f"RankGroup({list(self.ranks)})"


def host_group() -> RankGroup:
    """Every rank of the process group over its gloo group (:func:`cpu_group`),
    for host tensors and objects; a one-rank group without a process group."""
    if _INFO is None:
        return RankGroup([0])
    return RankGroup(range(_INFO.world_size), _CPU_GROUP, "gloo")


class PlanMesh:
    """The gspmd mode's ``(dcn, data, model)`` grid of ranks (module
    docstring).  Inside a process group it makes one subgroup for each
    line of each axis and one data group for each ``model`` index, every
    rank calling ``new_group`` for every one of them in one order; outside
    one it only describes the layout."""

    axis_names = PLAN_AXES

    def __init__(self, ranks: np.ndarray):
        self.ranks = np.asarray(ranks, dtype=np.int64)
        if self.ranks.ndim != 3:
            raise ValueError(f"a plan mesh is a 3-D rank grid, got {self.ranks.shape}")
        self.shape: Dict[str, int] = dict(zip(PLAN_AXES, self.ranks.shape))
        self.size = int(self.ranks.size)
        self.backend = _INFO.backend if _INFO is not None else None
        mine = process_index()
        flat = [int(r) for r in self.ranks.reshape(-1)]
        self.coords = tuple(int(c) for c in np.unravel_index(
            flat.index(mine) if mine in flat else 0, self.ranks.shape))
        self._lines: Dict[str, RankGroup] = {}
        self.data_group = self.world_group = None
        self._make_groups()

    def _line_ranks(self, axis: int) -> List[int]:
        sl = list(self.coords)
        sl[axis] = slice(None)
        return [int(r) for r in self.ranks[tuple(sl)]]

    def _make_groups(self) -> None:
        live = _INFO is not None
        if live:
            import torch.distributed as dist

            world = sorted(int(r) for r in self.ranks.reshape(-1))
            if world != list(range(process_count())):
                raise ValueError(
                    f"mesh ranks {world} must be every rank of the group "
                    f"(0..{process_count() - 1}): a rank outside the mesh would "
                    "train alone")
        mine = process_index()

        def group(ranks: List[int]):
            if not live or len(ranks) == 1:
                return None
            if len(ranks) == process_count():
                return dist.group.WORLD
            return dist.new_group(ranks, timeout=_timeout())

        for axis, name in enumerate(PLAN_AXES):
            lines = np.moveaxis(self.ranks, axis, -1).reshape(-1, self.ranks.shape[axis])
            for line in lines:
                ranks = [int(r) for r in line]
                g = group(ranks)
                if mine in ranks or not live:
                    self._lines.setdefault(name, RankGroup(
                        self._line_ranks(axis), g, self.backend))
        model = self.shape[MODEL_AXIS]
        for m in range(model):
            ranks = [int(r) for r in self.ranks[:, :, m].reshape(-1)]
            g = group(ranks)
            if m == self.coords[2]:
                self.data_group = RankGroup(ranks, g, self.backend)
        all_ranks = [int(r) for r in self.ranks.reshape(-1)]
        self.world_group = RankGroup(all_ranks, group(all_ranks), self.backend)

    def line(self, axis: str) -> RankGroup:
        """This rank's line along ``axis``: the ranks that differ from it
        in that coordinate alone, in coordinate order."""
        return self._lines[axis]

    @property
    def model_group(self) -> RankGroup:
        """The ranks that share this rank's ``(dcn, data)`` position."""
        return self._lines[MODEL_AXIS]

    @property
    def data_size(self) -> int:
        """The number of ``(dcn, data)`` positions: the batch's shards."""
        return self.shape[DCN_AXIS] * self.shape[DATA_AXIS]

    @property
    def batch_position(self) -> int:
        """This rank's batch shard: its index among the ``(dcn, data)``
        positions."""
        return self.coords[0] * self.shape[DATA_AXIS] + self.coords[1]

    def __repr__(self) -> str:
        return f"PlanMesh({self.shape}, backend={self.backend})"


def make_plan_mesh(shape: Sequence[int], world: Optional[int] = None) -> PlanMesh:
    """The ``(dcn, data, model)`` :class:`PlanMesh` over ranks ``0..n-1``
    (``dwt_tpu.parallel.plan.make_plan_mesh``'s device order and its
    error); ``world`` defaults to the group's size."""
    shape = tuple(int(s) for s in shape)
    n = int(np.prod(shape))
    world = process_count() if world is None else int(world)
    if n > world:
        raise ValueError(
            f"mesh shape {shape} needs {n} devices; only {world} available")
    return PlanMesh(np.arange(n).reshape(shape))
