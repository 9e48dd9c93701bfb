"""Step-boundary decisions: any rank's event becomes every rank's decision — the port of ``dwt_tpu.resilience.coord``.

A SIGTERM lands on one rank; a divergence seen by one rank and acted on
alone would leave the others blocked in the next collective.  So at each
step or chunk boundary the loops call :meth:`Coordinator.decide` with this
rank's flags (``stop``, the guard's ``event`` code, a ``rollback_step``,
the async writer's ``save_done_seq`` and a preemption ``notice``), and,
in a multi-process run, the flags of every rank are allgathered as one
small int vector and combined by the JAX rules: any stop or notice
counts, the largest event code and rollback proposal govern, the promotion
frontier is the smallest done sequence.  The gather runs over a gloo group
of CPU tensors (``parallel.cpu_group``), also in an NCCL run, so a
boundary decision never waits on the card.  :meth:`Coordinator.agree_step`
is the min over ranks (the restore target every rank can read), and
:meth:`Coordinator.assert_same` raises on forked replicas.

A single-process run's coordinator is not ``enabled``: :meth:`decide`
combines the local flags without any collective; each argument may be a
sequence of flags from several sources, combined as ranks are.
``enabled=True`` forces the gather path on one process (a one-row
gather), as the JAX package's does.

:func:`assert_not_writer_thread` keeps collectives and compute-stream work
off the background checkpoint writer (``dwt_tpu_torch.resilience.
async_ckpt``): the writer copies its snapshot on its own CUDA stream, and a
collective issued from it would be ordered against the loop's by thread
scheduling.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Optional

import numpy as np
import torch

# Divergence event codes, ordered by severity: the largest governs.
EVENT_NONE = 0  # finite metrics, no guard action
EVENT_RECOVERED = 1  # in-memory rung fired (lr_backoff or skip_step)
EVENT_ROLLBACK = 2  # rollback requested (rollback_step carries the step)
EVENT_HALT = 3  # guard says stop the run

WRITER_THREAD_PREFIX = "dwt-ckpt-writer"


def assert_not_writer_thread(what: str) -> None:
    """Refuse ``what`` (work on the compute stream) on a checkpoint writer
    thread: the writer copies its snapshot on its own stream, ordered by
    an event, and work it enqueued on the compute stream would race the
    train step's.  One string comparison of the thread's name."""
    name = threading.current_thread().name
    if name.startswith(WRITER_THREAD_PREFIX):
        raise RuntimeError(
            f"{what} called from checkpoint writer thread {name!r} — the "
            "writer works on its own CUDA stream only")


@dataclasses.dataclass(frozen=True)
class Decision:
    """The verdict for one step boundary, the same on every rank."""

    stop: bool  # some rank was preempted: save and exit 0, together
    event: int  # the largest EVENT_* code: the rung every rank takes
    rollback_step: int  # failed step of a rollback proposal; -1 = none
    notice: bool = False  # a preemption notice: proactive save, keep going
    # The newest async save every rank's writer has finished (min over
    # ranks; -1: none): rank 0 may promote the saves up to it.
    save_done_seq: int = -1

    @property
    def diverged(self) -> bool:
        return self.event != EVENT_NONE


def _many(v):
    return list(v) if isinstance(v, (list, tuple)) else [v]


class Coordinator:
    """Boundary consensus over every rank's flags (module docstring).
    ``enabled`` defaults to "more than one process"."""

    def __init__(self, enabled: Optional[bool] = None):
        from dwt_tpu_torch.parallel.mesh import process_count

        self.process_count = process_count()
        self.enabled = self.process_count > 1 if enabled is None else bool(enabled)
        # Decision latency: the per-boundary gather is a real cost, and a
        # latency spike is the first sign of a straggling peer.
        self.decides = 0
        self.last_decide_s = 0.0
        self.total_decide_s = 0.0
        self.max_decide_s = 0.0
        self.recent_decide_s = collections.deque(maxlen=512)

    def _allgather(self, values) -> np.ndarray:
        """``[process_count, len(values)]``: every rank's vector (int64)."""
        assert_not_writer_thread("consensus allgather")
        mine = torch.tensor([int(v) for v in values], dtype=torch.int64)
        if self.process_count == 1:
            return mine.numpy()[None]
        import torch.distributed as dist

        from dwt_tpu_torch.parallel.mesh import cpu_group

        rows = [torch.empty_like(mine) for _ in range(self.process_count)]
        dist.all_gather(rows, mine, group=cpu_group())
        return torch.stack(rows).numpy()

    def decide(self, stop=False, event=EVENT_NONE, rollback_step=-1,
               notice=False, save_done_seq=-1) -> Decision:
        """One decision for every rank.  A collective when ``enabled``:
        every rank must call it at the same boundary."""
        if not self.enabled:
            return Decision(
                stop=any(bool(v) for v in _many(stop)),
                event=max(int(v) for v in _many(event)),
                rollback_step=max(int(v) for v in _many(rollback_step)),
                notice=any(bool(v) for v in _many(notice)),
                save_done_seq=min(int(v) for v in _many(save_done_seq)),
            )
        t0 = time.perf_counter()
        rows = self._allgather([bool(stop), event, rollback_step, save_done_seq,
                                bool(notice)])
        dt = time.perf_counter() - t0
        self.decides += 1
        self.last_decide_s = dt
        self.total_decide_s += dt
        self.max_decide_s = max(self.max_decide_s, dt)
        self.recent_decide_s.append(dt)
        return Decision(stop=bool(rows[:, 0].any()), event=int(rows[:, 1].max()),
                        rollback_step=int(rows[:, 2].max()),
                        notice=bool(rows[:, 4].any()),
                        save_done_seq=int(rows[:, 3].min()))

    def agree_step(self, step: int) -> int:
        """The smallest ``step`` over the ranks (``-1``: nothing here)."""
        if not self.enabled:
            return int(step)
        return int(self._allgather([step]).min())

    def first(self, value: int) -> int:
        """Rank 0's ``value`` on every rank (a collective when enabled)."""
        if not self.enabled:
            return int(value)
        return int(self._allgather([value])[0, 0])

    def assert_same(self, value: int, what: str) -> None:
        """Raise unless every rank computed the same ``value``."""
        if not self.enabled:
            return
        got = [int(v) for v in self._allgather([value]).reshape(-1)]
        if len(set(got)) > 1:
            raise RuntimeError(
                f"multi-host desync on {what}: per-process values {got} — refusing "
                "to continue with forked replicas (check shared-checkpoint-dir "
                "visibility/pruning)")
