"""Step-boundary decisions — the single-process subset of ``dwt_tpu.resilience.coord``.

The JAX package's :class:`Coordinator` allgathers every host's flags at
each step boundary so that any host's SIGTERM, notice or divergence
becomes one decision for all of them.  The port runs on one process, so
its coordinator is never enabled: :meth:`Coordinator.decide` combines the
local flags by the JAX rules (stop wins, the most severe event code
governs, the rollback target is the largest proposal, a notice from any
source counts) without any collective.  The allgather consensus waits
for multi-process training (ROADMAP queue 1 item 8).

:func:`assert_not_writer_thread` is kept for its other job in the port:
the background checkpoint writer (``dwt_tpu_torch.resilience.
async_ckpt``) copies its snapshot to the host on its own CUDA stream, and
nothing that launches work on the compute stream may run on it.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Optional

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
    """The verdict for one step boundary."""

    stop: bool  # preempted: save and exit 0
    event: int  # the EVENT_* code the run acts on
    rollback_step: int  # failed step of a rollback proposal; -1 = none
    notice: bool = False  # a preemption notice: proactive save, keep going

    @property
    def diverged(self) -> bool:
        return self.event != EVENT_NONE


class Coordinator:
    """Boundary decisions of a single-process run: ``enabled`` is False
    and :meth:`decide` needs no collective."""

    def __init__(self, enabled: Optional[bool] = None):
        if enabled:
            raise NotImplementedError(
                "the multi-host consensus is not ported (ROADMAP queue 1 item 8)")
        self.enabled = False

    def decide(self, stop=False, event=EVENT_NONE, rollback_step=-1,
               notice=False) -> Decision:
        """One decision from this process's flags; each argument may also
        be a sequence of flags from several sources, combined as the JAX
        package combines hosts: any stop or notice counts, the largest
        event code and rollback proposal govern."""
        def many(v):
            return list(v) if isinstance(v, (list, tuple)) else [v]

        return Decision(
            stop=any(bool(v) for v in many(stop)),
            event=max(int(v) for v in many(event)),
            rollback_step=max(int(v) for v in many(rollback_step)),
            notice=any(bool(v) for v in many(notice)),
        )
