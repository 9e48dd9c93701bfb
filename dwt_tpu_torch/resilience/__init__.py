"""dwt_tpu_torch.resilience — keep long preemptible runs alive and honest: the port of ``dwt_tpu.resilience`` for one process.

* :class:`PreemptionHandler` — flag-only SIGTERM/SIGINT handler polled at
  step boundaries; a final checkpoint and exit 0.
* :class:`NoticeWatcher` — a preemption notice (a file, or the GCE
  metadata key): a proactive save while training continues.
* :class:`DivergenceGuard` — amortized finite checks with the escalation
  ladder ``lr_backoff`` → ``skip_step`` | ``rollback`` → ``halt``.
* :class:`HangWatchdog` — heartbeat-fed stall detector: all-thread stacks
  under ``ckpt_dir/watchdog/`` and exit :data:`WATCHDOG_EXIT_CODE`.
* :class:`AsyncCheckpointer` / :class:`DeltaAsyncCheckpointer` — the
  single-in-flight background checkpoint writer.
* :class:`Coordinator` — the step boundary's decision, single process.
* :mod:`~dwt_tpu_torch.resilience.inject` — the deterministic fault plans
  (``DWT_FAULT_PLAN``) that drive every path above.

Not ported: the multi-host writers and consensus (ROADMAP queue 1 item 8).
"""

from dwt_tpu_torch.resilience import inject
from dwt_tpu_torch.resilience.async_ckpt import (
    AsyncCheckpointer,
    DeltaAsyncCheckpointer,
    snapshot_state,
)
from dwt_tpu_torch.resilience.coord import Coordinator, Decision
from dwt_tpu_torch.resilience.guard import (
    POLICIES,
    DivergenceError,
    DivergenceGuard,
    RollbackRequest,
)
from dwt_tpu_torch.resilience.notice import NoticeWatcher
from dwt_tpu_torch.resilience.preemption import PreemptionHandler
from dwt_tpu_torch.resilience.watchdog import WATCHDOG_EXIT_CODE, HangWatchdog

__all__ = [
    "AsyncCheckpointer",
    "DeltaAsyncCheckpointer",
    "NoticeWatcher",
    "snapshot_state",
    "Coordinator",
    "Decision",
    "DivergenceError",
    "DivergenceGuard",
    "HangWatchdog",
    "POLICIES",
    "PreemptionHandler",
    "RollbackRequest",
    "WATCHDOG_EXIT_CODE",
    "inject",
]
