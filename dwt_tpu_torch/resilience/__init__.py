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
  single-in-flight background checkpoint writer;
  :class:`MultiHostAsyncCheckpointer` /
  :class:`MultiHostDeltaAsyncCheckpointer` — its multi-process form (each
  rank's host shard, rank 0's promotion at the consensus frontier).
* :class:`Coordinator` — the step boundary's decision: every rank's flags
  allgathered over a gloo group in a multi-process run.
* :mod:`~dwt_tpu_torch.resilience.inject` — the deterministic fault plans
  (``DWT_FAULT_PLAN``) that drive every path above.

The names are exported lazily (:func:`~dwt_tpu_torch._lazy.lazy_exports`):
the fleet's balancer reads :mod:`~dwt_tpu_torch.resilience.inject` and
must not import torch, which the checkpoint writer and the guard need.
"""

from dwt_tpu_torch._lazy import lazy_exports

_EXPORTS = {
    "AsyncCheckpointer": "async_ckpt",
    "DeltaAsyncCheckpointer": "async_ckpt",
    "MultiHostAsyncCheckpointer": "async_ckpt",
    "MultiHostDeltaAsyncCheckpointer": "async_ckpt",
    "snapshot_state": "async_ckpt",
    "Coordinator": "coord",
    "Decision": "coord",
    "DivergenceError": "guard",
    "DivergenceGuard": "guard",
    "POLICIES": "guard",
    "RollbackRequest": "guard",
    "NoticeWatcher": "notice",
    "PreemptionHandler": "preemption",
    "HangWatchdog": "watchdog",
    "WATCHDOG_EXIT_CODE": "watchdog",
}

__all__ = sorted(_EXPORTS) + ["inject"]

__getattr__ = lazy_exports(__name__, _EXPORTS)
