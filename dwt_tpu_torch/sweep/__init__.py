"""Preemptible multi-run sweep control plane — the port of ``dwt_tpu.sweep``.

The fleet pattern promoted from serving replicas to TRAINING runs: a
supervisor (:mod:`~dwt_tpu_torch.sweep.supervisor`) schedules a pair matrix
as preemptible subprocesses over bounded job slots, journaling every
decision (:mod:`~dwt_tpu_torch.sweep.journal`) so the supervisor itself may
die and relaunch — adopting jobs that kept running, rescheduling the
rest.  All runs share one content-addressed blob store; cross-run GC
refcounts blobs against the union of every run's manifest chains
(``gc_blobs(..., manifest_roots=...)``).  ``python -m
dwt_tpu_torch.sweep.cli`` (:mod:`~dwt_tpu_torch.sweep.cli`) is the entry
point.  Nothing here imports torch: the supervisor holds no CUDA context,
each training job opens its own.
"""

from dwt_tpu_torch.sweep.journal import SweepJournal, decide_adoption
from dwt_tpu_torch.sweep.supervisor import JobSpec, SweepSupervisor

__all__ = [
    "JobSpec",
    "SweepJournal",
    "SweepSupervisor",
    "decide_adoption",
]
