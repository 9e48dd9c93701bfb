"""Command-line entry points of the port."""

from __future__ import annotations

import argparse


def add_resilience_args(p: argparse.ArgumentParser, d) -> None:
    """The checkpoint-format and resilience flags both trainers share, with
    the defaults of their config ``d`` (the JAX package's)."""
    p.add_argument("--async_ckpt", action=argparse.BooleanOptionalAction,
                   default=d.async_ckpt,
                   help="background checkpoint writer: the loop only copies the "
                        "state on the card and enqueues; the host copy, digest "
                        "and write run on a writer thread (--no-async_ckpt: "
                        "every save blocks the loop)")
    p.add_argument("--ckpt_format", choices=["full", "delta"], default=d.ckpt_format,
                   help="'full': state.pt per save; 'delta': the content-addressed "
                        "store, leaf blobs under <ckpt_dir>/blobs and manifests "
                        "chained to a full save, only moved leaves written")
    p.add_argument("--delta_max_chain", type=int, default=d.delta_max_chain,
                   help="after this many chained delta saves the next is full")
    p.add_argument("--blob_store", type=str, default=d.blob_store,
                   help="a blob store shared by several runs (no local GC); "
                        "default <ckpt_dir>/blobs")
    p.add_argument("--guard_policy", choices=["none", "halt", "skip_step", "rollback"],
                   default=d.guard_policy,
                   help="divergence guard on a non-finite loss or grad norm: halt, "
                        "revert to the last good in-memory state, or roll back "
                        "to the newest valid checkpoint with a reseeded data "
                        "order.  The check reads one flag back every "
                        "--guard_interval steps: the JAX package's guard at "
                        "--harvest_depth 0 (the harvested guard, which detects "
                        "at step + depth without a sync of its own, is not "
                        "ported)")
    p.add_argument("--guard_interval", type=int, default=d.guard_interval,
                   help="steps between guard checks (one host sync each)")
    p.add_argument("--guard_max_rollbacks", type=int, default=d.guard_max_rollbacks,
                   help="rollbacks before the guard halts the run")
    p.add_argument("--guard_lr_backoff", type=float, default=d.guard_lr_backoff,
                   help="in (0, 1): the first rung — revert to the last good "
                        "state and scale every lr by this factor until "
                        "--guard_backoff_recovery clean checks; needs "
                        "--guard_policy.  0 = off")
    p.add_argument("--guard_backoff_recovery", type=int,
                   default=d.guard_backoff_recovery,
                   help="clean checks before a backed-off lr returns to 1.0")
    p.add_argument("--watchdog_timeout", type=float, default=d.watchdog_timeout,
                   help=">0: no step boundary for this many seconds dumps every "
                        "thread's stack under ckpt_dir/watchdog/ and exits 113; "
                        "budget for the first step's kernel builds and the "
                        "evals.  0 = off")
    p.add_argument("--watchdog_keep", type=int, default=d.watchdog_keep,
                   help="stack dumps kept under ckpt_dir/watchdog/")
    p.add_argument("--preempt_notice_file", type=str, default=d.preempt_notice_file,
                   help="a preemption notice: when this file exists, a proactive "
                        "save at the next step boundary while training continues")
    p.add_argument("--preempt_notice_metadata", action=argparse.BooleanOptionalAction,
                   default=d.preempt_notice_metadata,
                   help="poll the GCE instance/preempted metadata key as a notice "
                        "source (URL from DWT_PREEMPT_METADATA_URL when set)")
