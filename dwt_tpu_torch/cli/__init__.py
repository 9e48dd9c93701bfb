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
                        "order.  With --harvest_depth > 0 the guard reads the "
                        "step's harvested finite flag, with no sync of its own, "
                        "and acts at most depth steps late; at --harvest_depth "
                        "0 it reads one flag back every --guard_interval steps")
    p.add_argument("--guard_interval", type=int, default=d.guard_interval,
                   help="steps between guard checks (at --harvest_depth 0 one "
                        "host sync each; harvested: the snapshot refresh)")
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


def add_dispatch_args(p: argparse.ArgumentParser, d) -> None:
    """``--steps_per_dispatch``, ``--eval_steps_per_dispatch`` and
    ``--harvest_depth``, with the defaults of the config ``d`` (the JAX
    package's: 1, 8, 2)."""
    p.add_argument("--steps_per_dispatch", type=int, default=d.steps_per_dispatch,
                   help=">1: run k train steps per dispatch (on the card, replays "
                        "of one captured CUDA graph step over k stacked batches; "
                        "chunks cut at eval/checkpoint boundaries) — amortizes "
                        "the host's launch cost; same numerics")
    p.add_argument("--eval_steps_per_dispatch", type=int,
                   default=d.eval_steps_per_dispatch,
                   help="k eval/stat-collection batches per dispatch (on the card "
                        "at k > 1, replays of a captured forward); eval counters "
                        "stay device-resident across the whole pass (O(1) host "
                        "fetches), ragged tails are pad-and-masked so counts "
                        "stay exact")
    p.add_argument("--harvest_depth", type=int, default=d.harvest_depth,
                   help="async metric harvesting: depth of the bounded ring "
                        "deferring the train-record host fetch (non-blocking "
                        "device→host copies, drained once full — amortized "
                        "1/depth syncs per step — or fully at eval/ckpt/"
                        "preempt/rollback boundaries); records keep their "
                        "original step stamps byte-identically, and the "
                        "divergence guard reads the step's harvested finite flag "
                        "with staleness <= depth.  0 = synchronous fetch")


def add_numerics_args(p: argparse.ArgumentParser, d, remat: bool = False) -> None:
    """``--whitener``, ``--bf16`` and ``--compute_dtype`` (and, with
    ``remat``, OfficeHome's ``--remat``), with the JAX CLIs' choices and
    the defaults of the config ``d``."""
    p.add_argument("--whitener", choices=["cholesky", "newton_schulz", "swbn"],
                   default=d.whitener,
                   help="whitening numerics backend: cholesky (reference "
                        "factorization, default), newton_schulz (fixed-K "
                        "iteration of pure batched matmuls; DWT_NS_ITERS), swbn "
                        "(online whitening-matrix tracking, no factorization; "
                        "DWT_SWBN_ALPHA).  Checkpoints are per-backend")
    p.add_argument("--bf16", action="store_true",
                   help="legacy alias for --compute_dtype bf16")
    p.add_argument("--compute_dtype", type=str, default=d.compute_dtype,
                   choices=("f32", "bf16"),
                   help="training compute dtype: params/optimizer state "
                        "stay f32; bf16 runs activations, backprop "
                        "traffic, and the whitening apply in bf16 (each "
                        "whitener backend's precision_policy decides "
                        "whether its factorization promotes or runs "
                        "natively — ops/whitening.py).  f32 (default) "
                        "is bitwise the legacy path")
    if remat:
        p.add_argument("--remat", action="store_true",
                       help="rematerialize bottleneck blocks in backward "
                            "(less device memory, ~1/3 more FLOPs) for "
                            "larger batches")
