"""Command-line entry points of the port, and what the trainers' CLIs share:
their flag groups and :func:`run_cli`, the run plane around a training run
(the ``--metrics_jsonl`` logger, ``--debug_nans``, ``--expect_accuracy``)."""

from __future__ import annotations

import argparse
import contextlib
import logging


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


def add_parallel_args(p: argparse.ArgumentParser, d) -> None:
    """The JAX trainers' five parallel flags, with the defaults of the
    config ``d``.  One process per device: launch the same command once per
    rank (torchrun, or the DWT_* variables) with ``--distributed``."""
    p.add_argument("--data_parallel", action="store_true",
                   help="replica data parallelism over every rank of the process "
                        "group: each rank trains on 1/N of every batch, the norm "
                        "sites' moments, the gradients and the eval counters "
                        "reduced over the ranks (global-batch numerics)")
    p.add_argument("--distributed", action="store_true",
                   help="multi-process bring-up: join the torch.distributed group "
                        "from DWT_COORDINATOR_ADDRESS/DWT_NUM_PROCESSES/"
                        "DWT_PROCESS_ID, else torchrun's MASTER_ADDR/MASTER_PORT/"
                        "RANK/WORLD_SIZE; launch the same command on every rank "
                        "(gloo on the CPU or where ranks share a GPU, NCCL where "
                        "each rank owns one)")
    p.add_argument("--dcn_slices", type=int, default=d.dcn_slices,
                   help=">1: 2-D (dcn, data) rank grid — reductions within a "
                        "slice first, then across slices")
    p.add_argument("--mesh_shape", type=str, default=d.mesh_shape,
                   help="mesh as 'dcn,data,model' sizes (e.g. 1,2,2); '4' and "
                        "'2,4' shorthands pad the missing axes to 1.  It must "
                        "cover every rank; a model axis > 1 needs a "
                        "model-sharding --sharding_rules.  Unset keeps the "
                        "single/--data_parallel decision")
    p.add_argument("--sharding_rules", type=str, default=d.sharding_rules,
                   help="rules table of the state's placement: 'dp' (replicate "
                        "every state tensor); 'model' (conv and fc kernels "
                        "sharded over the model axis, heads and stats "
                        "replicated), 'fsdp' (every kernel, heads included: "
                        "pass --pad_classes_to) or a JSON rules file "
                        "(configs/*_rules.json) — the gspmd mode: each rank "
                        "holds its block of every sharded tensor")


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


def add_run_plane_args(p: argparse.ArgumentParser, d) -> None:
    """The JAX trainers' run-plane flags, with the defaults of the config
    ``d``: the JSONL record file, span tracing, the heartbeat, ``/metrics`` and the alert
    rules, the repro assertion, ``--debug_nans``, the loader's stall budget,
    and the two JAX lowering switches, which the port accepts and ignores."""
    p.add_argument("--data_stall_timeout", type=float, default=d.data_stall_timeout,
                   help="data-pipeline head-of-window stall budget (seconds): a "
                        "worker silent past this is logged and its item "
                        "re-submitted to a fresh worker.  0 disables detection")
    p.add_argument("--metrics_jsonl", type=str, default=None,
                   help="append every record of the run to this JSONL file")
    p.add_argument("--obs_trace", type=str, default=d.obs_trace,
                   help="span tracing: write a Chrome trace-event JSON of the run's "
                        "per-phase spans (batch wait, step dispatch, harvest, eval, "
                        "checkpoint, data) to this path; open it in Perfetto or feed "
                        "tools/torch_obs_report.py.  DWT_OBS_TRACE is the flagless "
                        "form.  Off by default; a disabled span costs one global read")
    p.add_argument("--heartbeat_every", type=int, default=d.heartbeat_every,
                   help=">0: a heartbeat record (steps/s EWMA, host RSS MB, device "
                        "memory, background-writer depth, harvest ring) every N "
                        "steps.  0 disables")
    p.add_argument("--metrics_port", type=int, default=d.metrics_port,
                   help="serve the Prometheus text exposition at /metrics on this "
                        "port (a daemon thread; 0 = ephemeral, the port logged as "
                        "a metrics_exporter record)")
    p.add_argument("--alert_rules", type=str, default=d.alert_rules,
                   help="SLO alert rules JSON evaluated at each step boundary "
                        "against the live registry; transitions emit 'alert' "
                        "records and the dwt_alerts_firing gauge")
    p.add_argument("--expect_accuracy", type=float, default=None,
                   help="repro assertion: exit 1 unless the final target accuracy "
                        "is within --tolerance of this (see baselines/)")
    p.add_argument("--tolerance", type=float, default=0.3,
                   help="±%% band for --expect_accuracy (BASELINE north star: 0.3)")
    p.add_argument("--debug_nans", action="store_true",
                   help="fail fast at the module whose output holds a NaN, and "
                        "at the backward function that returns one (autograd's "
                        "anomaly mode); needs eager steps: --steps_per_dispatch 1 "
                        "(on CUDA also --eval_steps_per_dispatch 1)")
    p.add_argument("--pallas_whiten", action="store_true",
                   help="accepted for the JAX CLI's sake; changes nothing here "
                        "(the port always runs its CUDA kernels)")
    p.add_argument("--apply_lowering", choices=["auto", "grouped", "blockdiag"],
                   default=d.apply_lowering,
                   help="accepted for the JAX CLI's sake; changes nothing here "
                        "(the port's apply is one hand-written kernel)")


def _nan_hook(module, inputs, output) -> None:
    outputs = output if isinstance(output, (tuple, list)) else (output,)
    import torch

    for t in outputs:
        if torch.is_tensor(t) and t.is_floating_point() and bool(torch.isnan(t).any()):
            raise FloatingPointError(
                f"--debug_nans: NaN in the output of {type(module).__name__}")


@contextlib.contextmanager
def debug_nans(cfg, enabled: bool):
    """``--debug_nans``: every module's output is checked for NaN (a
    ``FloatingPointError`` names the module) and autograd's anomaly mode
    checks every backward function's.  Both read the device back inside
    the step, which a CUDA graph capture cannot do: the flag refuses the
    captured dispatch instead of skipping the checks there."""
    if not enabled:
        yield
        return
    import torch

    if cfg.steps_per_dispatch > 1 or (
            cfg.device != "cpu" and cfg.eval_steps_per_dispatch > 1):
        raise SystemExit(
            "--debug_nans checks every op on the host, which a CUDA graph capture "
            "cannot do: pass --steps_per_dispatch 1 (on CUDA also "
            "--eval_steps_per_dispatch 1) so that every step runs eagerly")
    anomaly = (torch.is_anomaly_enabled(), torch.is_anomaly_check_nan_enabled())
    torch.autograd.set_detect_anomaly(True, check_nan=True)
    handle = torch.nn.modules.module.register_module_forward_hook(_nan_hook)
    try:
        yield
    finally:
        handle.remove()
        torch.autograd.set_detect_anomaly(*anomaly)


def run_cli(run, cfg, args: argparse.Namespace) -> float:
    """A trainer CLI's run, as the JAX CLIs': one ``MetricLogger`` (the
    ``--metrics_jsonl`` file; each record also logged as a JSON line)
    handed to ``run(cfg, logger)`` and closed on every exit; then the
    final accuracy printed and, with ``--expect_accuracy``, the
    ``accuracy_check`` record and exit 1 on a miss."""
    from dwt_tpu_torch.utils.metrics import MetricLogger
    from dwt_tpu_torch.utils.repro import check_cli_accuracy

    logging.basicConfig(level=logging.INFO, format="%(message)s")
    logger = MetricLogger(jsonl_path=args.metrics_jsonl, stream=None)
    try:
        with debug_nans(cfg, args.debug_nans):
            acc = run(cfg, logger)
        print(f"final target accuracy: {acc:.2f}%", flush=True)
        if not check_cli_accuracy(acc, args.expect_accuracy, args.tolerance, logger):
            raise SystemExit(1)
        return acc
    finally:
        logger.close()
