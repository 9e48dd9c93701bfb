"""The two training loops — the cores of ``dwt_tpu.train.loop.run_digits`` and ``run_officehome``.

* :func:`run_digits` trains LeNet-DWT with the entropy loss and Adam:
  seeded source and target streams zipped into epochs, a ``train`` record
  every ``log_interval`` steps of an epoch and a ``test`` record after
  each epoch.  Data: ``--synthetic``, or the USPS pickle and the MNIST
  files under ``data_root`` (there is no download path).
* :func:`run_officehome` trains a registry backbone (ResNet-DWT, or
  ViT-DWT through ``backbone``) with MEC: seeded source and
  target streams (the target carrying its augmented view), ``num_iters``
  steps, an eval every ``check_acc_step``, then the post-training
  protocol — ``stat_collection_passes`` gradient-free train-mode passes
  over the target test set, and the final eval.  Data: ``--synthetic``,
  or the two image folders ``s_dset_path`` and ``t_dset_path``.

Both return the final target accuracy (%).  A trainer runs on CUDA unless
the config asks for the CPU, and raises when CUDA is absent rather than
choosing the CPU itself.  It turns TF32 off for cuDNN convolutions and
cuBLAS matmuls, process-wide: the JAX reference's f32 train step is full
f32.

Dispatch and harvesting, as the JAX loops': the batches are grouped
into chunks of up to k = ``steps_per_dispatch`` (:func:`_chunk_stream`,
cut where an eval or a save is due so the cadences land on chunk
boundaries; a digits epoch's end ends its last chunk) and each chunk
runs through ``steps.make_scanned_step`` — at k ≥ 2 on the card one
replay of a captured CUDA graph per step, at k = 1 one eager step
(:func:`_run_chunks`); the step boundary (guard, fault hooks,
preemption) runs once per chunk, over its step range.  The digits loop
at k = 1 keeps its per-step loop: its records carry the host's running
step count, where the JAX loop's chunked path numbers the steps from
``state.step`` at the epoch's start (the two part after a skipped step).  Records are stamped on the host and reach the
logger through ``train.harvest.AsyncMetricHarvester`` (``harvest_depth``,
default 2): non-blocking copies, drained when ready, on overflow, and
fully before every eval, save, preemption exit, rollback and return, so
the records are the synchronous path's, in order.  With a guard and a
depth above 0 the guard reads the harvested ``finite`` flags
(``check_harvested``: detection at most ``depth`` dispatches late, no
readback of its own); at depth 0 it reads one flag back every
``guard_interval`` steps.  Eval and collection passes run
``eval_steps_per_dispatch`` batches per dispatch (``train.evalpipe``).

Both loops read their streams through a ``DataPlane`` registered as the
JAX loops register theirs, so they train on the JAX package's batches,
item for item, and take them through ``prefetch_to_device``.

With ``ckpt_dir``, both loops save and resume as the JAX loops do
(``dwt_tpu_torch.utils.checkpoint``): a save after each
``ckpt_every_epochs``-th epoch and the last (digits) or every
``ckpt_every_iters`` steps (OfficeHome), an anchor every
``anchor_every`` into ``anchors/``, ``keep_ckpts`` pruning the main
directory only; OfficeHome also keeps the best-accuracy state in
``best_gr_{group_size}/`` with ``best.json``, and saves the
post-collection state last, the run's deployable artifact.  A run whose
``ckpt_dir`` holds a valid checkpoint (main or anchors) resumes from the
newest, its data plane at the manifest's ``data_state``, and continues
with the batches, draws and learning rates of the uninterrupted run.
Saves run on a background writer thread (``--async_ckpt``, the
default; ``resilience.async_ckpt``) in the ``full`` or the ``delta``
format (``--ckpt_format``; ``ckpt.store``), and every save logs a
``checkpoint`` record once it is written (``seconds``: the loop's stall;
``writer_s``; ``bytes``; ``sync``), a resume a ``resume`` record.
Quarantined items are recorded in ``ckpt_dir/quarantine.json`` and
skipped on resume.  OfficeHome starts,
when it does not resume, from ``init_ckpt`` (its step reset to 0), else
from the reference checkpoint at ``resnet_path`` (not with
``synthetic``), else from fresh weights.

Both loops run the JAX loops' resilience plane (``dwt_tpu_torch.
resilience``): a step boundary after every step (the fault plan's hooks,
the watchdog's heartbeat, the divergence guard's amortized check, the
preemption flag and the notice), the guard's ladder (``lr_backoff``,
``skip_step``, ``rollback`` to the newest valid checkpoint with the data
streams reseeded, ``halt``), a proactive ``notice_save`` on a preemption
notice, and on SIGTERM a final save, a ``preempt`` record and a normal
return (exit 0).

Both loops build their model with the config's compute dtype
(``--compute_dtype``/``--bf16``: bf16 activations, f32 parameters,
optimizer state and running stats), whitener (``--whitener``) and, for
OfficeHome, ``--remat``.  At ``--stat_collection_passes 0`` the OfficeHome
loop records a skipped stat collection for every whitener, and with an
online whitener (``swbn``) it warns when passes are asked for, as the JAX
loop does.

Both loops run the JAX loops' run plane: a ``heartbeat`` record every
``heartbeat_every`` steps at the step boundary (steps/s, host RSS, the
writer's in-flight depth, the card's allocator stats and the harvester's
gauges — host-side numbers only), the ``--metrics_port`` exporter
(``metrics_exporter`` record) and the ``--alert_rules`` engine evaluated
at every boundary (``alert_rules`` and ``alert`` records), and the
registry's ``dwt_train_steps_total``, ``dwt_guard_events_total{event}``,
``dwt_train_loss{loss}``, ``dwt_eval_accuracy``, ``dwt_ckpt_saves_total
{mode}`` and ``dwt_ckpt_stall_ms``.  None of them reads a device tensor:
the losses are fed from the harvested host copies.

Both loops open the JAX loops' spans (``dwt_tpu_torch.obs``; ``--obs_trace``
or ``DWT_OBS_TRACE``): ``batch_wait`` over the prefetched batches or
chunks, ``step_dispatch`` (with ``n`` on the chunked path) around the
dispatch — a span wraps a graph's replays from outside, never inside a
capture, and times their enqueue — ``boundary`` with the nested
``guard_check``, the checkpoint pipeline's ``ckpt_enqueue`` and
``ckpt_sync_save``, ``eval_pass`` (``imgs``) and ``stat_collection``
(``pass_index``); a guard event dumps the trailing span window into
``ckpt_dir/watchdog`` (the flight recorder), and every return path exports
the trace.  Every run ends with a ``params_digest`` record: ``digest`` is
the JAX loops' Σ|p| in float64 over the parameters; runs with a
checkpoint directory add ``sha256``, the parameters' SHA-256, which the
resume checks compare bitwise.  ``dwt_ckpt_bytes_written_total
{mode}`` and the ``dwt_ckpt_dir_bytes`` gauge feed the heartbeat's
checkpoint fields.

Not ported yet, in either loop (ROADMAP): ``mirror_recovery`` and
multi-host runs (queue 1 item 8).
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import time
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from dwt_tpu_torch import obs
from dwt_tpu_torch.config import (
    INERT_FIELDS,
    DigitsConfig,
    OfficeHomeConfig,
    resolve_compute_dtype,
    model_dtype,
)
from dwt_tpu_torch.data.datasets import (
    ArrayDataset,
    ImageFolderDataset,
    load_mnist,
    load_usps,
)
from dwt_tpu_torch.ckpt.store import blob_store_root, save_delta, tree_bytes
from dwt_tpu_torch.convert import convert_resnet_state_dict, load_pytorch_checkpoint
from dwt_tpu_torch.data.loader import QuarantineRegistry, prefetch_to_device
from dwt_tpu_torch.data.pipeline import DataPlane
from dwt_tpu_torch.data.sampler import epoch_batch_count
from dwt_tpu_torch.data.transforms import (
    Compose,
    FusedAffineBlurNormalize,
    FusedToArrayNormalize,
    RandomCrop,
    RandomHorizontalFlip,
    Resize,
    ThreadLocalRng,
    gaussian_blur,
    random_affine,
)
from dwt_tpu_torch.nn.lenet import build_lenet
from dwt_tpu_torch.nn.registry import build_backbone
from dwt_tpu_torch.obs.registry import get_registry
from dwt_tpu_torch.ops.whitening import get_whitener
from dwt_tpu_torch.resilience import inject
from dwt_tpu_torch.resilience.async_ckpt import AsyncCheckpointer, DeltaAsyncCheckpointer
from dwt_tpu_torch.resilience.coord import Coordinator
from dwt_tpu_torch.resilience.guard import (
    DivergenceError,
    DivergenceGuard,
    RollbackRequest,
)
from dwt_tpu_torch.resilience.notice import NoticeWatcher
from dwt_tpu_torch.resilience.preemption import PreemptionHandler
from dwt_tpu_torch.resilience.watchdog import HangWatchdog
from dwt_tpu_torch.serve.engine import resolve_device
from dwt_tpu_torch.train.evalpipe import EvalPipeline
from dwt_tpu_torch.train.harvest import make_harvester
from dwt_tpu_torch.train.optim import digits_tx, officehome_tx
from dwt_tpu_torch.train.state import TrainState
from dwt_tpu_torch.train.steps import (
    make_digits_train_step,
    make_officehome_train_step,
    make_scanned_step,
    stack_batches,
)
from dwt_tpu_torch.utils.checkpoint import (
    MANIFEST,
    STATE_FILE,
    Restored,
    anchor_dir,
    host_state,
    is_valid_checkpoint,
    load_data_state,
    params_digest,
    ranked_checkpoints,
    restore_newest,
    restore_state,
    save_state,
)
from dwt_tpu_torch.utils.metrics import HeartbeatEmitter

log = logging.getLogger(__name__)

# ``logger(kind, step, **fields)`` receives every record of a run.
Logger = Callable[..., None]


def _log_record(kind: str, step: int, **fields) -> None:
    log.info(json.dumps({"kind": kind, "step": step, **fields}))


def _keep_kwargs(cfg) -> dict:
    """``save_state`` kwargs of main-directory saves: ``keep_ckpts``
    prunes there only — anchors and best_* never get a ``keep``."""
    return {"keep": cfg.keep_ckpts} if cfg.keep_ckpts > 0 else {}


def _saved_bytes(path: str) -> int:
    """The bytes a save wrote: its state file (full format), or its new
    blobs and its manifest (delta format)."""
    state_file = os.path.join(path, STATE_FILE)
    if os.path.exists(state_file):
        return os.path.getsize(state_file)
    manifest = os.path.join(path, MANIFEST)
    with open(manifest) as f:
        written = int(json.load(f).get("bytes_written", 0))
    return written + os.path.getsize(manifest)


def _params_digest(model: nn.Module) -> float:
    """The JAX loops' digest: Σ|p| in float64 over the parameters, one
    host read (a healthy run's replicas log the identical value)."""
    sums = [p.detach().abs().sum(dtype=torch.float64) for p in model.parameters()]
    return float(torch.stack(sums).sum().item()) if sums else 0.0


def _log_params_digest(logger: Logger, step: int, model: nn.Module,
                       ckpt_dir: Optional[str]) -> None:
    """JAX's ``digest`` on every run; with a checkpoint directory, whose
    resumes are checked bitwise, also the parameters' ``sha256``."""
    fields = {"digest": _params_digest(model)}
    if ckpt_dir:
        fields["sha256"] = params_digest(model.named_parameters())
    logger("params_digest", step, **fields)


# --------------------------------------------------- live metrics plane


def _note_losses(**losses) -> None:
    """Feed the last logged training losses into the registry: called
    from the train records' emit, with the harvested host copies — no
    device read."""
    gauge = get_registry().gauge("dwt_train_loss", "last logged training loss",
                                 labelnames=("loss",))
    for name, value in losses.items():
        gauge.labels(loss=name).set(float(value))


def _note_accuracy(acc: float) -> None:
    get_registry().gauge("dwt_eval_accuracy",
                         "last eval-pass target accuracy (%)").set(float(acc))


def _setup_metrics_plane(cfg, logger: Logger):
    """The run's live metrics surface, as the JAX loops': start the
    ``metrics_port`` exporter thread (0 = ephemeral; the bound port is
    logged as a ``metrics_exporter`` record) and build the ``alert_rules``
    engine the step boundary evaluates.  Returns the engine (or None)."""
    if cfg.metrics_port is not None:
        from dwt_tpu_torch.obs import prom

        exporter = prom.start_exporter(int(cfg.metrics_port))
        logger("metrics_exporter", 0, port=exporter.server_address[1])
    if not cfg.alert_rules:
        return None
    from dwt_tpu_torch.obs import rules as obs_rules

    engine = obs_rules.AlertEngine(obs_rules.load_rules(cfg.alert_rules))
    logger("alert_rules", 0, rules=len(engine.rules), path=cfg.alert_rules)
    return engine


def _note_inert(cfg) -> None:
    """One log line for each inert flag the run was given (a value other
    than the config's default): it changes nothing in the port."""
    names = ["pallas_whiten", "apply_lowering"]
    if isinstance(cfg, OfficeHomeConfig):
        names += ["target_batch_size", "lr_change_step"]
    default = type(cfg)()
    for name in names:
        if getattr(cfg, name) != getattr(default, name):
            log.warning("--%s=%s changes nothing in the port: %s", name,
                        getattr(cfg, name), INERT_FIELDS[name])


class _CkptPipeline:
    """One save/flush facade per run, as the JAX loops': the background
    writer (``AsyncCheckpointer``, or ``DeltaAsyncCheckpointer`` with
    ``--ckpt_format delta``; one blob store per ``ckpt_dir`` tree, or the
    shared ``--blob_store`` without GC), or blocking saves on this thread
    with ``--no-async_ckpt``.  ``flush`` is the rendezvous before the
    preemption exit, the final save, a rollback and a ``best.json``
    update (a no-op on the sync path).

    Every save logs one ``checkpoint`` record at its step once it is
    written — an async save at the next save or flush that joins it:
    ``dir``, ``seconds`` (the loop's stall: the snapshot and the enqueue,
    or the whole blocking save), ``writer_s`` (the write's wall seconds),
    ``bytes`` and ``sync``.  The registry's ``dwt_ckpt_saves_total{mode}``
    counts the saves, ``dwt_ckpt_stall_ms`` the loop's stall per save."""

    def __init__(self, cfg, logger: Logger):
        self._logger = logger
        reg = get_registry()
        self._m_saves = reg.counter("dwt_ckpt_saves_total", "checkpoint saves initiated",
                                    labelnames=("mode",))
        self._m_stall = reg.histogram(
            "dwt_ckpt_stall_ms",
            "hot-path stall per checkpoint save (async: snapshot + enqueue incl. "
            "backpressure; sync: the full blocking save)")
        self._fmt = cfg.ckpt_format
        if self._fmt not in ("full", "delta"):
            raise ValueError(f"--ckpt_format must be 'full' or 'delta'; got {self._fmt!r}")
        self._delta_max_chain = int(cfg.delta_max_chain)
        self._gc = cfg.blob_store is None
        self._store_root = None
        if cfg.ckpt_dir and self._fmt == "delta":
            self._store_root = (os.path.abspath(os.path.expanduser(cfg.blob_store))
                                if cfg.blob_store else blob_store_root(cfg.ckpt_dir))
        if cfg.ckpt_dir:
            # Sampled at scrape and heartbeat time: the checkpoint tree's
            # footprint on disk.
            reg.gauge("dwt_ckpt_dir_bytes",
                      "total bytes under --ckpt_dir (sampled at scrape)").set_function(
                lambda root=cfg.ckpt_dir: float(tree_bytes(root)))
        self._acp = None
        if cfg.ckpt_dir and cfg.async_ckpt:
            self._acp = (DeltaAsyncCheckpointer(self._store_root, self._delta_max_chain,
                                                gc=self._gc)
                         if self._fmt == "delta" else AsyncCheckpointer())
        # The in-flight async save: (seq, step, dirs, the loop's stall).
        self._pending: Optional[Tuple[int, int, List[str], float]] = None

    def _log(self, step: int, directory: str, path: str, seconds: float,
             writer_s: float, sync: bool) -> None:
        self._logger("checkpoint", step, dir=directory, seconds=seconds,
                     writer_s=writer_s, bytes=_saved_bytes(path), sync=sync)

    def _report(self) -> None:
        """After a join: log the joined async save's records (none when
        it failed; its error is raised at the join)."""
        if self._pending is None:
            return
        seq, step, dirs, seconds = self._pending
        self._pending = None
        for done in [d for d in self._acp.done if d["seq"] == seq]:
            self._acp.done.remove(done)
            for directory, path in zip(dirs, done["paths"]):
                if path is not None:
                    self._log(step, directory, path, seconds, done["writer_s"], False)

    def _blocking_save_multi(self, targets, step: int, state) -> List[Optional[str]]:
        """Blocking saves in the run's format: the host copy once for all
        targets."""
        host = host_state(state)
        if self._fmt == "delta":
            return [save_delta(d, step, host, store_root=self._store_root,
                               delta_max_chain=self._delta_max_chain, gc=self._gc, **kw)
                    for d, kw in targets]
        return [save_state(d, step, host, **kw) for d, kw in targets]

    def save(self, ckpt_dir: str, step: int, state, **kwargs) -> None:
        self.save_multi([(ckpt_dir, kwargs)], step, state)

    def save_multi(self, targets, step: int, state) -> None:
        """``targets = [(dir, kwargs), ...]`` from one snapshot in one
        writer task (async), or written here (sync).  The ``ckpt_enqueue``
        span is the loop's whole cost of the save: the snapshot and the
        enqueue (and any backpressure join), or the blocking save."""
        t0 = time.perf_counter()
        if self._acp is not None:
            try:
                with obs.span("ckpt_enqueue", step=int(step)):
                    self._acp.save_multi(targets, step, state)
            finally:
                self._report()
            seconds = time.perf_counter() - t0
            self._pending = (self._acp.seq, int(step), [d for d, _ in targets], seconds)
            self._note(seconds)
            return
        with obs.span("ckpt_enqueue", step=int(step)):
            paths = self._blocking_save_multi(targets, step, state)
        seconds = time.perf_counter() - t0
        self._note(seconds)
        for (directory, _), path in zip(targets, paths):
            if path is not None:
                self._log(step, directory, path, seconds, seconds, True)

    def _note(self, seconds: float) -> None:
        self._m_saves.labels(mode="async" if self._acp is not None else "sync").inc()
        self._m_stall.observe(seconds * 1e3)

    def save_sync(self, ckpt_dir: str, step: int, state, **kwargs) -> Optional[str]:
        """Join any in-flight save, then save on this thread; returns the
        path, or None when the save was refused (non-finite parameters) —
        for a save whose outcome gates what follows (``best.json``)."""
        with obs.span("ckpt_sync_save", step=int(step)):
            self.flush()
            t0 = time.perf_counter()
            path = self._blocking_save_multi([(ckpt_dir, kwargs)], step, state)[0]
        if path is not None:
            seconds = time.perf_counter() - t0
            self._log(step, ckpt_dir, path, seconds, seconds, True)
        return path

    def in_flight_depth(self) -> int:
        return int(self._acp is not None and self._acp.in_flight is not None)

    def flush(self) -> None:
        if self._acp is not None:
            try:
                self._acp.flush()
            finally:
                self._report()

    def close(self, raise_errors: bool = True) -> None:
        if self._acp is not None:
            try:
                self._acp.close(raise_errors=raise_errors)
            finally:
                self._report()


def _make_guard(cfg, logger: Logger) -> Optional[DivergenceGuard]:
    if cfg.guard_policy == "none":
        if cfg.guard_lr_backoff:
            # A silently ignored rung is worse than an error.
            raise ValueError(
                "--guard_lr_backoff needs an active guard (the ladder escalates "
                "INTO --guard_policy); pass --guard_policy halt|skip_step|rollback")
        return None
    return DivergenceGuard(cfg.guard_policy, cfg.guard_interval, logger,
                           max_rollbacks=cfg.guard_max_rollbacks,
                           lr_backoff=cfg.guard_lr_backoff,
                           backoff_recovery=cfg.guard_backoff_recovery)


class _StepBoundary:
    """What the loops do once per step or chunk, as the JAX loops'
    ``_StepBoundary`` on one process: the watchdog's heartbeat, the fault
    plan's step hooks over the ``n_steps`` that just ran, the guard's
    check (harvested flags with ``check_harvested``, else ``step``; it may
    revert ``state`` in place, or raise ``RollbackRequest``/
    ``DivergenceError``; a guard event fences the harvester's pending
    flags), then the stop flag and, on an otherwise clean boundary, the
    notice's proactive save, once (``on_notice(state)`` returns the saved
    step, kept as ``notice_step``).  Returns whether the run must stop;
    ``stop`` stays set.  Before the fault hooks, the run plane: the
    ``dwt_train_steps_total`` counter, the heartbeat and the alert rules
    (host-side numbers only); a guard event counts in
    ``dwt_guard_events_total{event}`` and, with ``flight_dir``, dumps the
    trailing span window there before any recovery runs (the flight
    recorder).  The whole call is the ``boundary`` span, the guard's
    check the nested ``guard_check``."""

    def __init__(self, guard, preempt, watchdog, notice_watcher, harvester=None,
                 logger: Optional[Logger] = None, heartbeat=None, alerts=None,
                 flight_dir: Optional[str] = None):
        self.guard = guard
        self.preempt = preempt
        self.watchdog = watchdog
        self.notice_watcher = notice_watcher
        self.harvester = harvester
        self._harvest_guard = (guard is not None and harvester is not None
                               and harvester.async_mode)
        self.coord = Coordinator()
        self.logger = logger
        self.heartbeat = heartbeat
        self.alerts = alerts
        self.flight_dir = flight_dir
        reg = get_registry()
        self._m_steps = reg.counter("dwt_train_steps_total", "optimizer steps completed")
        self._m_guard = reg.counter(
            "dwt_guard_events_total",
            "divergence-guard events by rung (local or remote-mirrored)",
            labelnames=("event",))
        self.on_notice = None
        self.notice_step: Optional[int] = None
        self._notice_handled = False
        self.stop = False

    def _flight(self, reason: str) -> None:
        """Dump the trailing span window into ``flight_dir`` under the
        watchdog's retention (``--watchdog_keep``): what led up to a guard
        event, before the recovery mutates the run."""
        if self.flight_dir:
            obs.flight_dump(self.flight_dir, reason, keep=self.watchdog.keep)

    def _check(self, state, metrics, n_steps: int, gstep: int) -> None:
        recoveries = self.guard.recoveries
        try:
            with obs.span("guard_check", "detail"):
                if self._harvest_guard:
                    self.guard.check_harvested(state, n_steps, gstep)
                else:
                    self.guard.step(state, metrics, n_steps, gstep)
        except (RollbackRequest, DivergenceError) as e:
            self._m_guard.labels(
                event="rollback" if isinstance(e, RollbackRequest) else "halt").inc()
            self._flight(f"guard_event_step{gstep}")
            self._fence()
            raise
        if self.guard.recoveries != recoveries:
            self._m_guard.labels(event="recovered").inc()
            self._flight(f"guard_event_step{gstep}")
            self._fence()

    def _fence(self) -> None:
        # Pending entries predate the recovery: their records still emit,
        # their flags must not re-trip the guard on the replayed segment.
        if self.harvester is not None:
            self.harvester.bump_generation()

    def _evaluate_alerts(self, gstep: int) -> None:
        """Fire/clear transitions as ``alert`` records; an engine failure
        degrades to a warning, never takes training down."""
        try:
            events = self.alerts.maybe_evaluate()
        except Exception as e:
            log.warning("alert evaluation failed: %s", e)
            return
        if self.logger is not None:
            for ev in events:
                self.logger("alert", gstep, **ev.record_fields())

    def __call__(self, state, metrics, n_steps: int, gstep: int) -> bool:
        with obs.span("boundary"):
            return self._run(state, metrics, n_steps, gstep)

    def _run(self, state, metrics, n_steps: int, gstep: int) -> bool:
        self.watchdog.heartbeat()
        self._m_steps.inc(n_steps)
        if self.heartbeat is not None:
            self.heartbeat.step(gstep)
        if self.alerts is not None:
            self._evaluate_alerts(gstep)
        # Between the heartbeat and the guard: a hang is measured from a
        # fresh beat, a SIGTERM is seen by this boundary's stop flag.
        inject.at_step(gstep - n_steps + 1, gstep)
        if self.guard is not None:
            self._check(state, metrics, n_steps, gstep)
        decision = self.coord.decide(stop=self.preempt.should_stop,
                                     notice=self.notice_watcher.noticed)
        self.stop = self.stop or decision.stop
        if decision.notice and not self.stop and not self._notice_handled:
            self._notice_handled = True
            if self.on_notice is not None:
                self.notice_step = self.on_notice(state)
        return self.stop


# Seed stride between rollback attempts (the JAX loops'): the replayed
# segment draws a new shuffle order from the same position.
_ROLLBACK_SEED_STRIDE = 7919


def _chunk_stream(batches, k: int, should_cut=None, start: int = 0):
    """Group host batches into stacked ``[<= k, ...]`` chunks for the
    k-steps-per-dispatch path.  ``should_cut(index)`` ends a chunk after
    the batch at global index ``index``, so per-step cadences (evals,
    saves) land on chunk boundaries; the stream's end yields the rest."""
    chunk = []
    i = start
    for b in batches:
        chunk.append(b)
        if len(chunk) == k or (should_cut is not None and should_cut(i)):
            yield stack_batches(chunk)
            chunk = []
        i += 1
    if chunk:
        yield stack_batches(chunk)


def _run_chunks(chunks, scanned, state, on_steps) -> None:
    """Drive the k-steps-per-dispatch path: each chunk through ``scanned``
    (``steps.make_scanned_step``), then ``on_steps(n, stacked metrics)``
    for the records and the boundary; it returns whether to stop.  The
    ``step_dispatch`` span wraps the whole dispatch from outside (on the
    card the graph's replays: a capture never runs a span's Python)."""
    for chunk in obs.traced_iter(chunks, "batch_wait"):
        n = next(iter(chunk.values())).shape[0]
        with obs.span("step_dispatch", n=n):
            ms = scanned(state, chunk)
        if on_steps(n, ms):
            break


def _train_emit(logger: Logger, keys, idxs) -> Callable:
    """The emit closure of one harvested entry: for each ``(row, step,
    fields)`` of ``idxs`` a ``train`` record at ``step`` with ``fields``
    and the host copies of ``keys`` (row None: scalars; else that row of
    a chunk's ``[n]``); the record's ``*_loss`` values also feed the
    ``dwt_train_loss`` gauge."""

    def emit(vals):
        for row, step_no, fields in idxs:
            values = {k: float(vals[k] if row is None else vals[k][row]) for k in keys}
            logger("train", step_no, **fields, **values)
            _note_losses(**{k: v for k, v in values.items() if k.endswith("_loss")})

    return emit


def _seek_data_plane(plane: DataPlane, ckpt_dir, source: str, step: int,
                     fallback_epoch: int, arith_ok: bool) -> str:
    """Re-open the data plane after a rollback's restore; returns the mode:
    ``exact`` (the restored checkpoint's ``data_state``), ``exact_arith``
    (an in-memory snapshot of a step-aligned run: positions are functions
    of the step) or ``epoch_boundary`` (neither: a logged downgrade)."""
    if source == "memory":
        if arith_ok:
            plane.seek_step(step)
            return "exact_arith"
    else:
        directory = ckpt_dir if source == "checkpoint" else anchor_dir(ckpt_dir)
        if plane.load_snapshot(load_data_state(os.path.join(directory, str(step)))):
            return "exact"
    plane.seek_epoch(fallback_epoch)
    log.warning("rollback to step %d (%s): no exact data position; the streams "
                "resume at the epoch boundary", step, source)
    return "epoch_boundary"


def _rollback_state(cfg, logger: Logger, guard: DivergenceGuard, state: TrainState,
                    failed_step: int) -> str:
    """Restore, in place, the newest valid on-disk checkpoint (anchors
    included), else the guard's in-memory good state; returns the source
    (``checkpoint``, ``anchor`` or ``memory``).  The caller has flushed
    the writer, so the newest save is on disk and nothing races the
    walk."""
    source = None
    if cfg.ckpt_dir:
        ranked = ranked_checkpoints(cfg.ckpt_dir)
        if ranked:
            source = restore_newest(cfg.ckpt_dir, state, ranked).source
    if source is None:
        if not guard.has_good_state:
            raise DivergenceError(
                f"divergence at step {failed_step} with nothing to roll back to "
                "(no valid checkpoint, no in-memory snapshot)")
        guard.restore_good(state)
        source = "memory"
    # The saved scale predates the divergence; a backed-off ladder replays
    # gently.
    guard.reapply_backoff(state)
    guard.prime(state)
    logger("rollback", state.step, from_step=failed_step, source=source,
           rollbacks=guard.rollbacks)
    return source


@contextlib.contextmanager
def _resilience(cfg, pipeline: _CkptPipeline):
    """The run's preemption handler, hang watchdog and notice watcher; on
    any exit the writer is joined (an abnormal exit's writer error, already
    logged, does not mask the original exception)."""
    with PreemptionHandler() as preempt, HangWatchdog(
            cfg.watchdog_timeout, cfg.ckpt_dir, keep=cfg.watchdog_keep) as wd, \
            NoticeWatcher(cfg.preempt_notice_file, cfg.preempt_notice_metadata) as nw:
        try:
            yield preempt, wd, nw
        except BaseException:
            pipeline.close(raise_errors=False)
            raise


def _preempt_exit(cfg, pipeline: _CkptPipeline, wd, boundary: _StepBoundary,
                  state: TrainState, plane: DataPlane) -> Optional[int]:
    """The stop path: join the writer (a stale writer error, already logged,
    must not block the final save), then save at the stop step unless the
    notice's proactive save is durable, and flush — all with the watchdog
    masked.  Returns the notice save's step when it stands in for the
    final save."""
    if not cfg.ckpt_dir:
        return None
    with wd.suspended():
        pipeline.close(raise_errors=False)
        resume_step = boundary.notice_step
        if resume_step is not None and not is_valid_checkpoint(
                os.path.join(cfg.ckpt_dir, str(resume_step))):
            resume_step = None
        if resume_step is None:
            pipeline.save(cfg.ckpt_dir, state.step, state,
                          data_state=plane.snapshot(), **_keep_kwargs(cfg))
        pipeline.flush()
    return resume_step


def _resume(cfg, state: TrainState, plane: DataPlane, ranked,
            fallback_epoch) -> Tuple[Restored, str, float]:
    """Restore the newest valid checkpoint of ``cfg.ckpt_dir`` (main or
    anchors) into ``state`` and re-open the data plane where the saved
    run stood: at the manifest's ``data_state`` (``"exact"``), else at the
    epoch boundary ``fallback_epoch(step)``, logged as a downgrade.
    Returns the restore, the data mode and the restore's seconds."""
    t0 = time.perf_counter()
    restored = restore_newest(cfg.ckpt_dir, state, ranked)
    seconds = time.perf_counter() - t0
    if plane.load_snapshot(load_data_state(restored.path)):
        return restored, "exact", seconds
    plane.seek_epoch(fallback_epoch(state.step))
    log.warning(
        "checkpoint %s has no usable data_state: resuming the data streams "
        "at the epoch boundary; the position within the epoch is lost",
        restored.path)
    return restored, "epoch_boundary", seconds


def _quarantine_registry(cfg) -> Optional[QuarantineRegistry]:
    """The run's quarantine record under ``ckpt_dir``; None keeps it in
    memory."""
    return QuarantineRegistry.for_ckpt_dir(cfg.ckpt_dir) if cfg.ckpt_dir else None


def _best_record_path(ckpt_dir: str) -> str:
    return os.path.join(ckpt_dir, "best.json")


def _write_best_record(ckpt_dir: str, accuracy: float, step: int) -> None:
    """Persist the best accuracy, so a resumed run cannot regress the
    best-accuracy artifact by restarting its comparison from -1."""
    path = _best_record_path(ckpt_dir)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"accuracy": accuracy, "step": step}, f)
    os.replace(tmp, path)


def _read_best_record(ckpt_dir: str) -> float:
    try:
        with open(_best_record_path(ckpt_dir)) as f:
            return float(json.load(f)["accuracy"])
    except (OSError, ValueError, TypeError, KeyError):
        return -1.0


def _synthetic_classification_arrays(
    n: int, shape: Tuple[int, ...], num_classes: int, seed: int, shift: float = 0.0
):
    """Class-structured random images: class k brightens a k-dependent
    stripe, so a real signal exists for the loss to learn.  Numpy only:
    the arrays equal the JAX package's for the same arguments."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, num_classes, size=(n,))
    images = rng.normal(scale=0.3, size=(n,) + shape).astype(np.float32) + shift
    rows = shape[0]
    band = max(rows // (2 * num_classes), 1)
    for i, k in enumerate(labels):
        r = (k * rows) // num_classes
        images[i, r : r + band, :, :] += 1.5
    return images, labels.astype(np.int64)


def _digits_datasets(cfg: DigitsConfig):
    """``(source train, target train, target test)`` datasets."""
    if cfg.synthetic:
        n = cfg.synthetic_size
        shape = (28, 28, 1)
        src = _synthetic_classification_arrays(n, shape, 10, cfg.seed)
        tgt = _synthetic_classification_arrays(n, shape, 10, cfg.seed + 1, 0.5)
        tgt_test = _synthetic_classification_arrays(
            n // 2, shape, 10, cfg.seed + 2, 0.5
        )
        return ArrayDataset(*src), ArrayDataset(*tgt), ArrayDataset(*tgt_test)

    # Normalizations per the reference loaders (usps_mnist.py:356-388):
    # MNIST (0.1307, 0.3081); USPS (0.5, 0.5).
    def load(name: str, train: bool) -> ArrayDataset:
        if name == "mnist":
            x, y = load_mnist(f"{cfg.data_root}/mnist", train=train)
            x = (x - 0.1307) / 0.3081
        elif name == "usps":
            x, y = load_usps(f"{cfg.data_root}/usps", train=train, seed=cfg.seed)
            x = (x - 0.5) / 0.5
        else:
            raise ValueError(f"unknown digits dataset {name!r}")
        return ArrayDataset(x.astype(np.float32), y)

    return load(cfg.source, True), load(cfg.target, True), load(cfg.target, False)


def build_digits_model(cfg: DigitsConfig) -> nn.Module:
    """The config's LeNet-DWT (its compute dtype and whitener), freshly
    initialized from ``cfg.seed``."""
    return build_lenet(group_size=cfg.group_size, seed=cfg.seed,
                       momentum=cfg.running_momentum,
                       dtype=model_dtype(resolve_compute_dtype(cfg)),
                       whitener=cfg.whitener)


def run_digits(
    cfg: DigitsConfig,
    logger: Optional[Logger] = None,
    model: Optional[nn.Module] = None,
) -> float:
    """Train LeNet-DWT with the entropy loss; returns the target test
    accuracy (%) after the last epoch (after the last finished epoch when
    a SIGTERM ends the run early).

    ``model`` (default :func:`build_digits_model`) is trained in place: it
    is moved to the device, its convs to channels_last memory format."""
    logger = logger or _log_record
    obs.maybe_enable(cfg.obs_trace)
    alert_engine = _setup_metrics_plane(cfg, logger)
    _note_inert(cfg)
    if cfg.group_size == 32:
        # The reference's argparse default (usps_mnist.py:348), kept; every
        # published digits accuracy uses 4 (its README), and 32 does not
        # divide the 48 channels of conv2's site.
        logger("warning", 0,
               message="group_size=32 is the reference's argparse default, "
                       "but all published digits results use --group_size 4")
    if cfg.source == cfg.target:
        raise ValueError("source and target datasets can not be the same")
    if cfg.source_batch_size != cfg.target_batch_size:
        raise ValueError(
            "domain-split training needs equal source/target batch sizes")
    device = resolve_device(cfg.device)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    source_ds, target_ds, test_ds = _digits_datasets(cfg)
    source_ds = inject.wrap_dataset(source_ds, "source")
    target_ds = inject.wrap_dataset(target_ds, "target")
    bs = cfg.source_batch_size
    steps_per_epoch = min(len(source_ds), len(target_ds)) // bs
    if steps_per_epoch == 0:
        raise ValueError("datasets smaller than one batch")
    if model is None:
        model = build_digits_model(cfg)
    model.to(device, memory_format=torch.channels_last)
    optimizer, schedules = digits_tx(model, cfg, steps_per_epoch)
    state = TrainState(model, optimizer, schedules)
    train_step = make_digits_train_step(model, cfg.lambda_entropy_loss)
    k_dispatch = max(1, cfg.steps_per_dispatch)
    scanned = make_scanned_step(train_step, k_dispatch) if k_dispatch > 1 else None
    evalp = EvalPipeline(cfg.test_batch_size, device, num_domains=2,
                         num_workers=cfg.num_workers,
                         eval_k=cfg.eval_steps_per_dispatch)
    # Both streams roll over at the zip's length, so a stream's position
    # is a function of the step.
    plane = DataPlane(num_workers=cfg.num_workers,
                      quarantine_registry=_quarantine_registry(cfg),
                      stall_timeout=cfg.data_stall_timeout)
    plane.register("source", seed=cfg.seed, epoch_len=steps_per_epoch)
    plane.register("target", seed=cfg.seed + 1, epoch_len=steps_per_epoch)

    epoch = 0
    ranked = ranked_checkpoints(cfg.ckpt_dir) if cfg.ckpt_dir else []
    data_mode = None
    if ranked:
        restored, data_mode, seconds = _resume(
            cfg, state, plane, ranked, lambda step: step // steps_per_epoch)
        epoch = plane.streams["source"].epoch
        logger("resume", state.step, epoch=epoch, source=restored.source,
               data=data_mode, cursor=plane.streams["source"].cursor,
               restore_s=seconds)
    if epoch >= cfg.epochs:
        # Resumed from a finished run: report the restored model's
        # accuracy instead of training.
        result = evalp.evaluate(state, test_ds)
        _note_accuracy(result["accuracy"])
        logger("test", state.step, epoch=epoch, **result)
        _log_params_digest(logger, state.step, model, cfg.ckpt_dir)
        obs.export()
        return result["accuracy"]

    guard = _make_guard(cfg, logger)
    if guard:
        guard.prime(state)
    pipeline = _CkptPipeline(cfg, logger)
    # A resumed run continues its recorded seed lineage.
    bump0 = plane.seed_bump
    # Stream position == divmod(step) unless the resume fell back to an
    # epoch boundary (or an in-memory recovery rewound the step).
    step_aligned = data_mode != "epoch_boundary"
    gstep = state.step  # the host's step count: records and fault hooks
    acc = 0.0
    harvester = make_harvester(cfg, guard)
    flag_mode = guard is not None and harvester.async_mode
    if flag_mode:
        guard.enable_harvest(harvester.depth, gstep, floor_fn=harvester.pending_floor)
    keys = ("loss", "cls_loss", "entropy_loss", "grad_norm")
    with _resilience(cfg, pipeline) as (preempt, wd, nw):
        boundary = _StepBoundary(
            guard, preempt, wd, nw, harvester, logger=logger, alerts=alert_engine,
            heartbeat=HeartbeatEmitter(logger, cfg.heartbeat_every,
                                       pipeline.in_flight_depth),
            flight_dir=os.path.join(cfg.ckpt_dir, "watchdog") if cfg.ckpt_dir else None)

        def proactive_save(st):
            # A preemption notice: save now and keep training; the SIGTERM
            # that follows exits with this checkpoint already durable.
            if not cfg.ckpt_dir:
                return None
            harvester.drain()  # a checkpoint boundary: the records first
            with wd.suspended():
                pipeline.save(cfg.ckpt_dir, st.step, st,
                              data_state=plane.snapshot(), **_keep_kwargs(cfg))
            logger("notice_save", st.step, epoch=epoch)
            return st.step

        boundary.on_notice = proactive_save
        while epoch < cfg.epochs:
            # Each stream opens at the plane's position and shuffles anew each
            # epoch, from its own seed; the zip ends with the shorter one.
            source = plane.epoch_iterator(source_ds, "source", bs)
            target = plane.epoch_iterator(target_ds, "target", bs)
            epoch_batches = ({
                "source_x": np.asarray(sx, np.float32),
                "source_y": np.asarray(sy, np.int64),
                "target_x": np.asarray(tx_img, np.float32),
            } for (sx, sy), (tx_img, _) in zip(source, target))
            batches = None
            try:
                if scanned is None:
                    batches = prefetch_to_device(epoch_batches, device=device)
                    for i, batch in enumerate(obs.traced_iter(batches, "batch_wait")):
                        with obs.span("step_dispatch"):
                            metrics = train_step(state, batch)
                        gstep += 1
                        plane.advance(1)
                        state, metrics = inject.maybe_nan(state, metrics, gstep)
                        values = emit = None
                        if i % cfg.log_interval == 0:
                            values = {k: metrics[k] for k in keys}
                            emit = _train_emit(logger, keys, [(None, gstep, {"epoch": epoch})])
                        harvester.put(gstep, gstep, values=values,
                                      flag=metrics["finite"] if flag_mode else None, emit=emit)
                        if boundary(state, metrics, 1, gstep):
                            break
                else:
                    # k steps per dispatch: record steps from the host's
                    # numbering at the epoch's start (JAX's chunked path),
                    # the boundary once per chunk.
                    pos, step0 = 0, state.step

                    def on_steps(n, ms):
                        nonlocal pos, gstep
                        lo = gstep + 1
                        gstep += n
                        plane.advance(n)
                        _, ms = inject.maybe_nan(state, ms, lo, gstep)
                        idxs = [(j - pos, step0 + j + 1, {"epoch": epoch})
                                for j in range(pos, pos + n) if j % cfg.log_interval == 0]
                        values = emit = None
                        if idxs:
                            values = {k: ms[k] for k in keys}
                            emit = _train_emit(logger, keys, idxs)
                        harvester.put(lo, gstep, values=values,
                                      flag=ms["finite"] if flag_mode else None, emit=emit)
                        pos += n
                        return boundary(state, ms, n, gstep)

                    batches = prefetch_to_device(
                        _chunk_stream(epoch_batches, k_dispatch), device=device)
                    _run_chunks(batches, scanned, state, on_steps)
            except RollbackRequest as rb:
                # The pending records narrate the steps into the divergence
                # (their flags are fenced); the restore rewinds the numbering.
                harvester.drain()
                harvester.reset_stamps()
                with wd.suspended():  # the join waits for the in-flight write
                    pipeline.close(raise_errors=False)
                source_kind = _rollback_state(cfg, logger, guard, state, rb.step)
                wd.heartbeat()
                gstep = state.step
                mode = _seek_data_plane(
                    plane, cfg.ckpt_dir, source_kind, gstep, gstep // steps_per_epoch,
                    arith_ok=step_aligned and guard.recoveries == 0)
                step_aligned = step_aligned and mode != "epoch_boundary"
                plane.seed_bump = bump0 + guard.rollbacks * _ROLLBACK_SEED_STRIDE
                epoch = plane.streams["source"].epoch
                continue
            finally:
                # Every exit, a halt's included: each pending record emits
                # once, in order, before any boundary record.
                harvester.drain()
                if batches is not None:
                    batches.close()
                source.close()
                target.close()
            if boundary.stop:
                # Preemption: save and get out, skipping the epoch's eval.
                resume_step = _preempt_exit(cfg, pipeline, wd, boundary, state, plane)
                logger("preempt", state.step, epoch=epoch,
                       **({} if resume_step is None else {"resume_step": resume_step}))
                obs.export()  # the spans survive the exit (grace window)
                return acc
            with obs.span("eval_pass", imgs=len(test_ds)):
                result = evalp.evaluate(state, test_ds)
            wd.heartbeat()  # an eval is progress, not a stall
            acc = result["accuracy"]
            _note_accuracy(acc)
            logger("test", state.step, epoch=epoch, **result)
            if cfg.ckpt_dir:
                data_state = plane.snapshot()
                targets = []
                if (epoch + 1) % cfg.ckpt_every_epochs == 0 or epoch == cfg.epochs - 1:
                    targets.append((cfg.ckpt_dir, {**_keep_kwargs(cfg),
                                                   "data_state": data_state}))
                if cfg.anchor_every and (epoch + 1) % cfg.anchor_every == 0:
                    targets.append((anchor_dir(cfg.ckpt_dir), {"data_state": data_state}))
                if targets:
                    with wd.suspended():  # a blocking save may outlast the timeout
                        pipeline.save_multi(targets, state.step, state)
            epoch += 1
        with wd.suspended():
            pipeline.flush()  # a writer failure surfaces while the run can fail
    _log_params_digest(logger, state.step, model, cfg.ckpt_dir)
    obs.export()  # the normal exit's trace (a no-op when tracing is off)
    return acc


def _officehome_datasets(cfg: OfficeHomeConfig):
    """``(source, target with its augmented view, test)`` datasets: the
    synthetic arrays, or the two image folders."""
    if cfg.synthetic:
        n = cfg.synthetic_size
        shape = (cfg.img_crop_size, cfg.img_crop_size, 3)
        src = _synthetic_classification_arrays(n, shape, cfg.num_classes, cfg.seed)
        tgt_x, tgt_y = _synthetic_classification_arrays(
            n, shape, cfg.num_classes, cfg.seed + 1, 0.5
        )
        rng = ThreadLocalRng(cfg.seed + 9)  # reseeded per item by the loader
        aug = lambda a: gaussian_blur(random_affine(a, rng=rng))
        source_ds = ArrayDataset(*src)
        target_ds = ArrayDataset(tgt_x, tgt_y, transform_aug=aug)
        test_ds = ArrayDataset(
            *_synthetic_classification_arrays(
                n // 2, shape, cfg.num_classes, cfg.seed + 2, 0.5
            )
        )
        return source_ds, target_ds, test_ds

    mean = [0.485, 0.456, 0.406]
    std = [0.229, 0.224, 0.225]
    rng = ThreadLocalRng(cfg.seed)
    # The source and test transform (resnet50…py:527-532) and the target's
    # augmented view (:535-543), each ending in one native pass over the
    # uint8 crop.
    base_tf = Compose([
        Resize(cfg.img_resize),
        RandomCrop(cfg.img_crop_size, rng=rng),
        FusedToArrayNormalize(mean, std),
    ])
    aug_tf = Compose([
        Resize(cfg.img_resize),
        RandomCrop(cfg.img_crop_size, rng=rng),
        RandomHorizontalFlip(rng=rng),
        FusedAffineBlurNormalize(mean, std, rng=rng),
    ])
    source_ds = ImageFolderDataset(cfg.s_dset_path, transform=base_tf)
    target_ds = ImageFolderDataset(
        cfg.t_dset_path, transform=base_tf, transform_aug=aug_tf
    )
    test_ds = ImageFolderDataset(cfg.t_dset_path, transform=base_tf)
    return source_ds, target_ds, test_ds


def officehome_batches(plane: DataPlane, source_ds, target_ds, batch_size: int,
                       steps: int):
    """``steps`` train batches of the three streams, from the plane's
    position: the target stream carries its augmented view."""
    source = plane.stream(source_ds, "source", batch_size)
    target = plane.stream(target_ds, "target", batch_size)
    try:
        for _ in range(steps):
            sx, sy = next(source)
            tx_img, tx_aug, _ = next(target)
            yield {
                "source_x": np.asarray(sx, np.float32),
                "source_y": np.asarray(sy, np.int64),
                "target_x": np.asarray(tx_img, np.float32),
                "target_aug_x": np.asarray(tx_aug, np.float32),
            }
    finally:
        source.close()
        target.close()


def officehome_plane(cfg: OfficeHomeConfig, source_ds, target_ds) -> DataPlane:
    """The run's data plane: the source at ``seed``, the target at
    ``seed + 1`` and its augmented view as an alias of the target, each
    rolling over at its own dataset's batch count; with ``ckpt_dir``,
    quarantined items are recorded there."""
    bs = cfg.source_batch_size  # the target stream uses the source's too
    source_len = epoch_batch_count(len(source_ds), bs)
    target_len = epoch_batch_count(len(target_ds), bs)
    if min(source_len, target_len) == 0:
        raise ValueError("datasets smaller than one batch")
    plane = DataPlane(num_workers=cfg.num_workers,
                      quarantine_registry=_quarantine_registry(cfg),
                      stall_timeout=cfg.data_stall_timeout)
    plane.register("source", seed=cfg.seed, epoch_len=source_len)
    plane.register("target", seed=cfg.seed + 1, epoch_len=target_len)
    plane.register("target_aug", seed=cfg.seed + 1, epoch_len=target_len,
                   alias_of="target")
    return plane


def build_model(cfg: OfficeHomeConfig) -> nn.Module:
    """The config's backbone through the registry (``backbone`` wins over
    ``arch``; its compute dtype, whitener, remat and padded head, and
    ``pos_embed`` sized for the crop), freshly initialized from
    ``cfg.seed``."""
    return build_backbone(
        cfg.backbone or cfg.arch, num_classes=cfg.num_classes,
        group_size=cfg.group_size, seed=cfg.seed, momentum=cfg.running_momentum,
        dtype=model_dtype(resolve_compute_dtype(cfg)), whitener=cfg.whitener,
        remat=cfg.remat, pad_classes_to=cfg.pad_classes_to,
        image_size=cfg.img_crop_size,
    )


def run_officehome(
    cfg: OfficeHomeConfig,
    logger: Optional[Logger] = None,
    model: Optional[nn.Module] = None,
) -> float:
    """Train the config's backbone with MEC; returns the final target test
    accuracy (%) (the last eval's when a SIGTERM ends the run early).

    ``model`` (default :func:`build_model`) is trained in place: it is
    moved to the device, its convs to channels_last memory format, and
    a resume, ``init_ckpt`` or ``resnet_path`` loads into it."""
    logger = logger or _log_record
    obs.maybe_enable(cfg.obs_trace)
    alert_engine = _setup_metrics_plane(cfg, logger)
    _note_inert(cfg)
    device = resolve_device(cfg.device)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    source_ds, target_ds, test_ds = _officehome_datasets(cfg)
    source_ds = inject.wrap_dataset(source_ds, "source")
    target_ds = inject.wrap_dataset(target_ds, "target")
    plane = officehome_plane(cfg, source_ds, target_ds)
    if model is None:
        model = build_model(cfg)
    model.to(device, memory_format=torch.channels_last)
    optimizer, schedules = officehome_tx(model, cfg)
    state = TrainState(model, optimizer, schedules)
    train_step = make_officehome_train_step(model, cfg.lambda_mec_loss)
    k_dispatch = max(1, cfg.steps_per_dispatch)
    scanned = make_scanned_step(train_step, k_dispatch)
    evalp = EvalPipeline(cfg.test_batch_size, device, num_domains=3,
                         num_workers=cfg.num_workers,
                         eval_k=cfg.eval_steps_per_dispatch)

    # The initial state: a resume beats init_ckpt, which beats the
    # reference checkpoint, which beats fresh init.
    ranked = ranked_checkpoints(cfg.ckpt_dir) if cfg.ckpt_dir else []
    if cfg.init_ckpt and not ranked:
        # A JAX package's checkpoint gives its parameters and stats.
        restore_state(cfg.init_ckpt, state, jax_params=True)
        state.step = 0
        logger("init_ckpt", 0, detail=cfg.init_ckpt)
    elif cfg.resnet_path and not cfg.synthetic and not ranked:
        if os.path.exists(cfg.resnet_path):
            _, report = convert_resnet_state_dict(
                load_pytorch_checkpoint(cfg.resnet_path), model, num_domains=3)
            logger("checkpoint_convert", 0, detail=report.summary())
        else:
            logger("checkpoint_convert", 0,
                   detail="resnet_path missing; training from fresh init")
    start_iter, best_acc, data_mode = 0, -1.0, None
    if ranked:
        restored, data_mode, seconds = _resume(cfg, state, plane, ranked,
                                               lambda step: 0)
        start_iter = state.step
        # Only a resume inherits the best record: a fresh run in a used
        # directory would otherwise never beat a dead run's best.
        best_acc = _read_best_record(cfg.ckpt_dir)
        logger("resume", start_iter, source=restored.source, data=data_mode,
               cursor=plane.streams["target"].cursor, restore_s=seconds)

    guard = _make_guard(cfg, logger)
    if guard:
        guard.prime(state)
    pipeline = _CkptPipeline(cfg, logger)
    bump0 = plane.seed_bump
    step_aligned = data_mode != "epoch_boundary"
    acc = 0.0
    harvester = make_harvester(cfg, guard)
    flag_mode = guard is not None and harvester.async_mode
    if flag_mode:
        guard.enable_harvest(harvester.depth, state.step,
                             floor_fn=harvester.pending_floor)
    keys = ("loss", "cls_loss", "mec_loss", "grad_norm")

    def ckpt_targets(it):
        targets = []
        if cfg.ckpt_dir and (it + 1) % cfg.ckpt_every_iters == 0:
            targets.append((cfg.ckpt_dir, _keep_kwargs(cfg)))
        if cfg.ckpt_dir and cfg.anchor_every and (it + 1) % cfg.anchor_every == 0:
            targets.append((anchor_dir(cfg.ckpt_dir), {}))
        return targets

    def should_cut(it):
        # Chunks end where an eval or a save is due, so the cadences are
        # the per-step ones; the boundary and its actions run per chunk
        # (at k = 1, per step).
        return (it + 1) % cfg.check_acc_step == 0 or bool(ckpt_targets(it))

    with _resilience(cfg, pipeline) as (preempt, wd, nw):
        boundary = _StepBoundary(
            guard, preempt, wd, nw, harvester, logger=logger, alerts=alert_engine,
            heartbeat=HeartbeatEmitter(logger, cfg.heartbeat_every,
                                       pipeline.in_flight_depth),
            flight_dir=os.path.join(cfg.ckpt_dir, "watchdog") if cfg.ckpt_dir else None)

        def proactive_save(st):
            if not cfg.ckpt_dir:
                return None
            harvester.drain()  # a checkpoint boundary: the records first
            with wd.suspended():
                pipeline.save(cfg.ckpt_dir, st.step, st,
                              data_state=plane.snapshot(), **_keep_kwargs(cfg))
            logger("notice_save", st.step)
            return st.step

        def boundary_actions(it):
            """The eval, the best-accuracy save and the cadence saves after
            the step at iteration ``it``."""
            nonlocal acc, best_acc
            do_eval = (it + 1) % cfg.check_acc_step == 0
            targets = ckpt_targets(it)
            if do_eval or targets:
                # The train records land before the test and checkpoint
                # records they precede.
                harvester.drain()
            if do_eval:
                with obs.span("eval_pass", imgs=len(test_ds)):
                    result = evalp.evaluate(state, test_ds)
                wd.heartbeat()
                acc = result["accuracy"]
                _note_accuracy(acc)
                logger("test", state.step, iter=it, **result)
                if cfg.ckpt_dir and acc > best_acc:
                    # The reference's model_best_gr_N: the highest target
                    # accuracy's state.  Blocking, so that best.json names
                    # only an artifact that was written (a refused,
                    # non-finite save is not).
                    with wd.suspended():
                        best = pipeline.save_sync(
                            os.path.join(cfg.ckpt_dir, f"best_gr_{cfg.group_size}"),
                            state.step, state, keep=1, data_state=plane.snapshot())
                    if best is not None:
                        best_acc = acc
                        _write_best_record(cfg.ckpt_dir, acc, state.step)
                        logger("best", state.step, accuracy=acc)
            if targets:
                data_state = plane.snapshot()
                with wd.suspended():
                    pipeline.save_multi([(d, {**kw, "data_state": data_state})
                                         for d, kw in targets], state.step, state)

        boundary.on_notice = proactive_save
        # Each attempt opens fresh streams at the plane's (re-sought,
        # reseeded) position; a RollbackRequest restores and retries.
        while True:
            # The host's step numbering: step0 + it + 1 (an in-memory
            # recovery rewinds state.step, not the iteration).
            step0 = state.step - start_iter
            produce = officehome_batches(plane, source_ds, target_ds,
                                         cfg.source_batch_size, cfg.num_iters - start_iter)
            batches = None
            try:
                it = start_iter

                def on_steps(n, ms):
                    nonlocal it
                    # The plane's position is the next batch the loop trains
                    # on, whatever the prefetch thread has built: what a save
                    # records.
                    plane.advance(n)
                    _, ms = inject.maybe_nan(state, ms, step0 + it + 1, step0 + it + n)
                    idxs = [(j, step0 + it + j + 1, {"iter": it + j})
                            for j in range(n) if (it + j) % cfg.log_interval == 0]
                    values = emit = None
                    if idxs:
                        values = {k: ms[k] for k in keys}
                        emit = _train_emit(logger, keys, idxs)
                    harvester.put(step0 + it + 1, step0 + it + n, values=values,
                                  flag=ms["finite"] if flag_mode else None, emit=emit)
                    it += n
                    stop = boundary(state, ms, n, step0 + it)
                    boundary_actions(it - 1)
                    return stop

                batches = prefetch_to_device(
                    _chunk_stream(produce, k_dispatch, should_cut, start=start_iter),
                    device=device)
                _run_chunks(batches, scanned, state, on_steps)
            except RollbackRequest as rb:
                harvester.drain()
                harvester.reset_stamps()  # the restore rewinds the numbering
                with wd.suspended():
                    pipeline.close(raise_errors=False)
                source_kind = _rollback_state(cfg, logger, guard, state, rb.step)
                wd.heartbeat()
                start_iter = state.step
                mode = _seek_data_plane(plane, cfg.ckpt_dir, source_kind, start_iter, 0,
                                        arith_ok=step_aligned and guard.recoveries == 0)
                step_aligned = step_aligned and mode != "epoch_boundary"
                plane.seed_bump = bump0 + guard.rollbacks * _ROLLBACK_SEED_STRIDE
                continue
            finally:
                harvester.drain()  # every exit (digits' finally)
                if batches is not None:
                    batches.close()
                produce.close()
            break
        if boundary.stop:
            # Save and get out; the stat collection is a resumed run's.
            resume_step = _preempt_exit(cfg, pipeline, wd, boundary, state, plane)
            logger("preempt", state.step,
                   **({} if resume_step is None else {"resume_step": resume_step}))
            obs.export()  # the spans survive the exit (grace window)
            return acc
        with wd.suspended():
            pipeline.flush()

    # Post-training protocol: passes over the target TEST set with the
    # batch tiled into every domain slot re-estimate the target stats
    # (resnet50…py:380-389).
    online = not get_whitener(cfg.whitener).needs_stat_collection
    if cfg.stat_collection_passes == 0:
        # Recorded as skipped for every whitener, as the JAX loop records
        # it (for swbn, its cadence: the tracked matrices and the BN
        # running stats are the eval estimates).
        logger("stat_collection", state.step, skipped=True,
               whitener=cfg.whitener)
    elif online:
        logger("warning", state.step,
               message=f"--whitener {cfg.whitener} runs eval off its online "
                       f"running estimates; --stat_collection_passes "
                       f"{cfg.stat_collection_passes} re-estimation passes "
                       "are unnecessary (pass 0 to skip the phase)")
    for p in range(cfg.stat_collection_passes):
        t0 = time.perf_counter()
        with obs.span("stat_collection", pass_index=p):
            forwards = evalp.collect_stats(state, test_ds, seed=cfg.seed, epoch=p)
            if device.type == "cuda":
                # The phase's own rendezvous (the record times the work,
                # not its enqueue); the span only observes it.
                torch.cuda.synchronize(device)
        logger("stat_collection", state.step, pass_index=p, imgs=len(test_ds),
               forwards=forwards, seconds=round(time.perf_counter() - t0, 3))
    with obs.span("eval_pass", imgs=len(test_ds)):
        result = evalp.evaluate(state, test_ds)
    acc = result["accuracy"]
    _note_accuracy(acc)
    logger("final_test", state.step, **result)
    _log_params_digest(logger, state.step, model, cfg.ckpt_dir)
    if cfg.ckpt_dir:
        # The post-collection state is the run's deployable artifact.
        pipeline.save(cfg.ckpt_dir, state.step, state,
                      data_state=plane.snapshot(), **_keep_kwargs(cfg))
        pipeline.flush()
    obs.export()  # the normal exit's trace (a no-op when tracing is off)
    return acc
