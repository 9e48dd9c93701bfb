"""Job-slot supervisor: the fleet's respawn/probe machinery generalized
from HTTP replicas to preemptible training subprocesses — the port of
``dwt_tpu.sweep.supervisor``, every name and path contract kept.

Mapping from the serving fleet (``dwt_tpu_torch/fleet/balancer.py``):

* replica slot → **job slot** (``--slots`` concurrent training
  subprocesses; the pair matrix queues behind them);
* ``/healthz`` probe → **heartbeat liveness**: a job proves life by
  appending to its metrics JSONL (every ``train``/``heartbeat`` record
  bumps the mtime); a job silent past ``--job_stall_timeout_s`` is
  SIGKILLed and charged a crash;
* :class:`~dwt_tpu_torch.fleet.balancer.Respawner` →
  :class:`~dwt_tpu_torch.fleet.retry.RespawnBudget` per pair: crashes back
  off exponentially and quarantine the pair after
  ``--job_max_respawns`` — the rest of the matrix completes;
* balancer ``/metrics`` → the aggregated scrape surface: the
  supervisor's own registry merged with every running job's exposition
  under a ``pair`` label (``obs.prom.merge_expositions``).

Preemption is FREE: a job that exits 0 with a ``preempt`` record in its
JSONL (the loops' SIGTERM save-and-exit contract) is rescheduled without
touching its crash budget — its resume is exact (the checkpoint's
``data_state``), so the matrix's results are identical to an
undisturbed sweep's.  The supervisor itself is preemptible too: every
scheduling decision is journaled atomically BEFORE the spawn
(:mod:`~dwt_tpu_torch.sweep.journal`), so a SIGKILLed supervisor relaunches,
adopts still-running jobs (pid + cmdline-token check), and reschedules
the rest.

All jobs share one CAS blob store (``--blob_store`` on the training
CLI): per-job local GC is disabled there, and the supervisor — the only
party that knows EVERY run dir — refcounts cross-run GC against the
union of all manifest roots (``gc_blobs(..., manifest_roots=...)``).

The supervisor imports no torch and so holds no CUDA context: the
checkpoint reads it needs (``latest_step``, ``gc_blobs``) come from the
torch-free :mod:`dwt_tpu_torch.ckpt.layout`.  Each job opens its own
context on the card; a job that cannot reach the card fails, and that
failure is charged as a crash.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import signal
import subprocess
import sys
import time
from typing import Callable, Dict, List, Optional, Tuple

from dwt_tpu_torch.ckpt.layout import GC_MIN_AGE_S, gc_blobs, latest_step
from dwt_tpu_torch.fleet.retry import RespawnBudget
from dwt_tpu_torch.obs import prom
from dwt_tpu_torch.obs.registry import get_registry
from dwt_tpu_torch.resilience import inject
from dwt_tpu_torch.resilience.notice import post_notice
from dwt_tpu_torch.sweep import journal as jnl
from dwt_tpu_torch.sweep.journal import SweepJournal, decide_adoption

log = logging.getLogger(__name__)


@dataclasses.dataclass
class JobSpec:
    """One pair's filesystem contract with its training subprocess.

    The job is a single-pair ``officehome_sweep`` invocation; the sweep
    wrapper's per-pair naming (ckpt under ``<run>/ckpt/<tag>``, metrics
    at ``<run>/metrics.<tag>.jsonl``) is deterministic, so the
    supervisor computes the same paths for liveness, resume-step, and
    GC accounting without any back-channel from the job."""

    source: str
    target: str
    run_dir: str

    @property
    def tag(self) -> str:
        return f"{self.source}2{self.target}"

    @property
    def pair_key(self) -> str:
        return f"{self.source}->{self.target}"

    @property
    def result_json(self) -> str:
        return os.path.join(self.run_dir, "result.json")

    @property
    def ckpt_base(self) -> str:
        return os.path.join(self.run_dir, "ckpt")

    @property
    def ckpt_tree(self) -> str:
        # officehome_sweep appends the tag to --ckpt_dir.
        return os.path.join(self.ckpt_base, self.tag)

    @property
    def metrics_base(self) -> str:
        return os.path.join(self.run_dir, "metrics.jsonl")

    @property
    def metrics_jsonl(self) -> str:
        # officehome_sweep rewrites --metrics_jsonl to <root>.<tag><ext>.
        return os.path.join(self.run_dir, f"metrics.{self.tag}.jsonl")

    @property
    def notice_file(self) -> str:
        return os.path.join(self.run_dir, "notice")

    @property
    def log_file(self) -> str:
        return os.path.join(self.run_dir, "job.log")


def _count_kinds(jsonl_path: str, kinds: Tuple[str, ...]) -> int:
    """How many records of the given kinds the job has logged — the
    preemption evidence (``preempt`` is fsync'd by the loops before
    exit 0, so a reap after the exit always sees it)."""
    try:
        f = open(jsonl_path, "r")
    except OSError:
        return 0
    n = 0
    with f:
        for line in f:
            try:
                if json.loads(line).get("kind") in kinds:
                    n += 1
            except ValueError:
                continue  # a torn tail line is not evidence
    return n


def _exporter_port(jsonl_path: str) -> Optional[int]:
    """The job's ephemeral ``/metrics`` port, from its
    ``metrics_exporter`` JSONL record (``--metrics_port 0``)."""
    try:
        f = open(jsonl_path, "r")
    except OSError:
        return None
    with f:
        for line in f:
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if rec.get("kind") == "metrics_exporter":
                try:
                    return int(rec["port"])
                except (KeyError, TypeError, ValueError):
                    return None
    return None


def _read_accuracy(spec: JobSpec) -> Optional[float]:
    """The pair's final accuracy from the job's results JSON, or None
    while incomplete.  Presence of the accuracy IS the completion
    signal — it works identically for owned jobs (whose exit code we
    see) and adopted ones (whose exit code died with the previous
    supervisor)."""
    try:
        with open(spec.result_json) as f:
            payload = json.load(f)
        acc = payload["pairs"][spec.pair_key]
    except (OSError, ValueError, KeyError, TypeError):
        return None
    return float(acc) if isinstance(acc, (int, float)) else None


@dataclasses.dataclass
class _RunningJob:
    spec: JobSpec
    proc: Optional[subprocess.Popen]  # None = adopted from a dead parent
    pid: int
    spawned_at: float
    preempts_at_spawn: int
    notice_sent: bool = False
    sigterm_due: bool = False
    port: Optional[int] = None
    log_fh: Optional[object] = None

    @property
    def alive(self) -> bool:
        if self.proc is not None:
            return self.proc.poll() is None
        return jnl.job_process_alive(self.pid, self.spec.run_dir)

    @property
    def returncode(self) -> Optional[int]:
        return self.proc.returncode if self.proc is not None else None


class SweepSupervisor:
    """Schedule ``pairs`` over bounded job slots until every pair is
    done or quarantined (class/module doc).  ``argv_fn(spec)`` builds a
    job's command line (the CLI wires the real training invocation;
    tests substitute cheap scripts); ``clock`` and ``popen`` are
    injectable the same way the fleet's are."""

    def __init__(
        self,
        pairs: List[Tuple[str, str]],
        sweep_root: str,
        argv_fn: Callable[[JobSpec], List[str]],
        *,
        slots: int = 2,
        job_max_respawns: int = 2,
        backoff_s: float = 1.0,
        poll_interval_s: float = 0.5,
        stall_timeout_s: float = 0.0,
        blob_store: Optional[str] = None,
        gc_every_polls: int = 0,
        gc_min_age_s: Optional[float] = None,
        alert_rules: Optional[str] = None,
        metrics_port: Optional[int] = None,
        clock: Callable[[], float] = time.monotonic,
        popen: Callable[..., subprocess.Popen] = subprocess.Popen,
    ):
        self.sweep_root = os.path.abspath(sweep_root)
        self.specs = {
            f"{s}2{t}": JobSpec(s, t, os.path.join(self.sweep_root, f"{s}2{t}"))
            for s, t in pairs
        }
        self.argv_fn = argv_fn
        self.slots = max(1, int(slots))
        self.job_max_respawns = int(job_max_respawns)
        self.poll_interval_s = float(poll_interval_s)
        self.stall_timeout_s = float(stall_timeout_s)
        self.blob_store = (
            os.path.abspath(blob_store) if blob_store else None
        )
        self.gc_every_polls = int(gc_every_polls)
        self.gc_min_age_s = gc_min_age_s
        self._clock = clock
        self._popen = popen
        # Crash budget per pair: `attempts` here counts CRASHES only —
        # preemption resumes are free (count=False), exactly the policy
        # split the fleet cannot express for replicas (an HTTP replica
        # has no orderly save-and-exit-0).
        self.budget = RespawnBudget(
            max_attempts=self.job_max_respawns, backoff_s=float(backoff_s),
            clock=clock,
        )
        os.makedirs(self.sweep_root, exist_ok=True)
        self.journal = SweepJournal.load(
            os.path.join(self.sweep_root, jnl.JOURNAL_NAME)
        )
        self.journal.ensure_pairs(
            pairs, lambda tag: self.specs[tag].run_dir
        )
        self.running: Dict[str, _RunningJob] = {}
        self._drain = False
        self._schedule_events = 0
        self._polls = 0
        self._gc_swept = [0, 0]

        reg = get_registry()
        self._m_state = reg.gauge(
            "dwt_sweep_pairs", "pairs by lifecycle state",
            labelnames=("state",),
        )
        self._m_respawns = reg.counter(
            "dwt_sweep_respawns_total",
            "job respawns after a crash", labelnames=("pair",),
        )
        self._m_preempts = reg.counter(
            "dwt_sweep_preempt_resumes_total",
            "preempted jobs rescheduled (save-and-exit-0 resumes)",
            labelnames=("pair",),
        )
        self._m_adopted = reg.counter(
            "dwt_sweep_adopted_total",
            "running jobs adopted by a relaunched supervisor",
        )
        self._m_gc_swept = reg.gauge(
            "dwt_sweep_gc_swept_bytes_total",
            "bytes swept from the shared store by cross-run GC",
        )
        self._engine = None
        if alert_rules:
            from dwt_tpu_torch.obs.rules import AlertEngine, load_rules

            self._engine = AlertEngine(load_rules(alert_rules), registry=reg)
        self._exporter = None
        if metrics_port is not None:
            self._exporter = prom.start_exporter(
                int(metrics_port), render_fn=self._render_metrics
            )
            log.info(
                "sweep: aggregated /metrics on port %d",
                self._exporter.server_address[1],
            )

    # ------------------------------------------------------------ metrics

    def _render_metrics(self) -> str:
        """The sweep's one scrape surface: supervisor registry first,
        then every running job's exposition under its ``pair`` label —
        the fleet's merge, with pairs in place of replicas.  A job
        mid-compile (no exporter record yet) or mid-death simply
        contributes nothing this scrape."""
        self._refresh_state_gauge()
        parts: List[Tuple[Dict[str, str], str]] = [
            ({}, prom.render(get_registry()))
        ]
        for tag, job in list(self.running.items()):
            if job.port is None:
                job.port = _exporter_port(job.spec.metrics_jsonl)
            if job.port is None:
                continue
            try:
                import urllib.request

                with urllib.request.urlopen(
                    f"http://127.0.0.1:{job.port}/metrics", timeout=1.0
                ) as resp:
                    parts.append(
                        ({"pair": tag}, resp.read().decode("utf-8"))
                    )
            except Exception:  # noqa: BLE001 — scrape must not kill polls
                continue
        return prom.merge_expositions(parts)

    def _refresh_state_gauge(self) -> None:
        counts = {jnl.PENDING: 0, jnl.RUNNING: 0, jnl.DONE: 0,
                  jnl.QUARANTINED: 0}
        for e in self.journal.pairs.values():
            counts[e["status"]] = counts.get(e["status"], 0) + 1
        for state, n in counts.items():
            self._m_state.labels(state=state).set(float(n))

    # ---------------------------------------------------------- lifecycle

    def _install_signals(self) -> None:
        def _flag(signum, frame):
            # Flag only — the poll loop drains; a handler that does I/O
            # could tear a journal write it interrupted.
            self._drain = True

        try:
            signal.signal(signal.SIGTERM, _flag)
            signal.signal(signal.SIGINT, _flag)
        except ValueError:
            pass  # not the main thread (in-process tests)

    def _adopt_phase(self) -> None:
        """Relaunch recovery: walk the journal's ``running`` entries —
        adopt live jobs, harvest results a dead one already finished,
        reschedule the rest.  Crash/attempt history is restored into
        the budget so a relaunch cannot reset a pair's quarantine
        arithmetic."""
        for tag, entry in self.journal.pairs.items():
            self.budget.restore(tag, int(entry.get("crashes", 0)))
            if entry["status"] != jnl.RUNNING:
                continue
            spec = self.specs[tag]
            baseline = int(entry.get("preempt_baseline", 0))
            verdict = decide_adoption(entry)
            if verdict == "adopt":
                self.running[tag] = _RunningJob(
                    spec=spec, proc=None, pid=int(entry["pid"]),
                    spawned_at=self._clock(),
                    # The journaled baseline, NOT a fresh count: the job
                    # may have been preempted while unsupervised, and
                    # that evidence must survive into this reap.
                    preempts_at_spawn=baseline,
                )
                self._m_adopted.inc()
                log.info("sweep: adopted running job %s (pid %d)",
                         tag, entry["pid"])
                continue
            preempts_now = _count_kinds(spec.metrics_jsonl, ("preempt",))
            if preempts_now > baseline:
                # Parked (save-and-exit-0) while unsupervised: its
                # results JSON holds a partial accuracy — reschedule,
                # free, exactly as a supervised reap would have.
                self.journal.update(
                    tag, status=jnl.PENDING, pid=None,
                    preempts=int(entry.get("preempts", 0)) + 1,
                )
                self._m_preempts.labels(pair=tag).inc()
                log.info("sweep: %s was preempted while unsupervised — "
                         "rescheduling free", tag)
                continue
            acc = _read_accuracy(spec)
            if acc is not None:
                self.journal.update(
                    tag, status=jnl.DONE, accuracy=acc, pid=None
                )
                log.info("sweep: %s finished while unsupervised "
                         "(acc=%.2f)", tag, acc)
                continue
            self.journal.update(tag, status=jnl.PENDING, pid=None)
            log.info("sweep: rescheduling %s (journal pid %s not "
                     "adoptable)", tag, entry.get("pid"))

    # --------------------------------------------------------- scheduling

    def _spawn(self, tag: str) -> None:
        spec = self.specs[tag]
        os.makedirs(spec.run_dir, exist_ok=True)
        # Stale notice file from a previous preemption: the job's
        # watcher keys on existence, so an old notice would make the
        # resume save-and-park immediately (the loops keep training on
        # notice, but the follow-up SIGTERM contract reads cleaner with
        # a fresh slate per attempt).
        try:
            os.remove(spec.notice_file)
        except OSError:
            pass
        # A result file present at (re)spawn time is non-final by
        # definition — a preempted attempt's partial accuracy, which a
        # later reap must not mistake for the finish line.
        try:
            os.remove(spec.result_json)
        except OSError:
            pass
        entry = self.journal.pairs[tag]
        baseline = _count_kinds(spec.metrics_jsonl, ("preempt",))
        # Journal BEFORE spawn (module doc): a supervisor killed between
        # these two lines leaves a pid-less running entry any relaunch
        # reschedules.
        self.journal.update(
            tag, status=jnl.RUNNING, pid=None,
            attempts=int(entry["attempts"]) + 1,
            preempt_baseline=baseline,
        )
        self._schedule_events += 1
        inject.maybe_kill_supervisor_at_schedule(self._schedule_events)
        env = {k: v for k, v in os.environ.items() if k != inject.ENV_VAR}
        job_fault = inject.take_sweep_job_fault(tag)
        if job_fault is not None:
            env[inject.ENV_VAR] = json.dumps(job_fault)
            log.warning("sweep: injecting fault plan %s into %s",
                        job_fault, tag)
        log_fh = open(spec.log_file, "ab")
        try:
            proc = self._popen(
                self.argv_fn(spec), env=env, stdout=log_fh,
                stderr=subprocess.STDOUT,
                start_new_session=False,
            )
        except OSError:
            log_fh.close()
            self.journal.update(tag, status=jnl.PENDING, pid=None)
            raise
        self.journal.update(tag, pid=proc.pid)
        self.running[tag] = _RunningJob(
            spec=spec, proc=proc, pid=proc.pid, spawned_at=self._clock(),
            preempts_at_spawn=baseline,
            log_fh=log_fh,
        )
        log.info("sweep: %s scheduled (pid %d, attempt %d)",
                 tag, proc.pid, int(entry["attempts"]) + 1)

    def _schedule_pending(self) -> None:
        for tag, entry in self.journal.pairs.items():
            if len(self.running) >= self.slots or self._drain:
                return
            if entry["status"] != jnl.PENDING or tag in self.running:
                continue
            if not self.budget.ready(tag):
                continue  # backing off after a crash
            self._spawn(tag)

    # -------------------------------------------------------------- reaping

    def _resume_step(self, spec: JobSpec) -> Optional[int]:
        try:
            return latest_step(spec.ckpt_tree)
        except Exception:  # noqa: BLE001 — accounting only
            return None

    def _finish(self, tag: str, job: _RunningJob) -> None:
        if job.log_fh is not None:
            try:
                job.log_fh.close()
            except OSError:
                pass
        self.running.pop(tag, None)

    def _reap(self, tag: str, job: _RunningJob,
              stalled: bool = False) -> None:
        """Classify one finished (or killed-for-stalling) job:
        preempted (free reschedule), done, or crashed (budget-charged,
        quarantine once exhausted).  Preemption evidence is checked
        BEFORE the result file: a parked job returns its best-so-far
        accuracy through the normal exit path (the single-run CLI's
        rerun-to-resume contract), so its results JSON holds a PARTIAL
        number — only the resumed attempt's finish line is final."""
        spec = job.spec
        self._finish(tag, job)
        preempts = _count_kinds(spec.metrics_jsonl, ("preempt",))
        rc = job.returncode
        clean_exit = rc == 0 or (job.proc is None and rc is None)
        if (not stalled and clean_exit
                and preempts > job.preempts_at_spawn):
            # Save-and-exit-0 under SIGTERM: the loops fsync a `preempt`
            # record after their final save, so this is durable evidence
            # the job parked itself in good order.  Resume is free.
            entry = self.journal.update(
                tag, status=jnl.PENDING, pid=None,
                preempts=int(self.journal.pairs[tag]["preempts"]) + 1,
                resume_step=self._resume_step(spec),
            )
            self._m_preempts.labels(pair=tag).inc()
            log.info(
                "sweep: %s preempted (exit 0, resume step %s) — "
                "rescheduling free", tag, entry["resume_step"],
            )
            return
        acc = _read_accuracy(spec)
        if acc is not None and not stalled:
            self.journal.update(
                tag, status=jnl.DONE, accuracy=acc, pid=None,
                resume_step=None,
            )
            log.info("sweep: %s done (acc=%.2f)", tag, acc)
            return
        reason = (
            f"stalled: no metrics activity for {self.stall_timeout_s:g}s"
            if stalled else f"crashed rc={rc}"
        )
        self.budget.begin(tag)  # charge the crash + arm backoff
        crashes = self.budget.attempts(tag)
        if self.budget.exhausted(tag):
            self.journal.update(
                tag, status=jnl.QUARANTINED, pid=None, crashes=crashes,
                reason=f"{reason} ({crashes} crash(es), budget "
                       f"{self.job_max_respawns})",
                resume_step=self._resume_step(spec),
            )
            log.error(
                "sweep: %s QUARANTINED after %d crash(es) (%s); the rest "
                "of the matrix continues", tag, crashes, reason,
            )
            return
        self.journal.update(
            tag, status=jnl.PENDING, pid=None, crashes=crashes,
            reason=reason, resume_step=self._resume_step(spec),
        )
        self._m_respawns.labels(pair=tag).inc()
        log.warning(
            "sweep: %s %s — respawn %d/%d after backoff", tag, reason,
            crashes, self.job_max_respawns,
        )

    def _poll_running(self) -> None:
        now = self._clock()
        for tag, job in list(self.running.items()):
            if not job.alive:
                self._reap(tag, job)
                continue
            # Injected preemption: notice first (the scheduler's advance
            # warning — the job saves proactively and keeps training),
            # SIGTERM one poll later (save-and-exit-0).  Gated on a
            # flushed train/heartbeat record: only once the LOOP is
            # demonstrably running (its SIGTERM handler installed) is a
            # SIGTERM a preemption — during interpreter startup it would
            # be a plain kill, testing nothing about preemption.
            if (not job.notice_sent
                    and _count_kinds(job.spec.metrics_jsonl,
                                     ("train", "heartbeat")) > 0
                    and inject.take_sweep_preempt(tag)):
                post_notice(job.spec.notice_file)
                job.notice_sent = True
                job.sigterm_due = True
                log.warning("sweep: injected preemption notice to %s", tag)
                continue
            if job.sigterm_due:
                job.sigterm_due = False
                try:
                    os.kill(job.pid, signal.SIGTERM)
                except OSError:
                    pass
                continue
            if self.stall_timeout_s > 0:
                try:
                    beat = os.path.getmtime(job.spec.metrics_jsonl)
                except OSError:
                    beat = 0.0
                # monotonic clock vs file mtime: compare ages, anchored
                # at spawn (compile time produces no records and must
                # not read as a stall).
                silent_s = min(
                    now - job.spawned_at,
                    time.time() - beat if beat else float("inf"),
                )
                if silent_s > self.stall_timeout_s:
                    log.error(
                        "sweep: %s silent for %.0fs — SIGKILL (wedged "
                        "job)", tag, silent_s,
                    )
                    try:
                        os.kill(job.pid, signal.SIGKILL)
                    except OSError:
                        pass
                    if job.proc is not None:
                        try:
                            job.proc.wait(timeout=10.0)
                        except Exception:  # noqa: BLE001
                            pass
                    self._reap(tag, job, stalled=True)

    # ------------------------------------------------------------------ GC

    def manifest_roots(self) -> List[str]:
        """Every run's checkpoint tree — the union ``gc_blobs`` must
        refcount against.  ALL pairs count, not just live ones: a
        quarantined run's checkpoints may be wanted for debugging, and
        a done run's for warm starts; reclaiming a finished run is an
        explicit operator action (delete its run dir, then GC)."""
        return [
            spec.ckpt_tree for spec in self.specs.values()
            if os.path.isdir(spec.ckpt_tree)
        ]

    def gc_shared_store(self) -> Tuple[int, int]:
        """One cross-run GC pass over the shared store (no-op without
        ``--blob_store``)."""
        if not self.blob_store or not os.path.isdir(self.blob_store):
            return 0, 0
        roots = self.manifest_roots()
        if not roots:
            return 0, 0
        swept, swept_bytes = gc_blobs(
            self.blob_store,
            min_age_s=(
                self.gc_min_age_s if self.gc_min_age_s is not None
                else GC_MIN_AGE_S
            ),
            manifest_roots=roots,
        )
        self._gc_swept[0] += swept
        self._gc_swept[1] += swept_bytes
        self._m_gc_swept.set(float(self._gc_swept[1]))
        return swept, swept_bytes

    # ---------------------------------------------------------------- drain

    def _drain_running(self) -> None:
        """Supervisor SIGTERM: warn every job (notice file), SIGTERM
        them, wait for the save-and-exit-0, journal them pending.  The
        relaunch resumes the whole matrix exactly where it parked."""
        log.warning(
            "sweep: draining %d running job(s) before exit",
            len(self.running),
        )
        for job in self.running.values():
            post_notice(job.spec.notice_file)
            try:
                os.kill(job.pid, signal.SIGTERM)
            except OSError:
                pass
        deadline = self._clock() + 120.0
        while self.running and self._clock() < deadline:
            for tag, job in list(self.running.items()):
                if not job.alive:
                    self._reap(tag, job)
            time.sleep(0.2)
        for tag, job in list(self.running.items()):
            # Still alive past the grace window: record it running so a
            # relaunch can adopt it.
            self._finish(tag, job)
            self.journal.update(tag, status=jnl.RUNNING, pid=job.pid)

    # ----------------------------------------------------------------- run

    def run(self) -> dict:
        """Drive the matrix to completion; returns the summary record
        (per-pair accuracies, quarantines, respawn/preempt counts)."""
        self._install_signals()
        self._adopt_phase()
        while not self.journal.all_settled():
            if self._drain:
                self._drain_running()
                break
            self._poll_running()
            self._schedule_pending()
            self._polls += 1
            if (self.gc_every_polls > 0
                    and self._polls % self.gc_every_polls == 0):
                self.gc_shared_store()
            if self._engine is not None:
                self._engine.maybe_evaluate()
            self._refresh_state_gauge()
            if self.journal.all_settled():
                break
            time.sleep(self.poll_interval_s)
        if not self._drain and self.blob_store:
            self.gc_shared_store()
        self._refresh_state_gauge()
        return self.summary()

    def summary(self) -> dict:
        results = {
            e["source"] + "->" + e["target"]: e["accuracy"]
            for e in self.journal.pairs.values()
            if e["status"] == jnl.DONE and e["accuracy"] is not None
        }
        quarantined = {
            tag: e["reason"]
            for tag, e in self.journal.pairs.items()
            if e["status"] == jnl.QUARANTINED
        }
        return {
            "kind": "sweep_summary",
            "pairs": results,
            "mean": sum(results.values()) / max(len(results), 1),
            "completed": len(results),
            "total": len(self.journal.pairs),
            "quarantined": quarantined,
            "drained": self._drain,
            "respawns": {
                tag: e["crashes"] for tag, e in self.journal.pairs.items()
                if e["crashes"]
            },
            "preempt_resumes": {
                tag: e["preempts"] for tag, e in self.journal.pairs.items()
                if e["preempts"]
            },
            "gc_swept_bytes": self._gc_swept[1],
        }
