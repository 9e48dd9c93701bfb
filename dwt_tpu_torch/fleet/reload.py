"""Hot reload: watch → restore → canary → atomic swap → monitor → rollback.

The port of ``dwt_tpu.fleet.reload``.

Two producers feed one deploy pipeline:

* the :class:`HotReloader` — new CHECKPOINTS from the watched directory
  (restore → structural graft → build → submit);
* the serve-side :class:`~dwt_tpu_torch.serve.adapt.DomainAdapter` — ADAPTED
  generations folded from live-traffic whitening stats (same params,
  mutated ``batch_stats`` + refreshed cache → submit).

Both go through the shared :class:`DeployController`, which owns the
gate → swap → monitor → rollback sequence for ONE serving process:
every candidate — wherever it came from — passes the same
:class:`~dwt_tpu_torch.fleet.canary.CanaryGate` fixture eval, swaps in as the
same atomic pointer flip, and is watched by the same
:class:`~dwt_tpu_torch.fleet.canary.PostSwapMonitor` against the same
access-log windows.  The controller serializes submissions (one deploy
in flight at a time) and routes the rollback CONSEQUENCE by origin:
a regressed checkpoint is blacklisted by the reloader, a regressed
adapted generation freezes the adapter (verdict listeners).

Everything expensive — the checkpoint read into a fresh copy of the
model (where its structure, shapes and digest are checked), the
whiten-cache factorization, the device placement — runs on the producer's own thread
while the dispatcher keeps serving the live generation (the double
buffer); only the final pointer flip (``ServeEngine.swap``) touches the
serving path, and that flip is a single reference assignment between
dispatches.

Failure containment mirrors the training guard ladder:

* a candidate that fails to RESTORE (torn bytes, digest mismatch —
  the restore re-verifies the manifest digest) or to BUILD
  (structure/shape mismatch with the model) is refused and
  remembered, so the watcher re-seeing the same artifact does not retry
  it forever;
* a candidate the :class:`~dwt_tpu_torch.fleet.canary.CanaryGate` refuses
  (non-finite / regressed fixture eval) likewise never goes live;
* a candidate that goes live but regresses the post-swap access-log
  windows (:class:`~dwt_tpu_torch.fleet.canary.PostSwapMonitor`) is rolled
  back to the last-good state — kept device-resident since the swap —
  and blacklisted (checkpoints) or frozen out (adapted generations).

Every transition writes a JSONL event through the access log, version-
labelled, so one file tells the deployment story next to the requests
it affected: ``reload``/``canary``/``swap``/``rollback`` for the
checkpoint path, ``adapt_canary``/``adapt_swap``/``adapt_rollback`` for
adapted generations (plus the adapter's own ``adapt_build``).
"""

from __future__ import annotations

import logging
import threading
from typing import Callable, List, Optional, Tuple

from dwt_tpu_torch import obs
from dwt_tpu_torch.fleet.canary import CanaryGate, PostSwapMonitor
from dwt_tpu_torch.fleet.watcher import Candidate, CheckpointWatcher, newest_candidate
from dwt_tpu_torch.serve.engine import EngineState, ServeEngine, Version

log = logging.getLogger(__name__)


class DeployController:
    """The shared gate → swap → monitor → rollback pipeline.

    Origin-agnostic: ``submit(state, origin=...)`` runs the canary on
    any built :class:`EngineState` and flips it live on a pass; ``poll``
    acts on the post-swap monitor's verdict (every producer loop calls
    it — whichever thread polls first performs the rollback, under one
    lock).  ``origin`` selects the JSONL event kinds (``canary``/
    ``swap``/``rollback`` vs ``adapt_canary``/…) and is handed to
    verdict listeners so each producer applies its own consequence
    (checkpoint blacklist vs adaptation freeze).
    """

    def __init__(
        self,
        engine: ServeEngine,
        *,
        access_log=None,
        canary: Optional[CanaryGate] = None,
        monitor: Optional[PostSwapMonitor] = None,
    ):
        self.engine = engine
        self.access_log = access_log
        self.canary = canary
        self.monitor = monitor
        self.last_good: Optional[EngineState] = None
        self._last_good_label: Optional[str] = None
        self.swap_count = 0
        self.rollback_count = 0
        # One deploy in flight at a time: a reloader deploy and an
        # adapter fold racing each other would interleave their canary
        # baselines and fight over last_good.  RLock — rollback() runs
        # inside poll()'s critical section.
        self._lock = threading.RLock()
        # fn(origin, version: Version, verdict: str) — called on the
        # post-swap "ok" (the generation survived its watch window) and
        # on every rollback ("rollback: …"), AFTER the swap-back.
        self._verdict_listeners: List[
            Callable[[str, Version, str], None]
        ] = []

    # ------------------------------------------------------------- events

    def add_verdict_listener(
        self, fn: Callable[[str, Version, str], None]
    ) -> None:
        self._verdict_listeners.append(fn)

    def _notify(self, origin: str, version: Version, verdict: str) -> None:
        for fn in self._verdict_listeners:
            try:
                fn(origin, version, verdict)
            except Exception:
                log.exception("fleet: verdict listener failed")

    def _event(self, kind: str, origin: str = "reload", **fields) -> None:
        if self.access_log is not None:
            # The checkpoint path keeps its historical bare kinds; other
            # origins prefix theirs (adapt_canary/adapt_swap/…), so one
            # JSONL stream tells both deployment stories apart.
            name = kind if origin == "reload" else f"{origin}_{kind}"
            self.access_log.event(name, **fields)

    # ------------------------------------------------------------- deploy

    def submit(
        self,
        state: EngineState,
        *,
        origin: str = "reload",
    ) -> Tuple[bool, str]:
        """Gate one built candidate and flip it live on a pass.  Returns
        ``(went_live, reason)``; never raises on a refusal — the caller
        applies its origin-specific consequence."""
        with self._lock:
            label = state.version.label
            if self.canary is not None:
                # Measure the live baseline BEFORE the swap moves it.
                verdict = self.canary.check(state)
                self._event("canary", origin, version=label, ok=verdict.ok,
                            reason=verdict.reason, **verdict.metrics)
                if not verdict.ok:
                    return False, verdict.reason
            old_label = self.engine.version.label
            baseline_p99 = None
            if self.access_log is not None:
                baseline_p99 = self.access_log.version_stats(
                    old_label
                ).get("e2e_ms_p99")
            with obs.span("swap", "fleet", version=label):
                prev = self.engine.swap(state)
            self.swap_count += 1
            self.last_good = prev
            self._last_good_label = old_label
            self._event("swap", origin, version=label,
                        from_version=old_label, step=state.version.step)
            if self.monitor is not None:
                self.monitor.arm(label, baseline_p99, origin=origin)
            return True, "ok"

    def rollback(self, reason: str, origin: Optional[str] = None) -> bool:
        """Swap the last-good state back in.  Returns False when there
        is nothing to roll back to (first deploy of a fresh server —
        keep serving, keep alarming).  ``origin`` defaults to whatever
        the monitor was armed with."""
        with self._lock:
            if origin is None:
                origin = (
                    self.monitor.armed_origin
                    if self.monitor is not None and self.monitor.armed
                    else "reload"
                )
            bad = self.engine.version
            if self.last_good is None:
                log.error(
                    "fleet: %s but no last-good state to roll back to "
                    "(version %s stays live)", reason, bad.label,
                )
                self._event("rollback", origin, version=bad.label,
                            ok=False, reason=reason)
                return False
            with obs.span("swap", "fleet",
                          version=self.last_good.version.label, rollback=1):
                self.engine.swap(self.last_good)
            self.rollback_count += 1
            self._event("rollback", origin, version=bad.label,
                        to_version=self.last_good.version.label,
                        reason=reason)
            log.warning(
                "fleet: rolled back %s -> %s (%s)",
                bad.label, self.last_good.version.label, reason,
            )
            # The rolled-back-to state is live again; nothing newer is
            # good.
            self.last_good = None
            if self.monitor is not None:
                self.monitor.disarm()
            self._notify(origin, bad, reason)
            return True

    def poll(self) -> Optional[str]:
        """Act on the monitor's verdict.  Returns ``None`` (not armed),
        ``"hold"`` (undecided — producers must not deploy on top of a
        version under watch), ``"ok"`` (survived; disarmed), or
        ``"rollback"`` (performed).  Safe to call from every producer
        loop; the lock makes whoever gets there first do the work."""
        with self._lock:
            if self.monitor is None or not self.monitor.armed:
                return None
            verdict = self.monitor.verdict()
            if verdict is None:
                return "hold"
            if verdict.startswith("rollback"):
                self.rollback(verdict)
                return "rollback"
            # "ok": the new version held — it is the bar now.
            origin = self.monitor.armed_origin
            version = self.engine.version
            self.monitor.disarm()
            self._notify(origin, version, "ok")
            return "ok"


class HotReloader:
    """One serving process's continuous-deployment loop.

    ``step()`` is the single-iteration core (poll → maybe deploy → maybe
    roll back) — unit-testable with no thread; ``start()``/``stop()``
    wrap it in a daemon.

    The gate/swap/monitor mechanics live in the shared
    :class:`DeployController`; pass ``controller=`` to share one with
    the online adapter (``--watch`` + ``--adapt_every`` on one server),
    so both producers serialize through one pipeline and one last-good
    buffer.
    """

    def __init__(
        self,
        engine: ServeEngine,
        ckpt_dir: str,
        *,
        access_log=None,
        poll_s: float = 2.0,
        canary: Optional[CanaryGate] = None,
        monitor: Optional[PostSwapMonitor] = None,
        controller: Optional[DeployController] = None,
    ):
        self.engine = engine
        self.ckpt_dir = ckpt_dir
        self.access_log = access_log
        if controller is None:
            controller = DeployController(
                engine, access_log=access_log, canary=canary,
                monitor=monitor,
            )
        self.controller = controller
        self.canary = controller.canary
        self.monitor = controller.monitor
        controller.add_verdict_listener(self._on_verdict)
        self.watcher = CheckpointWatcher(ckpt_dir, poll_s)
        # The version the server booted with must not redeploy on the
        # first poll: prime the watcher with it when it IS the newest.
        boot = newest_candidate(ckpt_dir)
        if boot is not None and self._is_live(boot):
            self.watcher.prime(boot)
        self.rejected: dict = {}     # version key -> refusal reason
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # Deploy bookkeeping lives on the (possibly shared) controller; the
    # historical attribute names keep reading through.
    @property
    def last_good(self) -> Optional[EngineState]:
        return self.controller.last_good

    @property
    def swap_count(self) -> int:
        return self.controller.swap_count

    @property
    def rollback_count(self) -> int:
        return self.controller.rollback_count

    def _is_live(self, cand: Candidate) -> bool:
        """Is this candidate the generation already serving?  Digest
        first — it is the content identity and identical whether it came
        from the manifest or was recomputed over the restored params;
        the step number alone can differ between a checkpoint's
        directory name and the train state it holds (legacy manifests
        without a digest fall back to the step)."""
        live = self.engine.version
        if cand.digest is not None and live.digest is not None:
            return cand.digest == live.digest
        return cand.step == live.step

    # ------------------------------------------------------------- events

    def _event(self, kind: str, **fields) -> None:
        if self.access_log is not None:
            self.access_log.event(kind, **fields)

    def _reject(self, cand_key, label: str, reason: str) -> None:
        self.rejected[cand_key] = reason
        log.warning("fleet: candidate %s refused: %s", label, reason)
        self._event("canary", version=label, ok=False, reason=reason)

    def _on_verdict(self, origin: str, version: Version,
                    verdict: str) -> None:
        # A checkpoint generation the monitor rolled back is blacklisted
        # so the watcher re-seeing the same artifact does not redeploy
        # it.  Adapted generations are NOT checkpoint candidates — their
        # consequence (freeze + re-arm) belongs to the adapter's own
        # listener.
        if origin == "reload" and verdict != "ok":
            self.rejected[(version.step, version.digest)] = verdict

    # ------------------------------------------------------------ deploy

    def _build_candidate(self, cand: Candidate) -> EngineState:
        # Restored into a fresh copy of the model: the structure, shape and
        # digest checks run there, never on a live generation.
        return self.engine.build_state_from_checkpoint(
            cand.path, version=Version(cand.step, cand.digest)
        )

    def deploy(self, cand: Candidate) -> bool:
        """Restore → build → canary → swap one candidate.  Returns True
        when the candidate went live."""
        label = Version(cand.step, cand.digest).label
        self._event("reload", version=label, step=cand.step,
                    source=cand.source)
        try:
            state = self._build_candidate(cand)
        except Exception as e:
            self._reject(cand.key, label,
                         f"restore/build failed: {type(e).__name__}: {e}")
            return False
        label = state.version.label  # digest may have been computed late
        ok, reason = self.controller.submit(state, origin="reload")
        if not ok:
            self._reject(cand.key, label, reason)
        return ok

    def rollback(self, reason: str) -> bool:
        """Swap the last-good state back in and blacklist the regressed
        version.  Returns False when there is nothing to roll back to
        (first deploy of a fresh server — keep serving, keep alarming)."""
        return self.controller.rollback(reason)

    def reload_newest(self, *, force: bool = False) -> bool:
        """Deploy the newest valid checkpoint directly (the bench's and an
        operator's lever).  ``force`` redeploys even the live version (a
        same-checkpoint swap: numerically a no-op, operationally the
        swap-cost probe)."""
        cand = newest_candidate(self.ckpt_dir)
        if cand is None:
            return False
        if not force and self._is_live(cand):
            return False
        return self.deploy(cand)

    # -------------------------------------------------------------- loop

    def step(self) -> None:
        """One reloader iteration: act on a monitor verdict, then on a
        new candidate.  Rollback first — deploying on top of a regressed
        version would destroy the evidence."""
        status = self.controller.poll()
        if status in ("hold", "rollback"):
            return
        cand = self.watcher.poll_once()
        if cand is None:
            return
        if cand.key in self.rejected:
            log.info(
                "fleet: skipping already-refused candidate step %s (%s)",
                cand.step, self.rejected[cand.key],
            )
            return
        self.deploy(cand)

    def start(self) -> None:
        if self._thread is not None:
            raise RuntimeError("reloader already started")

        def _run():
            while not self._stop.wait(self.watcher.poll_s):
                try:
                    self.step()
                except Exception:
                    log.exception("fleet: reloader step failed")

        self._thread = threading.Thread(
            target=_run, name="dwt-fleet-reload", daemon=True
        )
        self._thread.start()

    def stop(self, timeout: float = 30.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None
        self.watcher.stop()
