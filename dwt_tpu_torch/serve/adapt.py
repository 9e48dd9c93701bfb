"""Guarded online domain adaptation at the serve edge.

The port of ``dwt_tpu.serve.adapt``.  On a serving fan-out the adapter
runs on the front, on the rows it holds (every real row of each bucket,
as the JAX collect runs unsharded), and an adapted generation reaches the
followers as a build that carries only the folded stats
(``serve.fanout``).  The collect forward is the port's
train-mode forward under ``torch.no_grad`` on the adapter's own copy of
the model (never the live generation's module: a train forward advances
its module's running buffers in place), the batch tiled into
``[num_domains, collect_batch, ...]``; on CUDA every whitened site
launches the moments kernel and then the train-mode apply kernel, one
launch each for all domains.

The paper's whole mechanism is domain-specific whitening statistics, and
its post-training protocol (``EvalPipeline.collect_stats`` — train-mode
forwards over the *target* set purely to advance the running stats)
needs no gradients at all.  That makes adaptation a pure serving
operation: harvest target-domain moments from live traffic, fold them
into the frozen stats, refactorize the whiten cache, and you have a new
deployment generation — *a new target domain with zero training runs*.

Live traffic is untrusted, so every step of that loop is guarded:

* **sanitization** — rows with non-finite values or out-of-band
  magnitudes (``max_abs``) never enter the accumulator; a poisoned
  payload can 500 its own request but cannot poison the stats;
* **padded rows never count** — the accumulator consumes only the
  ``real_n`` real rows of each dispatched bucket (the batcher's
  pad-and-mask convention): repeated-last-row padding would bias the
  moments toward whatever request happened to land last in a bucket;
* **min-sample gate + clamped momentum** — a thin window folds nothing,
  and the EMA momentum is clamped (``max_momentum``) so even a skewed
  window cannot move the stats far in one generation;
* **the same deploy pipeline as a checkpoint** — every adapted
  generation is an immutable :class:`~dwt_tpu_torch.serve.engine.EngineState`
  built through the engine's stats-only rebuild and submitted to the
  shared :class:`~dwt_tpu_torch.fleet.reload.DeployController`: canary
  fixture eval → atomic swap → post-swap monitor → rollback;
* **rollback ⇒ freeze with exponential re-arm** — a rolled-back adapted
  generation freezes adaptation for ``freeze_base_s × 2^(k-1)`` (the
  blacklist analogue for generations that have no artifact to
  blacklist); the counter resets once an adapted generation survives
  its post-swap watch;
* **freeze-on-firing-alert + kill switch** — with ``--alert_rules``
  armed, any firing alert pauses folding (adapt into a healthy serving
  plane only); ``--no-adapt`` disables the subsystem entirely, and the
  default (``--adapt_every 0``) builds none of this — the serving path
  stays bitwise-identical to a non-adaptive server.

Observability: the ``dwt_serve_domain_shift`` gauge (relative distance
between the live stats and the traffic window — a drift alarm feed for
``--alert_rules``), the ``dwt_serve_adapt_generations_total{verdict}``
counter, ``adapt_build``/``adapt_canary``/``adapt_swap``/
``adapt_rollback`` JSONL lifecycle events on the access-log stream, and
adaptation fields on ``/stats``.
"""


from __future__ import annotations

import collections
import logging
import threading
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from dwt_tpu_torch import obs
from dwt_tpu_torch.serve.engine import EngineState, ServeEngine, Version, to_channels_last
from dwt_tpu_torch.serve.quant import dequantize_tensor
from dwt_tpu_torch.utils.checkpoint import params_digest

log = logging.getLogger(__name__)


class _Collector:
    """The moment-collection forward of one engine: ``(state, batch_stats,
    x) -> advanced batch_stats``, on a private train-mode copy of the
    engine's template on the engine's device.  Its parameters are
    re-seeded from ``state`` when the generation's parameters change
    (dequantized from int8, as the serving forward reads them), its stat
    buffers from ``batch_stats`` at every call; the returned stats are
    fresh tensors in each buffer's dtype."""

    def __init__(self, engine: ServeEngine):
        self.engine = engine
        self.num_domains = engine.num_domains
        self.model = to_channels_last(engine.fresh_model()).to(engine.device).train()
        self._params_of = None

    @torch.no_grad()
    def __call__(self, state: EngineState, batch_stats: Dict[str, torch.Tensor],
                 x: np.ndarray) -> Dict[str, torch.Tensor]:
        model = self.model
        if self._params_of is not state.params:
            # Whole tensors: on a serving fan-out under a gspmd plan the
            # front gathers the generation's blocks from every rank.
            params, scales = self.engine.full_params(state)
            for name, p in model.named_parameters():
                q = params[name]
                p.copy_(q if scales is None else dequantize_tensor(q, scales[name]))
            self._params_of = state.params
        for k, v in batch_stats.items():
            model.get_buffer(k).copy_(v)
        xb = self.engine.stage_rows(x)
        model.train()
        model(xb.unsqueeze(0).expand((self.num_domains,) + tuple(xb.shape)))
        return {k: model.get_buffer(k).clone() for k in batch_stats}


def make_collect_fn(engine: ServeEngine) -> Callable:
    """The moment-collection forward for one serving engine: ``(state,
    batch_stats, x) -> advanced batch_stats``.

    The evalpipe's stat-collection step (``train.steps.
    make_stat_collection_step`` — the reference's post-training protocol:
    train-mode forward, gradient-free, the batch tiled into every domain
    slot so only the running stats advance) on the collector's own copy
    of the model, with ``state``'s parameters (an int8 generation's
    dequantized the way the serving forward does it) and ``batch_stats``
    loaded first.  Output stat leaves keep their input dtypes, so the
    folded stats graft onto the live generation whatever the model's
    compute dtype (bf16 serving) did to the intermediate moments."""
    return _Collector(engine)


def _host(stats) -> Dict[str, np.ndarray]:
    return {k: (v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v))
            for k, v in stats.items()}


def stats_drift(live, window) -> float:
    """Relative distance between two stats dicts: ``‖w − l‖ / ‖l‖``
    (Frobenius over every leaf, in float64).  Scale-free — a gauge value
    an operator can write one alert threshold against regardless of
    model size — and zero exactly when the traffic window agrees with
    the frozen stats."""
    num = 0.0
    den = 0.0
    live, window = _host(live), _host(window)
    for k, l in live.items():
        l = np.asarray(l, np.float64)
        w = np.asarray(window[k], np.float64)
        num += float(np.sum((w - l) ** 2))
        den += float(np.sum(l ** 2))
    return float(np.sqrt(num) / (np.sqrt(den) + 1e-12))


def sanitize_rows(x: np.ndarray, max_abs: float) -> np.ndarray:
    """Boolean keep-mask over rows: finite everywhere and within the
    amplitude band.  A poisoned request row (NaN/Inf payload, or a
    magnitude no real sample reaches) must never advance the stats."""
    flat = np.asarray(x).reshape(x.shape[0], -1)
    finite = np.isfinite(flat).all(axis=1)
    # Non-finite rows would make the band check itself warn; evaluate it
    # only where finite.
    in_band = np.zeros_like(finite)
    if finite.any():
        in_band[finite] = (
            np.abs(flat[finite]).max(axis=1) <= float(max_abs)
        )
    return finite & in_band


class DomainAdapter:
    """Serve-side target-domain stat accumulator behind the deploy gate.

    **Harvest** (dispatcher side, O(slice+append)): the dispatcher calls
    :meth:`offer` once per dispatched bucket with the batch tensor and
    its real-row count; only the real rows enter the bounded sample
    queue.  Nothing else runs on the serving hot path.

    **Accumulate** (adapter thread): :meth:`step` drains the queue,
    sanitizes rows, and advances a *window* stats dict — seeded from the
    live generation's stats — through the collect forward on the
    adapter's own copy of the model, one fixed-size batch at a time.

    **Fold + deploy** (adapter thread, on the ``adapt_every_s``
    cadence): with enough samples and nothing frozen, the window folds
    into the live stats under the clamped momentum, builds a candidate
    generation through ``ServeEngine.build_state_from_stats`` (same
    params/scales, new stats + refactorized cache), and submits it to
    the shared :class:`~dwt_tpu_torch.fleet.reload.DeployController` — the
    exact path a hot-reloaded checkpoint takes.

    ``step()`` is the unit-testable single iteration (no thread);
    ``start()``/``stop()`` wrap it in a daemon, like ``HotReloader``.
    ``clock`` is injectable (fake-clock tests, the repo convention).
    """

    def __init__(
        self,
        engine: ServeEngine,
        controller,
        *,
        access_log=None,
        adapt_every_s: float = 30.0,
        min_samples: int = 64,
        momentum: float = 0.25,
        max_momentum: float = 0.5,
        collect_batch: int = 32,
        max_abs: float = 1e3,
        freeze_base_s: float = 30.0,
        max_freeze_doublings: int = 6,
        max_window_samples: int = 8192,
        alert_engine=None,
        poll_s: float = 0.25,
        clock: Callable[[], float] = time.monotonic,
    ):
        if adapt_every_s <= 0:
            raise ValueError("adapt_every_s must be > 0 (0 disables "
                             "adaptation at the flag layer, not here)")
        self.engine = engine
        self.controller = controller
        self.access_log = access_log
        self.adapt_every_s = float(adapt_every_s)
        self.min_samples = int(min_samples)
        self.momentum = float(momentum)
        self.max_momentum = float(max_momentum)
        self.collect_batch = int(collect_batch)
        self.max_abs = float(max_abs)
        self.freeze_base_s = float(freeze_base_s)
        self.max_freeze_doublings = int(max_freeze_doublings)
        self.max_window_samples = int(max_window_samples)
        self.alert_engine = alert_engine
        self.poll_s = float(poll_s)
        self._clock = clock
        self._collect = make_collect_fn(engine)

        # Dispatcher → adapter handoff: a bounded deque of real-row
        # arrays.  Oldest batches drop first — the window should track
        # RECENT traffic, and a stalled adapter must not grow host
        # memory without bound.
        self._queue: "collections.deque" = collections.deque()
        self._queue_samples = 0
        self._qlock = threading.Lock()

        # Window accumulator state (adapter thread only).
        self._win_stats = None          # device stats dict, or None (empty window)
        self._win_samples = 0
        self._pending_rows: list = []   # sanitized rows awaiting a full batch
        self._last_fold = self._clock()

        # Guard state.
        self._frozen_until = 0.0
        self._freeze_reason: Optional[str] = None
        self._consecutive_rollbacks = 0

        # Lifetime counters (all host-side ints; read by /stats).
        self.generation = 0             # canary-accepted adapted swaps
        self.fold_attempts = 0
        self.dropped_rows = 0           # sanitization rejects
        self.dropped_backlog = 0        # queue overflow drops
        self.last_drift: Optional[float] = None

        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

        from dwt_tpu_torch.obs.registry import get_registry

        reg = get_registry()
        self._m_drift = reg.gauge(
            "dwt_serve_domain_shift",
            "relative distance between live whitening/BN stats and the "
            "accumulated traffic window (0 = no drift)",
        )
        self._m_generations = reg.counter(
            "dwt_serve_adapt_generations_total",
            "adapted candidate generations by outcome",
            labelnames=("verdict",),
        )
        reg.gauge(
            "dwt_serve_adapt_window_samples",
            "sanitized samples accumulated toward the next fold",
        ).set_function(lambda: self.window_samples)
        reg.gauge(
            "dwt_serve_adapt_frozen",
            "1 while adaptation is frozen (rollback backoff, firing "
            "alert), else 0",
        ).set_function(lambda: 1 if self.frozen_reason() else 0)

        controller.add_verdict_listener(self._on_verdict)

    # ----------------------------------------------------------- harvest

    def offer(self, x: np.ndarray, real_n: int) -> None:
        """Dispatcher hook: enqueue the REAL rows of one dispatched
        bucket.  Padded tail rows (repeat-last-row, ``batcher.py``) are
        excluded here, at the source — the moment-parity contract the
        accumulator owes the batcher's pad-and-mask convention.  Cheap
        and non-blocking; never raises into the dispatcher."""
        try:
            rows = np.asarray(x)[: int(real_n)]
            if rows.shape[0] == 0:
                return
            with self._qlock:
                self._queue.append(rows)
                self._queue_samples += rows.shape[0]
                while (self._queue_samples > self.max_window_samples
                       and len(self._queue) > 1):
                    old = self._queue.popleft()
                    self._queue_samples -= old.shape[0]
                    self.dropped_backlog += old.shape[0]
        except Exception:  # the serving path must never pay for a bug here
            log.exception("adapt: offer failed; batch skipped")

    def _drain_queue(self) -> list:
        with self._qlock:
            batches = list(self._queue)
            self._queue.clear()
            self._queue_samples = 0
        return batches

    # ------------------------------------------------------------ window

    @property
    def window_samples(self) -> int:
        """Sanitized samples in the current window (collected or
        awaiting a full collect batch)."""
        return self._win_samples + sum(
            r.shape[0] for r in self._pending_rows
        )

    def _reset_window(self) -> None:
        self._win_stats = None
        self._win_samples = 0
        self._pending_rows = []

    def _absorb(self, batches: list) -> None:
        """Sanitize drained rows and advance the window stats through
        the collect forward, one fixed-size batch at a time."""
        for rows in batches:
            keep = sanitize_rows(rows, self.max_abs)
            dropped = int(rows.shape[0] - int(keep.sum()))
            if dropped:
                self.dropped_rows += dropped
            if keep.any():
                self._pending_rows.append(
                    np.ascontiguousarray(
                        rows[keep], self.engine.input_dtype
                    )
                )
        if not self._pending_rows:
            return
        pool = (
            np.concatenate(self._pending_rows, axis=0)
            if len(self._pending_rows) > 1 else self._pending_rows[0]
        )
        n_full = pool.shape[0] // self.collect_batch
        if n_full == 0:
            self._pending_rows = [pool]
            return
        live = self.engine.state
        if self._win_stats is None:
            # The window EMA starts AT the live stats and advances
            # toward the traffic — the evalpipe collect protocol, per
            # window.
            self._win_stats = live.batch_stats
        stats = self._win_stats
        # The span wraps the collect forwards' kernel launches (it times
        # their enqueue: nothing here waits for the card).
        with obs.span("adapt_collect", "serve",
                      batches=n_full, n=n_full * self.collect_batch):
            for i in range(n_full):
                xb = pool[
                    i * self.collect_batch: (i + 1) * self.collect_batch
                ]
                stats = self._collect(live, stats, xb)
        self._win_stats = stats
        self._win_samples += n_full * self.collect_batch
        rest = pool[n_full * self.collect_batch:]
        self._pending_rows = [rest] if rest.shape[0] else []

    # ------------------------------------------------------------ guards

    def frozen_reason(self) -> Optional[str]:
        """Why folding is currently paused, or None.  Rollback backoff
        re-arms on its own once the (exponential) window passes; a
        firing alert freezes for exactly as long as it fires."""
        if self._clock() < self._frozen_until:
            return self._freeze_reason or "rollback backoff"
        if self.alert_engine is not None:
            self.alert_engine.maybe_evaluate()
            firing = self.alert_engine.firing()
            if firing:
                return f"alert firing: {','.join(firing)}"
        return None

    def _on_verdict(self, origin: str, version: Version,
                    verdict: str) -> None:
        if origin != "adapt":
            return
        if verdict == "ok":
            # An adapted generation survived its post-swap watch: the
            # freeze ladder resets.
            self._consecutive_rollbacks = 0
            return
        # Rolled back.  No artifact to blacklist (the generation was
        # built from traffic, not a file) — the consequence is time:
        # freeze folding, doubling per consecutive regression, and drop
        # the window that built the bad generation.
        self._consecutive_rollbacks += 1
        doublings = min(
            self._consecutive_rollbacks - 1, self.max_freeze_doublings
        )
        freeze_s = self.freeze_base_s * (2 ** doublings)
        self._frozen_until = self._clock() + freeze_s
        self._freeze_reason = (
            f"rollback backoff {freeze_s:.0f}s "
            f"(#{self._consecutive_rollbacks}: {verdict})"
        )
        self._reset_window()
        self._m_generations.labels(verdict="rolled_back").inc()
        log.warning("adapt: %s", self._freeze_reason)

    # -------------------------------------------------------------- fold

    def _effective_momentum(self) -> float:
        return max(0.0, min(self.momentum, self.max_momentum))

    def try_fold(self) -> Optional[str]:
        """One fold attempt: gate → fold → build → submit.  Returns the
        verdict string (also counted on the generations metric), or None
        when there was nothing to attempt (empty window)."""
        self._last_fold = self._clock()
        if self._win_samples == 0:
            return None
        self.fold_attempts += 1
        live = self.engine.state
        live_host = _host(live.batch_stats)
        win_host = _host(self._win_stats)
        drift = stats_drift(live_host, win_host)
        self.last_drift = drift
        self._m_drift.set(drift)
        if self._win_samples < self.min_samples:
            # Thin window: keep accumulating, fold next cadence.  The
            # drift gauge still updates — a drifting-but-quiet replica
            # should alarm even while the gate holds.
            self._event("adapt_build", ok=False, reason="thin_window",
                        samples=self._win_samples, drift=drift)
            self._m_generations.labels(verdict="thin_window").inc()
            return "thin_window"
        m = self._effective_momentum()
        folded = {
            k: (a + m * (np.asarray(win_host[k], np.float64) - a)).astype(a.dtype)
            for k, a in live_host.items()
        }
        finite = all(np.isfinite(leaf).all() for leaf in folded.values())
        if not finite:
            # Should be unreachable past sanitization — but a candidate
            # with non-finite stats must never even reach the canary.
            self._event("adapt_build", ok=False, reason="nonfinite",
                        samples=self._win_samples, drift=drift)
            self._m_generations.labels(verdict="nonfinite").inc()
            self._reset_window()
            return "nonfinite"
        # Version identity: the params are unchanged, so the digest must
        # come from what DID change — the folded stats.  Distinct per
        # generation, stable across replicas seeing the same traffic.
        version = Version(live.version.step, params_digest(
            (k, torch.from_numpy(np.ascontiguousarray(v))) for k, v in folded.items()))
        self._event("adapt_build", ok=True, version=version.label,
                    samples=self._win_samples, drift=drift,
                    momentum=m)
        candidate = self.engine.build_state_from_stats(
            live, folded, version=version
        )
        went_live, reason = self.controller.submit(
            candidate, origin="adapt"
        )
        self._reset_window()
        if went_live:
            self.generation += 1
            self._m_generations.labels(verdict="swapped").inc()
            return "swapped"
        self._m_generations.labels(verdict="refused").inc()
        log.warning("adapt: candidate %s refused: %s",
                    version.label, reason)
        return "refused"

    def _event(self, kind: str, **fields) -> None:
        if self.access_log is not None:
            self.access_log.event(kind, **fields)

    # -------------------------------------------------------------- loop

    def step(self) -> Optional[str]:
        """One adapter iteration: act on any post-swap verdict, absorb
        queued traffic, and fold on cadence.  Returns the fold verdict
        when one was attempted."""
        status = self.controller.poll()
        self._absorb(self._drain_queue())
        if status == "hold":
            # A generation (ours or a checkpoint's) is under post-swap
            # watch: keep accumulating, do not deploy on top of it.
            return None
        if self._clock() - self._last_fold < self.adapt_every_s:
            return None
        reason = self.frozen_reason()
        if reason is not None:
            # Push the cadence out rather than busy-retrying the gate.
            self._last_fold = self._clock()
            return None
        return self.try_fold()

    def stats(self) -> dict:
        """Adaptation fields for ``/stats``."""
        reason = self.frozen_reason()
        return {
            "generation": self.generation,
            "frozen": reason is not None,
            **({"frozen_reason": reason} if reason else {}),
            "window_samples": self.window_samples,
            "fold_attempts": self.fold_attempts,
            "dropped_rows": self.dropped_rows,
            "consecutive_rollbacks": self._consecutive_rollbacks,
            **({"domain_shift": round(self.last_drift, 6)}
               if self.last_drift is not None else {}),
        }

    def start(self) -> None:
        if self._thread is not None:
            raise RuntimeError("adapter already started")

        def _run():
            while not self._stop.wait(self.poll_s):
                try:
                    self.step()
                except Exception:
                    log.exception("adapt: step failed")

        self._thread = threading.Thread(
            target=_run, name="dwt-serve-adapt", daemon=True
        )
        self._thread.start()

    def stop(self, timeout: float = 30.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None
