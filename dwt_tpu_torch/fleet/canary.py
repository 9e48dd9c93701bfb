"""Canary gate + post-swap rollback verdicts: serving's DivergenceGuard.

The port of ``dwt_tpu.fleet.canary``.

Training refuses to checkpoint non-finite params and the
``DivergenceGuard`` rolls a diverged run back to the last good step; the
fleet applies the same philosophy at the serve boundary, in two stages:

* **pre-swap** (:class:`CanaryGate`): every candidate runs a fixture
  eval — the deployment forward itself (``ServeEngine.infer`` with the
  CANDIDATE state pinned, never swapped live) on a held-out batch —
  before it can go live.  Non-finite logits, a forward that raises
  (wrong dtype/structure past the adapt-time checks), or a fixture
  accuracy regressed more than ``max_regress_pp`` below the live
  version's refuse the candidate.  A digest-corrupt artifact never
  reaches the gate: the restore re-verifies the manifest digest
  and the reloader converts that failure into a refusal.
* **post-swap** (:class:`PostSwapMonitor`): the serving-side divergence
  signal is the access log's per-version windows (the ``version`` stamp
  every record carries).  After a swap, once the new version has served
  a minimum window, an error rate above threshold or a p99 blown past
  ``p99_factor`` × the pre-swap baseline triggers rollback to the
  last-good state (the previous :class:`~dwt_tpu_torch.serve.engine
  .EngineState`, kept device-resident exactly for this).
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np

from dwt_tpu_torch import obs
from dwt_tpu_torch.serve.engine import EngineState, ServeEngine

log = logging.getLogger(__name__)


# Per-version window stats with a pre-swap baseline the monitor arms —
# the only metrics a --rollback_rules baseline_factor may reference.
_BASELINE_METRICS = ("e2e_ms_p99",)


@dataclass(frozen=True)
class CanaryVerdict:
    ok: bool
    reason: str
    metrics: dict = field(default_factory=dict)


class CanaryGate:
    """Fixture eval on a candidate state, compared against the live one.

    ``fixture_x``: ``[n, ...sample]`` held-out batch (n ≤ the engine's
    largest bucket); ``fixture_y`` (optional) enables the accuracy
    regression check — without labels the gate still catches non-finite
    and non-running candidates.  The live baseline re-evaluates lazily
    per live version (a swap moves the bar the next candidate is held
    to)."""

    def __init__(
        self,
        engine: ServeEngine,
        fixture_x: np.ndarray,
        fixture_y: Optional[np.ndarray] = None,
        max_regress_pp: float = 5.0,
    ):
        self.engine = engine
        self.fixture_x = np.asarray(fixture_x, engine.input_dtype)
        if self.fixture_x.shape[0] > engine.buckets[-1]:
            # One compiled dispatch per canary check: the fixture must
            # fit the largest bucket (split fixtures would complicate
            # the accuracy bar for no gate-quality gain).
            self.fixture_x = self.fixture_x[: engine.buckets[-1]]
            fixture_y = (
                None if fixture_y is None
                else np.asarray(fixture_y)[: engine.buckets[-1]]
            )
        self.fixture_y = None if fixture_y is None else np.asarray(fixture_y)
        self.max_regress_pp = float(max_regress_pp)
        self._baseline_version = None
        self._baseline_acc: Optional[float] = None

    def _fixture_metrics(self, state: Optional[EngineState]) -> dict:
        logits = self.engine.infer(self.fixture_x, state=state)
        out = {"finite": bool(np.isfinite(logits).all())}
        if self.fixture_y is not None:
            out["accuracy"] = round(float(
                100.0 * (np.argmax(logits, -1) == self.fixture_y).mean()
            ), 4)
        return out

    def baseline(self) -> Optional[float]:
        """Live version's fixture accuracy (None without labels),
        re-measured when the live version changes."""
        if self.fixture_y is None:
            return None
        live = self.engine.version
        if self._baseline_version != live.label:
            self._baseline_acc = self._fixture_metrics(None)["accuracy"]
            self._baseline_version = live.label
        return self._baseline_acc

    def check(self, candidate: EngineState) -> CanaryVerdict:
        """Gate one built candidate state; NEVER swaps it live."""
        with obs.span("canary", "fleet", version=candidate.version.label):
            try:
                metrics = self._fixture_metrics(candidate)
            except Exception as e:
                return CanaryVerdict(
                    False, f"fixture eval raised {type(e).__name__}: {e}"
                )
            if not metrics["finite"]:
                return CanaryVerdict(
                    False, "non-finite logits on the fixture batch",
                    metrics,
                )
            base = self.baseline()
            if base is not None:
                metrics["baseline_accuracy"] = base
                if metrics["accuracy"] < base - self.max_regress_pp:
                    return CanaryVerdict(
                        False,
                        f"fixture accuracy {metrics['accuracy']:.2f} "
                        f"regressed more than {self.max_regress_pp} pp "
                        f"below live {base:.2f}",
                        metrics,
                    )
            return CanaryVerdict(True, "ok", metrics)


class PostSwapMonitor:
    """Rollback verdicts off the per-version access-log windows.

    Armed at swap time with the new version's label and the pre-swap
    baseline p99 (the OLD version's window — measured under the same
    traffic the new version inherits).  ``verdict()`` returns:

    * ``None`` — undecided (window too small, still inside the grace
      period);
    * ``"ok"`` — the new version held: window served clean;
    * ``"rollback: …"`` — a trip rule fired on the version's window.

    The trip conditions are declarative :class:`~dwt_tpu_torch.obs.rules
    .AlertRule` objects evaluated against the version's stats dict
    (keys: ``served``/``errors``/``error_rate``/``e2e_ms_p50``/
    ``e2e_ms_p99``).  The default rule set reproduces the two historical
    hardcoded conditions exactly (error rate over threshold; p99 past
    ``p99_factor`` × the armed baseline); ``rules=`` replaces them with
    an operator-supplied set (``--rollback_rules`` on ``dwt-serve``),
    where a ``baseline_factor`` threshold resolves against the pre-swap
    baseline of the same metric.  Rules on ``error_rate`` additionally
    get the FAST trip: they are checked from a quarter window (even a
    small all-errors window is a clear regression — don't wait out the
    grace period serving 500s).

    ``clock`` is injectable (fake-clock tests, the repo convention).
    """

    def __init__(
        self,
        access_log,
        *,
        error_rate_threshold: float = 0.1,
        p99_factor: float = 3.0,
        min_requests: int = 50,
        decide_after_s: float = 30.0,
        clock: Callable[[], float] = time.monotonic,
        rules=None,
    ):
        from dwt_tpu_torch.obs.rules import AlertRule

        self.access_log = access_log
        self.error_rate_threshold = float(error_rate_threshold)
        self.p99_factor = float(p99_factor)
        self.min_requests = int(min_requests)
        self.decide_after_s = float(decide_after_s)
        if rules is not None:
            # Fail at construction, not silently at verdict time: a
            # baseline_factor rule can only resolve against baselines
            # this monitor actually arms (today: the pre-swap e2e p99).
            # An inert custom gate is the exact failure mode the rules
            # surface exists to remove.
            for r in rules:
                if (r.baseline_factor is not None
                        and r.metric not in _BASELINE_METRICS):
                    raise ValueError(
                        f"rollback rule {r.name!r}: baseline_factor "
                        f"needs a metric with an armed baseline "
                        f"{_BASELINE_METRICS}; {r.metric!r} has none — "
                        "use an absolute threshold"
                    )
        self.rules = list(rules) if rules is not None else [
            # The two historical trip conditions, now data.  Order
            # matters: the p99 rule reports first at the full window
            # (matching the pre-rules behavior and its tests).
            AlertRule(
                name="post_swap_p99", metric="e2e_ms_p99", op=">",
                baseline_factor=self.p99_factor, severity="critical",
            ),
            AlertRule(
                name="post_swap_error_rate", metric="error_rate",
                op=">", threshold=self.error_rate_threshold,
                severity="critical",
            ),
        ]
        self._clock = clock
        self._armed = False
        self._version: Optional[str] = None
        self._origin = "reload"
        self._baseline_p99: Optional[float] = None
        self._t_swap: Optional[float] = None

    @property
    def armed(self) -> bool:
        return self._armed

    @property
    def armed_version(self) -> Optional[str]:
        return self._version

    @property
    def armed_origin(self) -> str:
        """Which deploy path armed this watch: ``"reload"`` (checkpoint
        hot reload) or ``"adapt"`` (online-adaptation generation).  The
        shared deploy controller routes the rollback CONSEQUENCE by it —
        a regressed checkpoint gets blacklisted, a regressed adapted
        generation additionally freezes the adapter."""
        return self._origin

    def arm(self, version: str,
            baseline_p99: Optional[float] = None,
            origin: str = "reload") -> None:
        self._armed = True
        self._version = str(version)
        self._baseline_p99 = baseline_p99
        self._origin = str(origin)
        self._t_swap = self._clock()

    def disarm(self) -> None:
        self._armed = False
        self._version = None
        self._origin = "reload"

    def _baselines(self) -> dict:
        """Pre-swap baselines a ``baseline_factor`` rule resolves
        against — today the old version's e2e p99 armed at swap time."""
        if self._baseline_p99 is None:
            return {}
        return {"e2e_ms_p99": self._baseline_p99}

    def verdict(self) -> Optional[str]:
        from dwt_tpu_torch.obs.rules import rule_fires

        if not self._armed:
            return None
        stats = self.access_log.version_stats(self._version)
        total = stats.get("served", 0) + stats.get("errors", 0)
        baselines = self._baselines()
        # Error-rate rules are a fast trip: even a small all-errors
        # window is a clear regression — don't wait out the grace period
        # serving 500s.
        if total >= max(8, self.min_requests // 4):
            for rule in self.rules:
                if rule.metric != "error_rate":
                    continue
                fired = rule_fires(rule, stats, baselines)
                if fired:
                    return f"rollback: {fired} over {total} requests"
        if total < self.min_requests:
            if (self._clock() - self._t_swap) >= self.decide_after_s:
                # Grace period over with a thin window and no fast
                # trip: hold the version (an idle server must not be
                # forced back forever).
                return "ok"
            return None
        for rule in self.rules:
            fired = rule_fires(rule, stats, baselines)
            if fired:
                return f"rollback: {fired}"
        return "ok"
