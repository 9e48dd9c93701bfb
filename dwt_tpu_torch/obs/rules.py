"""Declarative SLO / alert rules over the live metrics registry.

The port of ``dwt_tpu.obs.rules``, line for line.

A rules file is JSON — a list of rule objects (or ``{"rules": [...]}``)::

    [
      {"name": "steps_stalled", "metric": "dwt_train_steps_per_s",
       "op": "<", "threshold": 0.5, "for_s": 30, "severity": "critical"},
      {"name": "ckpt_failing",
       "metric": "dwt_ckpt_save_failures_total",
       "op": ">", "threshold": 0, "severity": "warning"},
      {"name": "serve_shedding",
       "metric": "dwt_serve_requests_total", "labels": {"status": "shed"},
       "op": ">", "threshold": 100, "for_s": 10}
    ]

Semantics (the classic alerting model, fake-clock testable):

* a rule's condition is ``value <op> threshold`` per matching series
  (``labels`` is a subset filter over the series' label set; each
  matching series is tracked independently);
* ``for_s`` is the hysteresis: the condition must hold CONTINUOUSLY for
  that long before the alert fires (a single bad sample does not page);
  once firing, the first healthy evaluation clears it;
* an absent metric makes the rule inert (the subsystem feeding it may
  not be active in this run) — absence is not an alert.

:class:`AlertEngine` samples the registry at step-boundary/heartbeat
cadence (throttled internally), returns fire/clear transitions for the
caller to emit as ``alert`` JSONL records on the existing metric
stream, and exports the firing set as the ``dwt_alerts_firing`` gauge —
so a scraper sees machine-evaluated SLO state next to the raw series.

The fleet's :class:`~dwt_tpu_torch.fleet.canary.PostSwapMonitor` consumes the
same :class:`AlertRule` shape against its per-version access-window
stats (plain value dicts, not the registry) via :func:`rule_fires`;
there, ``baseline_factor`` may replace ``threshold`` — the effective
threshold becomes ``factor × the pre-swap baseline`` armed at swap time.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import operator
import time
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

from dwt_tpu_torch.obs.registry import MetricsRegistry, get_registry

log = logging.getLogger(__name__)

__all__ = [
    "AlertRule",
    "AlertEvent",
    "AlertEngine",
    "load_rules",
    "parse_rules",
    "rule_fires",
]

_OPS: Dict[str, Callable[[float, float], bool]] = {
    ">": operator.gt,
    ">=": operator.ge,
    "<": operator.lt,
    "<=": operator.le,
    "==": operator.eq,
    "!=": operator.ne,
}

_SEVERITIES = ("info", "warning", "critical")

_RULE_KEYS = {
    "name", "metric", "op", "threshold", "for_s", "severity", "labels",
    "baseline_factor",
}


@dataclasses.dataclass(frozen=True)
class AlertRule:
    """One declarative SLO condition (see module doc)."""

    name: str
    metric: str
    op: str
    threshold: Optional[float] = None
    for_s: float = 0.0
    severity: str = "warning"
    labels: Optional[Tuple[Tuple[str, str], ...]] = None
    # PostSwapMonitor only: threshold = baseline_factor x armed baseline.
    baseline_factor: Optional[float] = None

    def matches(self, series_labels: Mapping[str, str]) -> bool:
        if not self.labels:
            return True
        return all(
            series_labels.get(k) == v for k, v in self.labels
        )

    def condition(self, value: float,
                  threshold: Optional[float] = None) -> bool:
        t = self.threshold if threshold is None else threshold
        if t is None:
            return False
        return _OPS[self.op](float(value), float(t))

    def describe(self, value: float,
                 threshold: Optional[float] = None) -> str:
        t = self.threshold if threshold is None else threshold
        return f"{self.metric} {value:g} {self.op} {t:g}"


def parse_rules(spec) -> List[AlertRule]:
    """Validate a decoded rules document (strict: unknown keys, bad
    ops/severities, missing fields all raise — a typo'd rule silently
    never firing is the failure mode this engine exists to remove)."""
    if isinstance(spec, dict):
        if set(spec.keys()) != {"rules"}:
            raise ValueError(
                f"rules document must be a list or {{'rules': [...]}}; "
                f"got keys {sorted(spec.keys())}"
            )
        spec = spec["rules"]
    if not isinstance(spec, list):
        raise ValueError(f"rules document must be a list, got {type(spec)}")
    rules: List[AlertRule] = []
    seen = set()
    for i, r in enumerate(spec):
        if not isinstance(r, dict):
            raise ValueError(f"rule #{i} is not an object: {r!r}")
        unknown = set(r) - _RULE_KEYS
        if unknown:
            raise ValueError(f"rule #{i}: unknown keys {sorted(unknown)}")
        for key in ("name", "metric", "op"):
            if key not in r:
                raise ValueError(f"rule #{i}: missing required {key!r}")
        if r["op"] not in _OPS:
            raise ValueError(
                f"rule {r['name']!r}: unknown op {r['op']!r} "
                f"(valid: {sorted(_OPS)})"
            )
        severity = r.get("severity", "warning")
        if severity not in _SEVERITIES:
            raise ValueError(
                f"rule {r['name']!r}: unknown severity {severity!r} "
                f"(valid: {_SEVERITIES})"
            )
        has_thr = r.get("threshold") is not None
        has_factor = r.get("baseline_factor") is not None
        if has_thr == has_factor:
            raise ValueError(
                f"rule {r['name']!r}: exactly one of threshold / "
                "baseline_factor is required"
            )
        if r["name"] in seen:
            raise ValueError(f"duplicate rule name {r['name']!r}")
        seen.add(r["name"])
        labels = r.get("labels")
        if labels is not None:
            if not isinstance(labels, dict):
                raise ValueError(
                    f"rule {r['name']!r}: labels must be an object"
                )
            labels = tuple(sorted(
                (str(k), str(v)) for k, v in labels.items()
            ))
        rules.append(AlertRule(
            name=str(r["name"]),
            metric=str(r["metric"]),
            op=str(r["op"]),
            threshold=(
                float(r["threshold"]) if has_thr else None
            ),
            for_s=float(r.get("for_s", 0.0)),
            severity=severity,
            labels=labels,
            baseline_factor=(
                float(r["baseline_factor"]) if has_factor else None
            ),
        ))
    return rules


def load_rules(path: str) -> List[AlertRule]:
    with open(path) as f:
        try:
            spec = json.load(f)
        except json.JSONDecodeError as e:
            raise ValueError(f"{path}: not valid JSON: {e}") from None
    return parse_rules(spec)


def rule_fires(rule: AlertRule, values: Mapping[str, float],
               baselines: Optional[Mapping[str, float]] = None,
               ) -> Optional[str]:
    """Evaluate one rule against a plain values dict (the
    PostSwapMonitor path: per-version access-window stats).  Returns the
    firing description, or None (condition false / metric absent /
    baseline required but unknown).  No hysteresis here — the monitor's
    window size IS its hysteresis."""
    value = values.get(rule.metric)
    if value is None:
        return None
    threshold = rule.threshold
    if rule.baseline_factor is not None:
        base = (baselines or {}).get(rule.metric)
        if base is None:
            return None
        threshold = rule.baseline_factor * float(base)
        if rule.condition(value, threshold):
            return (
                f"{rule.metric} {float(value):g} {rule.op} "
                f"{rule.baseline_factor:g}x baseline {float(base):g}"
            )
        return None
    if rule.condition(value, threshold):
        return rule.describe(float(value))
    return None


@dataclasses.dataclass(frozen=True)
class AlertEvent:
    """One fire/clear transition (the ``alert`` JSONL record body)."""

    rule: str
    state: str                     # "firing" | "resolved"
    metric: str
    value: float
    threshold: float
    severity: str
    labels: Dict[str, str]
    pending_s: float               # how long the condition had held

    def record_fields(self) -> dict:
        out = {
            "alert": self.rule,
            "state": self.state,
            "metric": self.metric,
            "value": round(self.value, 6),
            "threshold": self.threshold,
            "severity": self.severity,
            "pending_s": round(self.pending_s, 3),
        }
        if self.labels:
            out["labels"] = dict(self.labels)
        return out


class _SeriesState:
    __slots__ = ("pending_since", "firing")

    def __init__(self):
        self.pending_since: Optional[float] = None
        self.firing = False


class AlertEngine:
    """Evaluate rules against a registry; track pending/firing state.

    ``evaluate()`` returns the TRANSITIONS since the last call (fire and
    clear events) — steady states emit nothing, so the metric stream
    carries alert edges, not spam.  ``maybe_evaluate()`` is the
    boundary-cadence form: throttled to ``min_interval_s`` so a
    steps_per_dispatch=1 hot loop pays one clock read per boundary.

    The firing set is exported as the ``dwt_alerts_firing`` gauge
    (labeled ``alertname``/``severity``), rebuilt each evaluation.
    """

    def __init__(self, rules: Sequence[AlertRule],
                 registry: Optional[MetricsRegistry] = None,
                 clock: Callable[[], float] = time.monotonic,
                 min_interval_s: float = 1.0):
        for r in rules:
            if r.baseline_factor is not None:
                raise ValueError(
                    f"rule {r.name!r}: baseline_factor rules are for the "
                    "fleet's post-swap monitor; registry rules need an "
                    "absolute threshold"
                )
        self.rules = list(rules)
        self.registry = registry or get_registry()
        self._clock = clock
        self.min_interval_s = float(min_interval_s)
        self._last_eval: Optional[float] = None
        self._states: Dict[Tuple[str, Tuple], _SeriesState] = {}
        self._warned_histogram: set = set()
        self._firing_gauge = self.registry.gauge(
            "dwt_alerts_firing",
            "alert rules currently firing (1 per alertname/severity)",
            labelnames=("alertname", "severity"),
        )

    def firing(self) -> List[str]:
        """Names of rules with at least one firing series."""
        out = []
        for (name, _key), st in self._states.items():
            if st.firing and name not in out:
                out.append(name)
        return out

    def maybe_evaluate(self) -> List[AlertEvent]:
        now = self._clock()
        if (self._last_eval is not None
                and now - self._last_eval < self.min_interval_s):
            return []
        return self.evaluate(now)

    def evaluate(self, now: Optional[float] = None) -> List[AlertEvent]:
        now = self._clock() if now is None else now
        self._last_eval = now
        events: List[AlertEvent] = []
        seen = set()
        for rule in self.rules:
            fam = self.registry.get(rule.metric)
            if (fam is not None and fam.kind == "histogram"
                    and rule.name not in self._warned_histogram):
                # A histogram's sampled "value" is its observation
                # COUNT, not a latency — a rule written against (say)
                # dwt_ckpt_stall_ms > 500 would fire after the 500th
                # save, not a 500 ms stall.  Warn once instead of
                # letting the misread fire (or never fire) silently.
                self._warned_histogram.add(rule.name)
                log.warning(
                    "alert rule %r: metric %r is a histogram; the rule "
                    "evaluates its observation COUNT, not observed "
                    "values — use a counter/gauge metric if you meant "
                    "a level threshold", rule.name, rule.metric,
                )
            for labels, value in self.registry.samples(rule.metric):
                if not rule.matches(labels):
                    continue
                key = (rule.name, tuple(sorted(labels.items())))
                seen.add(key)
                st = self._states.get(key)
                if st is None:
                    st = self._states[key] = _SeriesState()
                if rule.condition(value):
                    if st.pending_since is None:
                        st.pending_since = now
                    held = now - st.pending_since
                    if not st.firing and held >= rule.for_s:
                        st.firing = True
                        events.append(AlertEvent(
                            rule.name, "firing", rule.metric,
                            float(value), float(rule.threshold),
                            rule.severity, dict(labels), held,
                        ))
                else:
                    if st.firing:
                        events.append(AlertEvent(
                            rule.name, "resolved", rule.metric,
                            float(value), float(rule.threshold),
                            rule.severity, dict(labels),
                            now - (st.pending_since or now),
                        ))
                    st.firing = False
                    st.pending_since = None
        # A series that disappeared (family cleared) resolves silently:
        # drop its state so a re-appearing series starts clean.
        for key in list(self._states):
            if key not in seen:
                del self._states[key]
        # Export the firing set: clear + re-set is O(firing) and keeps
        # stale label combinations out of the scrape.
        severities = {r.name: r.severity for r in self.rules}
        self._firing_gauge.clear()
        for name in self.firing():
            self._firing_gauge.labels(
                alertname=name, severity=severities.get(name, "warning"),
            ).set(1)
        return events
