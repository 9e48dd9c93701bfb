"""Process-wide metrics registry: counters, gauges, histograms, labels.

The port of ``dwt_tpu.obs.registry``, line for line (it imports only the
standard library); the rendered text of the same operations is the JAX
package's byte for byte.

This module is the LIVE surface — a thread-safe, dependency-free
registry the serving access log, the deploy pipeline and the online
adapter feed as they run, scraped through the Prometheus text
exposition in ``prom.py`` and evaluated by the SLO rules in ``rules.py``.

Design rules:

* **sub-µs hot path** — an increment is one dict-free attribute update
  under a per-child ``threading.Lock`` (uncontended acquire/release is
  ~100 ns); label resolution (``labels(...)``) does one tuple build +
  dict get, and hot call sites cache the returned child so steady-state
  cost is just the locked add.  No I/O, no allocation beyond the tuple.
* **zero device syncs** — metric values are host-side numbers the call
  sites already have (an instrumented site must never ``float()`` a
  device array just to feed a gauge).
* **always on** — unlike tracing there is no enable gate: the registry
  exists so /metrics can be scraped at any time.  The feed sites are
  chosen so the always-on cost is boundary/heartbeat/request cadence,
  never per-device-op.
* **get-or-create is idempotent** — registering the same metric twice
  (two ``AccessLog`` instances in one process, a test building several
  servers) returns the same family; a name re-registered with a
  different type or label set raises, because silently forking a metric
  is how dashboards lie.

Prometheus naming conventions apply: counters end in ``_total``, units
ride in the name (``_ms``, ``_bytes``), label values are strings.
"""

from __future__ import annotations

import bisect
import threading
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = [
    "MetricsRegistry",
    "get_registry",
    "DEFAULT_LATENCY_MS_BUCKETS",
]

# Fixed latency buckets (milliseconds) shared by every *_ms histogram in
# the repo: spanning sub-ms CPU lenet serving to multi-second flagship
# steps.  Fixed (not adaptive): cross-run and cross-replica aggregation
# requires identical bucket bounds everywhere.
DEFAULT_LATENCY_MS_BUCKETS = (
    1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0,
    1000.0, 2500.0, 5000.0, 10000.0,
)

_VALID_KINDS = ("counter", "gauge", "histogram")


def _check_name(name: str) -> str:
    if not name or not all(
        c.isalnum() or c in "_:" for c in name
    ) or name[0].isdigit():
        raise ValueError(f"invalid metric name {name!r}")
    return name


class _Child:
    """One labeled series of a family; the object hot call sites cache."""

    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    def get(self) -> float:
        with self._lock:
            return self._value


class _Counter(_Child):
    __slots__ = ()

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters only go up; use a gauge")
        with self._lock:
            self._value += amount


class _Gauge(_Child):
    __slots__ = ("_fn",)

    def __init__(self):
        super().__init__()
        self._fn: Optional[Callable[[], float]] = None

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value -= amount

    def set_function(self, fn: Optional[Callable[[], float]]) -> None:
        """Callback gauge: sampled at collect/scrape time instead of
        pushed.  For live quantities that already have an owner (queue
        depth, heartbeat age) — re-registering overwrites, so the newest
        owner wins (tests build several servers per process)."""
        self._fn = fn

    def get(self) -> float:
        fn = self._fn
        if fn is not None:
            try:
                return float(fn())
            except Exception:
                # A scrape must never take down the process the metric
                # observes; a dead callback reads as 0, and the scraper
                # sees the discontinuity.
                return 0.0
        return super().get()


class _Histogram(_Child):
    """Fixed-bucket histogram: cumulative counts rendered at exposition.

    ``observe`` is bisect + two adds under the lock — no allocation, no
    percentile math on the hot path (quantiles are the scraper's job;
    the repo's own nearest-rank summaries stay with ``AccessLog``).
    """

    __slots__ = ("_bounds", "_counts", "_sum", "_count")

    def __init__(self, bounds: Sequence[float]):
        super().__init__()
        self._bounds = tuple(float(b) for b in bounds)
        self._counts = [0] * (len(self._bounds) + 1)  # +1: the +Inf bucket
        self._sum = 0.0
        self._count = 0

    def observe(self, value: float) -> None:
        v = float(value)
        i = bisect.bisect_left(self._bounds, v)
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1

    def snapshot(self) -> Tuple[Tuple[float, ...], List[int], float, int]:
        with self._lock:
            return self._bounds, list(self._counts), self._sum, self._count

    def get(self) -> float:  # the rules engine reads a histogram's count
        with self._lock:
            return float(self._count)


_CHILD_TYPES = {
    "counter": _Counter,
    "gauge": _Gauge,
    "histogram": _Histogram,
}


class MetricFamily:
    """One named metric + its labeled children."""

    def __init__(self, name: str, kind: str, help: str,
                 labelnames: Sequence[str],
                 buckets: Optional[Sequence[float]] = None):
        self.name = _check_name(name)
        if kind not in _VALID_KINDS:
            raise ValueError(f"unknown metric kind {kind!r}")
        self.kind = kind
        self.help = str(help)
        self.labelnames = tuple(str(n) for n in labelnames)
        if kind == "histogram":
            b = tuple(float(x) for x in (
                buckets if buckets is not None else DEFAULT_LATENCY_MS_BUCKETS
            ))
            if list(b) != sorted(set(b)):
                raise ValueError(f"histogram buckets must be strictly "
                                 f"ascending, got {buckets!r}")
            self.buckets = b
        else:
            if buckets is not None:
                raise ValueError("buckets only apply to histograms")
            self.buckets = None
        if "le" in self.labelnames:
            raise ValueError("'le' is reserved for histogram buckets")
        self._lock = threading.Lock()
        self._children: Dict[Tuple[str, ...], _Child] = {}
        if not self.labelnames:
            self._default = self._make_child()
            self._children[()] = self._default
        else:
            self._default = None

    def _make_child(self) -> _Child:
        if self.kind == "histogram":
            return _Histogram(self.buckets)
        return _CHILD_TYPES[self.kind]()

    def labels(self, *labelvalues, **labelkw):
        """The child for one label-value combination (created on first
        use, cached — hot sites should cache the return)."""
        if labelkw:
            if labelvalues:
                raise ValueError("pass labels positionally OR by name")
            try:
                labelvalues = tuple(
                    labelkw[n] for n in self.labelnames
                )
            except KeyError as e:
                raise ValueError(
                    f"{self.name}: missing label {e} "
                    f"(labelnames={self.labelnames})"
                ) from None
            if len(labelkw) != len(self.labelnames):
                extra = set(labelkw) - set(self.labelnames)
                raise ValueError(f"{self.name}: unknown labels {extra}")
        if len(labelvalues) != len(self.labelnames):
            raise ValueError(
                f"{self.name} takes labels {self.labelnames}, got "
                f"{labelvalues!r}"
            )
        key = tuple(str(v) for v in labelvalues)
        child = self._children.get(key)
        if child is None:
            with self._lock:
                child = self._children.get(key)
                if child is None:
                    child = self._children[key] = self._make_child()
        return child

    def clear(self) -> None:
        """Drop every labeled child (info-style gauges whose label set
        IS the value — e.g. the served version — clear before re-set so
        stale label combinations stop being exported)."""
        with self._lock:
            self._children = {}
            if not self.labelnames:
                self._default = self._make_child()
                self._children[()] = self._default

    # Unlabeled convenience: family proxies to its single child.
    def _one(self) -> _Child:
        if self._default is None:
            raise ValueError(
                f"{self.name} has labels {self.labelnames}; call "
                ".labels(...) first"
            )
        return self._default

    def inc(self, amount: float = 1.0) -> None:
        self._one().inc(amount)  # type: ignore[attr-defined]

    def dec(self, amount: float = 1.0) -> None:
        self._one().dec(amount)  # type: ignore[attr-defined]

    def set(self, value: float) -> None:
        self._one().set(value)  # type: ignore[attr-defined]

    def set_function(self, fn) -> None:
        self._one().set_function(fn)  # type: ignore[attr-defined]

    def observe(self, value: float) -> None:
        self._one().observe(value)  # type: ignore[attr-defined]

    def samples(self) -> List[Tuple[Dict[str, str], _Child]]:
        """[(labels dict, child)] snapshot, insertion-ordered."""
        with self._lock:
            items = list(self._children.items())
        return [
            (dict(zip(self.labelnames, key)), child)
            for key, child in items
        ]


class MetricsRegistry:
    """Name -> :class:`MetricFamily`, with idempotent get-or-create."""

    def __init__(self):
        self._lock = threading.Lock()
        self._families: Dict[str, MetricFamily] = {}

    def _get_or_create(self, name: str, kind: str, help: str,
                       labelnames: Sequence[str],
                       buckets=None) -> MetricFamily:
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if fam.kind != kind or fam.labelnames != tuple(labelnames):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{fam.kind}{fam.labelnames}; cannot re-register "
                        f"as {kind}{tuple(labelnames)}"
                    )
                return fam
            fam = MetricFamily(name, kind, help, labelnames, buckets)
            self._families[name] = fam
            return fam

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = ()) -> MetricFamily:
        return self._get_or_create(name, "counter", help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: Sequence[str] = ()) -> MetricFamily:
        return self._get_or_create(name, "gauge", help, labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: Sequence[str] = (),
                  buckets: Optional[Sequence[float]] = None) -> MetricFamily:
        return self._get_or_create(
            name, "histogram", help, labelnames, buckets
        )

    def families(self) -> List[MetricFamily]:
        with self._lock:
            return list(self._families.values())

    def get(self, name: str) -> Optional[MetricFamily]:
        with self._lock:
            return self._families.get(name)

    # ----------------------------------------------------------- reading

    def samples(self, name: str) -> List[Tuple[Dict[str, str], float]]:
        """[(labels, value)] for one family (the rules engine's read
        path); histograms report their observation count.  Unknown name
        -> [] (an absent metric makes a rule inert, not an error — the
        subsystem feeding it may simply not be active in this run)."""
        fam = self.get(name)
        if fam is None:
            return []
        return [(labels, child.get()) for labels, child in fam.samples()]

    def value(self, name: str,
              labels: Optional[Dict[str, str]] = None) -> Optional[float]:
        """One series' current value, or None when absent (tests,
        quick reads).  ``labels=None`` on a single-series family reads
        that series."""
        samples = self.samples(name)
        if labels is None and len(samples) == 1:
            return samples[0][1]
        want = {k: str(v) for k, v in (labels or {}).items()}
        for got, v in samples:
            if got == want:
                return v
        return None


_DEFAULT = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """The process-wide default registry every instrumented call site
    feeds and every /metrics endpoint renders."""
    return _DEFAULT
