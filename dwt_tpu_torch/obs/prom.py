"""Prometheus text-format v0.0.4 exposition, dependency-free.

The port of ``dwt_tpu.obs.prom``, line for line.

Three consumers share this module:

* ``dwt-serve`` and ``dwt-fleet`` add a ``/metrics`` route to their
  existing HTTP front ends (``render`` + :data:`CONTENT_TYPE`);
* the training CLIs — which have no HTTP server — start a
  :func:`start_exporter` stdlib-HTTP daemon thread on ``--metrics_port``
  (the train loop's first live surface: scrape steps/s, loss, guard
  events, checkpoint stalls mid-run instead of tailing JSONL);
* the fleet balancer aggregates its replicas' expositions
  (:func:`parse_exposition` + :func:`merge_expositions`): every replica
  sample re-emitted with a ``replica="N"`` label next to the balancer's
  own series, one scrape for the whole fleet.

``validate_exposition`` is the format gate the tests assert — line
grammar, HELP/TYPE/sample consistency, histogram bucket monotonicity and
the ``+Inf``-equals-``_count`` invariant — so "valid Prometheus text"
is a checked property, not a hope.
"""

from __future__ import annotations

import json
import logging
import math
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Sequence, Tuple

from dwt_tpu_torch.obs.registry import MetricsRegistry, get_registry

log = logging.getLogger(__name__)

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

__all__ = [
    "CONTENT_TYPE",
    "render",
    "parse_exposition",
    "validate_exposition",
    "merge_expositions",
    "start_exporter",
    "exporter_port",
]


def _escape_help(s: str) -> str:
    return s.replace("\\", "\\\\").replace("\n", "\\n")


def _escape_label(s: str) -> str:
    return (
        s.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")
    )


def _fmt_value(v: float) -> str:
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if math.isnan(v):
        return "NaN"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _fmt_labels(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(
        f'{k}="{_escape_label(str(v))}"' for k, v in labels.items()
    )
    return "{" + inner + "}"


def render(registry: Optional[MetricsRegistry] = None) -> str:
    """The registry as Prometheus text exposition (one scrape body)."""
    registry = registry or get_registry()
    lines: List[str] = []
    for fam in registry.families():
        lines.append(f"# HELP {fam.name} {_escape_help(fam.help)}")
        lines.append(f"# TYPE {fam.name} {fam.kind}")
        for labels, child in fam.samples():
            if fam.kind == "histogram":
                bounds, counts, total, count = child.snapshot()
                cum = 0
                for b, c in zip(bounds, counts):
                    cum += c
                    lab = dict(labels)
                    lab["le"] = _fmt_value(b)
                    lines.append(
                        f"{fam.name}_bucket{_fmt_labels(lab)} {cum}"
                    )
                lab = dict(labels)
                lab["le"] = "+Inf"
                lines.append(
                    f"{fam.name}_bucket{_fmt_labels(lab)} {count}"
                )
                lines.append(
                    f"{fam.name}_sum{_fmt_labels(labels)} "
                    f"{_fmt_value(total)}"
                )
                lines.append(
                    f"{fam.name}_count{_fmt_labels(labels)} {count}"
                )
            else:
                lines.append(
                    f"{fam.name}{_fmt_labels(labels)} "
                    f"{_fmt_value(child.get())}"
                )
    return "\n".join(lines) + ("\n" if lines else "")


# ------------------------------------------------------------- parsing

_NAME_RE = r"[a-zA-Z_:][a-zA-Z0-9_:]*"
_SAMPLE_RE = re.compile(
    rf"^({_NAME_RE})(\{{(.*)\}})?\s+(\S+)(\s+-?\d+)?\s*$"
)
_LABEL_RE = re.compile(
    rf'({_NAME_RE})="((?:[^"\\]|\\.)*)"\s*(,|$)'
)
_HELP_RE = re.compile(rf"^# HELP ({_NAME_RE})(?: (.*))?$")
_TYPE_RE = re.compile(rf"^# TYPE ({_NAME_RE}) (\w+)$")

_HIST_SUFFIXES = ("_bucket", "_sum", "_count")


def _unescape_label(s: str) -> str:
    # One left-to-right pass, NOT chained str.replace: sequential
    # replaces mis-decode an escaped backslash followed by 'n'/'"'
    # ('ckpt\\next' escaped is 'ckpt\\\\next'; replace("\\n", ...) would
    # eat the second backslash plus the n).
    out = []
    i = 0
    while i < len(s):
        c = s[i]
        if c == "\\" and i + 1 < len(s):
            nxt = s[i + 1]
            if nxt == "n":
                out.append("\n")
                i += 2
                continue
            if nxt in ('"', "\\"):
                out.append(nxt)
                i += 2
                continue
        out.append(c)
        i += 1
    return "".join(out)


def _parse_labels(body: str) -> Dict[str, str]:
    labels: Dict[str, str] = {}
    pos = 0
    body = body.strip()
    while pos < len(body):
        m = _LABEL_RE.match(body, pos)
        if m is None:
            raise ValueError(f"bad label syntax at {body[pos:]!r}")
        labels[m.group(1)] = _unescape_label(m.group(2))
        pos = m.end()
    return labels


def _parse_value(s: str) -> float:
    if s == "+Inf":
        return math.inf
    if s == "-Inf":
        return -math.inf
    if s == "NaN":
        return math.nan
    return float(s)


class Family:
    """One parsed metric family: declared type/help + raw samples."""

    def __init__(self, name: str, kind: str = "untyped", help: str = ""):
        self.name = name
        self.kind = kind
        self.help = help
        # Raw sample rows: (sample_name, labels dict, value) — histogram
        # samples keep their _bucket/_sum/_count names so a merged
        # re-render is byte-faithful to what each process exported.
        self.samples: List[Tuple[str, Dict[str, str], float]] = []


def _base_name(sample_name: str, families: Dict[str, "Family"]) -> str:
    """The family a sample row belongs to: its own name, or — for
    histogram sub-samples — the declared family it suffixes."""
    if sample_name in families:
        return sample_name
    for suf in _HIST_SUFFIXES:
        if sample_name.endswith(suf):
            base = sample_name[: -len(suf)]
            if base in families and families[base].kind == "histogram":
                return base
    return sample_name


def parse_exposition(text: str) -> Dict[str, Family]:
    """Text exposition -> ordered {family name: :class:`Family`}.
    Raises ``ValueError`` on lines that fit no grammar."""
    families: Dict[str, Family] = {}

    def fam(name: str, kind=None, help=None) -> Family:
        f = families.get(name)
        if f is None:
            f = families[name] = Family(name)
        if kind is not None:
            f.kind = kind
        if help is not None:
            f.help = help
        return f

    for lineno, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("#"):
            m = _HELP_RE.match(line)
            if m:
                fam(m.group(1), help=m.group(2) or "")
                continue
            m = _TYPE_RE.match(line)
            if m:
                fam(m.group(1), kind=m.group(2))
                continue
            continue  # other comments are legal and ignored
        m = _SAMPLE_RE.match(line)
        if m is None:
            raise ValueError(f"line {lineno}: unparsable sample {line!r}")
        name, _, label_body, value_s = (
            m.group(1), m.group(2), m.group(3), m.group(4)
        )
        labels = _parse_labels(label_body) if label_body else {}
        value = _parse_value(value_s)
        fam(_base_name(name, families)).samples.append(
            (name, labels, value)
        )
    return families


_KNOWN_TYPES = ("counter", "gauge", "histogram", "summary", "untyped")


def validate_exposition(text: str) -> List[str]:
    """Structural problems with a text exposition ([] = valid).

    Checks: line grammar (via the parser), known TYPE values, counter
    monotonic-from-zero plausibility (non-negative, non-NaN), histogram
    cumulative-bucket monotonicity per series and ``le="+Inf"`` equal to
    the series' ``_count``.
    """
    problems: List[str] = []
    try:
        families = parse_exposition(text)
    except ValueError as e:
        return [str(e)]
    for fam in families.values():
        if fam.kind not in _KNOWN_TYPES:
            problems.append(f"{fam.name}: unknown TYPE {fam.kind!r}")
            continue
        if fam.kind == "counter":
            for name, labels, value in fam.samples:
                if math.isnan(value) or value < 0:
                    problems.append(
                        f"{fam.name}: counter sample {labels} has "
                        f"non-monotonic value {value}"
                    )
        if fam.kind == "histogram":
            # Group sub-samples by the label set minus `le`.
            series: Dict[Tuple, Dict] = {}
            for name, labels, value in fam.samples:
                key = tuple(sorted(
                    (k, v) for k, v in labels.items() if k != "le"
                ))
                s = series.setdefault(
                    key, {"buckets": [], "sum": None, "count": None}
                )
                if name.endswith("_bucket"):
                    if "le" not in labels:
                        problems.append(
                            f"{fam.name}: _bucket sample missing le "
                            f"label: {labels}"
                        )
                        continue
                    s["buckets"].append(
                        (_parse_value(labels["le"]), value)
                    )
                elif name.endswith("_sum"):
                    s["sum"] = value
                elif name.endswith("_count"):
                    s["count"] = value
                else:
                    problems.append(
                        f"{fam.name}: unexpected histogram sample {name}"
                    )
            for key, s in series.items():
                buckets = sorted(s["buckets"], key=lambda bv: bv[0])
                if not buckets or not math.isinf(buckets[-1][0]):
                    problems.append(
                        f"{fam.name}{dict(key)}: histogram without an "
                        "le=\"+Inf\" bucket"
                    )
                    continue
                counts = [c for _, c in buckets]
                if any(b > a for a, b in zip(counts[1:], counts)):
                    problems.append(
                        f"{fam.name}{dict(key)}: bucket counts not "
                        f"monotonically non-decreasing: {counts}"
                    )
                if s["count"] is None or s["sum"] is None:
                    problems.append(
                        f"{fam.name}{dict(key)}: histogram missing "
                        "_sum/_count"
                    )
                elif counts[-1] != s["count"]:
                    problems.append(
                        f"{fam.name}{dict(key)}: le=\"+Inf\" bucket "
                        f"{counts[-1]} != _count {s['count']}"
                    )
    return problems


def merge_expositions(
    parts: Sequence[Tuple[Dict[str, str], str]],
) -> str:
    """Merge expositions into one, adding per-part labels — the fleet's
    aggregation: ``[({}, balancer_text), ({"replica": "0"}, r0_text),
    ...]``.  HELP/TYPE emit once per family (first declaration wins —
    replicas run the same code, so declarations agree); every sample of
    a part gets that part's extra labels.  A part that fails to parse is
    SKIPPED with a log line: one replica's garbage must not take down
    the whole fleet's scrape.
    """
    merged: Dict[str, Family] = {}
    for extra, text in parts:
        try:
            families = parse_exposition(text)
        except ValueError as e:
            log.warning("metrics merge: skipping unparsable part %s: %s",
                        extra, e)
            continue
        for name, fam in families.items():
            out = merged.get(name)
            if out is None:
                out = merged[name] = Family(name, fam.kind, fam.help)
            for sname, labels, value in fam.samples:
                labels = dict(labels)
                # Part labels go FIRST so a scrape reads replica="0"
                # up front; a sample's own label of the same name wins
                # (it is more specific).
                labels = {**extra, **labels}
                out.samples.append((sname, labels, value))
    lines: List[str] = []
    for fam in merged.values():
        if fam.help:
            lines.append(f"# HELP {fam.name} {_escape_help(fam.help)}")
        if fam.kind != "untyped":
            lines.append(f"# TYPE {fam.name} {fam.kind}")
        for sname, labels, value in fam.samples:
            lines.append(
                f"{sname}{_fmt_labels(labels)} {_fmt_value(value)}"
            )
    return "\n".join(lines) + ("\n" if lines else "")


# ------------------------------------------------------------- exporter

class _MetricsHandler(BaseHTTPRequestHandler):
    registry: MetricsRegistry = None  # type: ignore[assignment]

    def log_message(self, fmt, *args):
        log.debug("metrics http: " + fmt, *args)

    def do_GET(self):
        if self.path.split("?")[0] not in ("/metrics", "/"):
            body = json.dumps({"error": f"unknown path {self.path}"})
            self.send_response(404)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body.encode())
            return
        try:
            fn = getattr(self, "render_fn", None)
            body = (fn() if fn is not None else render(self.registry)).encode()
        except Exception as e:  # a scrape must answer, not die
            log.exception("metrics render failed")
            body = f"# render failed: {type(e).__name__}: {e}\n".encode()
        self.send_response(200)
        self.send_header("Content-Type", CONTENT_TYPE)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


_EXPORTER_LOCK = threading.Lock()
_EXPORTER: Optional[ThreadingHTTPServer] = None


def start_exporter(port: int, host: str = "127.0.0.1",
                   registry: Optional[MetricsRegistry] = None,
                   render_fn=None,
                   ) -> ThreadingHTTPServer:
    """Serve ``/metrics`` on a daemon thread (the training CLIs'
    ``--metrics_port``; 0 binds an ephemeral port — read it back from
    the return's ``server_address``).  Idempotent per process: a second
    call returns the running exporter (the two training entry points
    share one registry, so one scrape surface is correct).

    ``render_fn`` overrides the body production entirely — an
    aggregator (the sweep supervisor merging per-job expositions via
    :func:`merge_expositions`) serves something richer than one
    registry's render; exceptions still answer the scrape with a
    comment line rather than killing the connection."""
    global _EXPORTER
    with _EXPORTER_LOCK:
        if _EXPORTER is not None:
            return _EXPORTER
        handler = type("Handler", (_MetricsHandler,), {
            "registry": registry or get_registry(),
            "render_fn": staticmethod(render_fn) if render_fn else None,
        })
        server = ThreadingHTTPServer((host, int(port)), handler)
        server.daemon_threads = True
        thread = threading.Thread(
            target=server.serve_forever, name="dwt-metrics-exporter",
            daemon=True,
        )
        thread.start()
        _EXPORTER = server
        return server


def exporter_port() -> Optional[int]:
    """Bound port of the running exporter (None when not started)."""
    with _EXPORTER_LOCK:
        return (
            _EXPORTER.server_address[1] if _EXPORTER is not None else None
        )


def stop_exporter() -> None:
    """Shut the exporter down (tests; CLIs just exit the process)."""
    global _EXPORTER
    with _EXPORTER_LOCK:
        server, _EXPORTER = _EXPORTER, None
    if server is not None:
        server.shutdown()
        server.server_close()
