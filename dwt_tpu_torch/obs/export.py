"""Chrome trace-event export + crash-surviving flight recorder — ``dwt_tpu.obs.export``, copied.

The one change from the JAX module: :func:`_process_index` imports
neither jax nor torch (see there).

Exports the tracer's span buffers as Chrome trace-event JSON — the
format Perfetto (https://ui.perfetto.dev), ``chrome://tracing``, and
TensorBoard's trace viewer all load.  One file per process; multi-host
runs stamp ``pid`` = the process's rank (when a process group is up) and the shared
``run_id`` into every file so they merge by concatenating
``traceEvents``.

The **flight recorder** answers the post-mortem question the watchdog's
stack dumps cannot: the stacks say where every thread *is*, the last-N
seconds of spans say what they had been *doing*.  ``flight_dump`` writes
that trailing window next to the ``stacks-*.txt`` evidence and is safe
to call from the watchdog thread while the main thread is wedged (pure
Python + file I/O, ring reads are lock-poll only).
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import List, Optional

from dwt_tpu_torch.obs import spans as _spans

# Required per-event keys of a complete ("X") trace event — the contract
# tests/test_obs.py validates exported files against.
CHROME_EVENT_KEYS = ("name", "cat", "ph", "ts", "dur", "pid", "tid")


def _process_index() -> int:
    """The process's rank in an initialized ``torch.distributed`` group,
    else 0.  Imports nothing: torch is read from ``sys.modules`` only when
    the process already loaded it, so the report tool and the torch-free
    fleet balancer never pay for (or hold) a CUDA-capable import, and a
    flight dump from the watchdog thread never enters torch's import
    lock."""
    torch = sys.modules.get("torch")
    if torch is None:
        return 0
    try:
        dist = torch.distributed
        if dist.is_available() and dist.is_initialized():
            return int(dist.get_rank())
    except Exception:  # noqa: BLE001 — a diagnostic never fails on this
        pass
    return 0


def to_chrome_trace(records: List[dict], tracer=None,
                    pid: Optional[int] = None) -> dict:
    """Span dicts (``Tracer.snapshot`` layout) -> Chrome trace JSON dict.

    Timestamps convert from the tracer's perf_counter epoch to unix
    microseconds via the tracer's one wall-clock anchor, so files from
    processes with different monotonic epochs line up when merged.
    """
    tracer = tracer or _spans.get_tracer()
    if pid is None:
        pid = _process_index()
    anchor = 0.0
    run_id = None
    if tracer is not None:
        anchor = tracer.t0_unix - tracer.t0_perf
        run_id = tracer.run_id
    events = []
    tids = {}
    for r in records:
        tids.setdefault(r["tid"], r.get("thread", str(r["tid"])))
        ev = {
            "name": r["name"],
            "cat": r["cat"] or "span",
            "ph": "X",
            "ts": (r["ts"] + anchor) * 1e6,  # microseconds
            "dur": r["dur"] * 1e6,
            "pid": int(pid),
            "tid": int(r["tid"]),
        }
        args = dict(r.get("attrs") or {})
        if run_id is not None:
            args.setdefault("run_id", run_id)
        if args:
            ev["args"] = args
        events.append(ev)
    # Metadata events name the process/threads in the viewer.
    meta = [{
        "name": "process_name", "ph": "M", "pid": int(pid), "tid": 0,
        "args": {"name": f"dwt run={run_id or '?'} proc={pid}"},
    }]
    for tid, tname in sorted(tids.items()):
        meta.append({
            "name": "thread_name", "ph": "M", "pid": int(pid),
            "tid": int(tid), "args": {"name": tname},
        })
    out = {
        "traceEvents": meta + events,
        "displayTimeUnit": "ms",
        "otherData": {
            "run_id": run_id,
            "process_index": int(pid),
            "producer": "dwt_tpu_torch.obs",
        },
    }
    if tracer is not None:
        out["otherData"]["dropped_spans"] = tracer.dropped_spans()
    return out


def export(path: Optional[str] = None) -> Optional[str]:
    """Write the full span buffers as a Chrome trace file.

    ``path`` defaults to the configured ``--obs_trace`` target; returns
    the written path, or None when tracing is disabled or no path is
    known.  Multi-process runs suffix non-zero process indices so hosts
    sharing a filesystem don't clobber one file.
    """
    tracer = _spans.get_tracer()
    if tracer is None:
        return None
    path = path or _spans.export_path()
    if not path:
        return None
    pid = _process_index()
    if pid != 0:
        root, ext = os.path.splitext(path)
        path = f"{root}.proc{pid}{ext or '.json'}"
    trace = to_chrome_trace(tracer.snapshot(), tracer, pid=pid)
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    tmp = f"{path}.tmp-{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(trace, f)
    os.replace(tmp, path)
    return path


# Trailing window the flight recorder keeps: long enough to cover a few
# steps plus the stall that tripped the watchdog, short enough that the
# dump stays small and the signal is "what JUST happened".
FLIGHT_WINDOW_S = 5.0

# Default dump-retention cap when the caller has no --watchdog_keep to
# pass through (guard-event dumps on a loop run without a watchdog): a
# flapping guard over a long traced run must not fill the disk.
DEFAULT_FLIGHT_KEEP = 5


def _prune_span_dumps(directory: str, keep: int) -> None:
    """Cap ``spans-*.json`` files in ``directory`` to the newest ``keep``
    (oldest mtime first out).  Best-effort: retention must never block
    the dump it makes room for."""
    try:
        dumps = [
            os.path.join(directory, name)
            for name in os.listdir(directory)
            if name.startswith("spans-") and name.endswith(".json")
        ]
        dumps.sort(key=os.path.getmtime)
        for stale in dumps[: max(len(dumps) - keep, 0)]:
            os.unlink(stale)
    except OSError:
        pass


def flight_dump(directory: str, reason: str,
                last_s: float = FLIGHT_WINDOW_S,
                keep: Optional[int] = DEFAULT_FLIGHT_KEEP) -> Optional[str]:
    """Dump the last ``last_s`` seconds of spans to
    ``<directory>/spans-<pid>-<ts>[-<n>].json`` (Chrome trace format, so
    the same viewers open it); the ``-<n>`` suffix keeps same-second
    dumps distinct (a local plus a remote-mirrored guard event at one
    boundary).  ``keep`` caps the directory's span dumps (None skips
    pruning — the watchdog prunes with its own ``--watchdog_keep``).
    No-op (None) when tracing is disabled; never raises — this runs on
    the watchdog thread mid-stall and on guard event paths where a
    logging failure must not mask the real fault.
    """
    tracer = _spans.get_tracer()
    if tracer is None:
        return None
    try:
        records = tracer.snapshot(last_s=last_s)
        trace = to_chrome_trace(records, tracer)
        trace["otherData"]["flight_reason"] = reason
        trace["otherData"]["window_s"] = last_s
        os.makedirs(directory, exist_ok=True)
        if keep is not None:
            _prune_span_dumps(directory, max(keep - 1, 0))
        base = os.path.join(
            directory, f"spans-{os.getpid()}-{int(time.time())}"
        )
        path = base + ".json"
        seq = 0
        while os.path.exists(path):
            seq += 1
            path = f"{base}-{seq}.json"
        with open(path, "w") as f:
            json.dump(trace, f)
            f.flush()
            os.fsync(f.fileno())
        return path
    except Exception:  # noqa: BLE001 — diagnostics must never kill the run
        return None


def validate_chrome_trace(trace: dict) -> List[str]:
    """Structural validation of an exported trace (the test contract):
    returns a list of problems, empty = valid.  Checks the required keys,
    numeric non-negative ts/dur, int pid/tid, and known phase codes."""
    problems = []
    events = trace.get("traceEvents")
    if not isinstance(events, list):
        return ["traceEvents missing or not a list"]
    for i, ev in enumerate(events):
        ph = ev.get("ph")
        if ph == "M":
            if "name" not in ev or "args" not in ev:
                problems.append(f"event {i}: metadata without name/args")
            continue
        if ph != "X":
            problems.append(f"event {i}: unexpected phase {ph!r}")
            continue
        for key in CHROME_EVENT_KEYS:
            if key not in ev:
                problems.append(f"event {i}: missing key {key!r}")
        ts, dur = ev.get("ts"), ev.get("dur")
        if not isinstance(ts, (int, float)) or ts < 0:
            problems.append(f"event {i}: bad ts {ts!r}")
        if not isinstance(dur, (int, float)) or dur < 0:
            problems.append(f"event {i}: bad dur {dur!r}")
        if not isinstance(ev.get("pid"), int):
            problems.append(f"event {i}: pid not int")
        if not isinstance(ev.get("tid"), int):
            problems.append(f"event {i}: tid not int")
    return problems
