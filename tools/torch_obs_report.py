"""Offline attribution reporter of the port: trace files + metrics JSONL -> tables.

``tools/obs_report.py`` for the PyTorch port: the same report, read from
the same Chrome trace-event files, with ``percentile_summary`` taken from
``dwt_tpu_torch.utils.metrics`` (the JAX tool imports ``dwt_tpu``, and
so jax).  It imports neither jax nor torch.  Its ``--json`` keeps
``"kind": "obs_report"``, so ``tools/obs_diff.py`` reads it unchanged.

Reads the Chrome trace-event files the port's span tracer exports
(``--obs_trace`` on ``dwt_tpu_torch.cli.usps_mnist``, ``cli.officehome``,
``cli.visda``, ``dwt_tpu_torch.serve.server`` and
``tools/torch_serve_bench.py``; flight-recorder dumps under
``ckpt_dir/watchdog/spans-*.json`` load the same way) plus optional
training/access metrics JSONL, and answers "where did the time go":

* **per-step wall-time breakdown** — the train loop's top-level phases
  (batch wait / step dispatch / metric copy start / harvest drain with
  its nested blocking metric host fetch / boundary / eval / checkpoint
  enqueue) as *self-time* shares of the loop wall clock, with
  an explicit ``unattributed`` residual so the table always accounts for
  100% of the wall time.  Self-time means a nested span's time is never
  double-counted into its parent: the rows sum exactly to the union of
  traced intervals, and the residual is the genuine gap the
  instrumentation does not cover (the next span to add).
* **serving latency decomposition** — per-bucket stage/device/resolve
  span percentiles plus admission/plan, correlated with access-record
  aggregates when an access JSONL is given.
* **background threads** — eval-pipeline internals, checkpoint writer
  phases, prefetch producer (data) spans, each summarized per category.
* **machine-readable summary** (``--json``) — the same numbers as one
  JSON object, diffable across runs (the PERF.md A/B workflow).

Multi-process: pass every process's trace file; events carry ``pid`` =
the process's rank and the shared ``run_id``, so files merge by
concatenation and the report prints one breakdown per process.

Usage::

    python tools/torch_obs_report.py /tmp/run.trace.json
    python tools/torch_obs_report.py ckpt/watchdog/spans-*.json
    python tools/torch_obs_report.py run.trace.json --metrics run.jsonl \
        --json report.json
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys
from typing import Dict, List, Optional, Tuple

# Allow `python tools/obs_report.py` from any cwd in a source checkout.
sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)

from dwt_tpu_torch.utils.metrics import percentile_summary  # noqa: E402

# Top-level train-loop phases live in this category (see dwt_tpu_torch/obs
# docstring); "detail" spans nest inside "boundary" and are reported
# separately so the top-level sum stays exact.
TRAIN_CAT = "step"


# ------------------------------------------------------------ trace loading


def load_traces(paths: List[str]) -> Tuple[List[dict], dict]:
    """Merge trace files -> (complete events, meta).  Metadata events and
    malformed entries are dropped; ts/dur convert to seconds."""
    events: List[dict] = []
    meta = {"files": [], "run_ids": set(), "dropped_spans": 0}
    for path in paths:
        with open(path) as f:
            trace = json.load(f)
        other = trace.get("otherData") or {}
        if other.get("run_id"):
            meta["run_ids"].add(other["run_id"])
        meta["dropped_spans"] += int(other.get("dropped_spans") or 0)
        meta["files"].append(path)
        for ev in trace.get("traceEvents", []):
            if ev.get("ph") != "X":
                continue
            try:
                events.append({
                    "name": str(ev["name"]),
                    "cat": str(ev.get("cat", "span")),
                    "ts": float(ev["ts"]) / 1e6,
                    "dur": float(ev["dur"]) / 1e6,
                    "pid": int(ev["pid"]),
                    "tid": int(ev["tid"]),
                    "args": ev.get("args") or {},
                })
            except (KeyError, TypeError, ValueError):
                continue
    meta["run_ids"] = sorted(meta["run_ids"])
    events.sort(key=lambda e: e["ts"])
    return events, meta


def self_times(events: List[dict]) -> List[Tuple[dict, float]]:
    """Per-event self time (duration minus direct children) for events of
    ONE thread, where overlap can only be nesting (context managers).
    The self times of all events sum exactly to the union of their
    intervals — the invariant behind the 100%-accounting table."""
    evs = sorted(events, key=lambda e: (e["ts"], -e["dur"]))
    stack: List[dict] = []
    out: List[dict] = []
    for e in evs:
        end = e["ts"] + e["dur"]
        while stack and e["ts"] >= stack[-1]["end"]:
            stack.pop()
        if stack:
            stack[-1]["child"] += e["dur"]
        rec = {"end": end, "child": 0.0, "ev": e, "dur": e["dur"]}
        stack.append(rec)
        out.append(rec)
    return [
        (r["ev"], max(r["dur"] - r["child"], 0.0)) for r in out
    ]


# ----------------------------------------------------------- train section


def train_breakdown(events: List[dict], pid: int) -> Optional[dict]:
    """The per-step attribution table for one process: self-time shares
    of the loop wall clock over the main thread's ``step``-cat spans."""
    step_evs = [
        e for e in events if e["pid"] == pid and e["cat"] == TRAIN_CAT
    ]
    if not step_evs:
        return None
    # The loop runs on one thread; pick the tid carrying the most
    # step-cat spans (robust to a stray step-cat span elsewhere).
    by_tid = collections.Counter(e["tid"] for e in step_evs)
    tid = by_tid.most_common(1)[0][0]
    step_evs = [e for e in step_evs if e["tid"] == tid]
    wall_t0 = min(e["ts"] for e in step_evs)
    wall_t1 = max(e["ts"] + e["dur"] for e in step_evs)
    wall = wall_t1 - wall_t0

    phases: Dict[str, dict] = {}
    attributed = 0.0
    for ev, self_s in self_times(step_evs):
        p = phases.setdefault(
            ev["name"], {"count": 0, "total_s": 0.0, "self_s": 0.0}
        )
        p["count"] += 1
        p["total_s"] += ev["dur"]
        p["self_s"] += self_s
        attributed += self_s
    # Steps executed: step_dispatch spans carry n (chunked dispatch runs
    # k steps per span); absent attr = 1 step.
    n_steps = sum(
        int(e["args"].get("n", 1))
        for e in step_evs if e["name"] == "step_dispatch"
    )
    unattributed = max(wall - attributed, 0.0)
    for p in phases.values():
        p["share"] = p["self_s"] / wall if wall > 0 else 0.0
    detail = collections.defaultdict(lambda: {"count": 0, "total_s": 0.0})
    for e in events:
        if e["pid"] == pid and e["cat"] == "detail":
            d = detail[e["name"]]
            d["count"] += 1
            d["total_s"] += e["dur"]
    return {
        "pid": pid,
        "tid": tid,
        "wall_s": wall,
        "n_steps": n_steps,
        "phases": {
            k: {**v, "total_s": round(v["total_s"], 6),
                "self_s": round(v["self_s"], 6),
                "share": round(v["share"], 6)}
            for k, v in sorted(
                phases.items(), key=lambda kv: -kv[1]["self_s"]
            )
        },
        "unattributed_s": round(unattributed, 6),
        "unattributed_share": round(
            unattributed / wall if wall > 0 else 0.0, 6
        ),
    }


def category_summary(events: List[dict], pid: int, cat: str) -> dict:
    """Count/total/percentile summary per span name for one category."""
    out: Dict[str, dict] = {}
    groups = collections.defaultdict(list)
    for e in events:
        if e["pid"] == pid and e["cat"] == cat:
            groups[e["name"]].append(e["dur"] * 1e3)
    for name, durs in sorted(groups.items()):
        out[name] = {
            "count": len(durs),
            "total_s": round(sum(durs) / 1e3, 6),
            **{k: round(v, 3) for k, v in percentile_summary(
                durs, (50.0, 99.0), prefix="ms_p"
            ).items()},
        }
    return out


# --------------------------------------------------------- serving section


def serve_breakdown(events: List[dict], pid: int) -> Optional[dict]:
    """Per-bucket serving phase decomposition from ``serve``-cat spans."""
    serve_evs = [
        e for e in events if e["pid"] == pid and e["cat"] == "serve"
    ]
    if not serve_evs:
        return None
    per_bucket: Dict[int, dict] = {}
    unbucketed = collections.defaultdict(list)
    for e in serve_evs:
        bucket = e["args"].get("bucket")
        if bucket is None:
            unbucketed[e["name"]].append(e["dur"] * 1e3)
            continue
        b = per_bucket.setdefault(int(bucket), collections.defaultdict(list))
        b[e["name"]].append(e["dur"] * 1e3)
    out = {"buckets": {}, "global": {}}
    for bucket in sorted(per_bucket):
        out["buckets"][bucket] = {
            name: {
                "count": len(durs),
                **{k: round(v, 3) for k, v in percentile_summary(
                    durs, (50.0, 99.0), prefix="ms_p"
                ).items()},
            }
            for name, durs in sorted(per_bucket[bucket].items())
        }
    for name, durs in sorted(unbucketed.items()):
        out["global"][name] = {
            "count": len(durs),
            **{k: round(v, 3) for k, v in percentile_summary(
                durs, (50.0, 99.0), prefix="ms_p"
            ).items()},
        }
    return out


# --------------------------------------------------------- metrics merging


def load_metrics(paths: List[str]) -> dict:
    """Aggregate training/access JSONL records: counts per kind, the
    heartbeat liveness series, and per-bucket access latencies."""
    kinds = collections.Counter()
    heartbeats: List[dict] = []
    access = collections.defaultdict(lambda: collections.defaultdict(list))
    access_status = collections.Counter()
    bad_lines = 0
    for path in paths:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    bad_lines += 1
                    continue
                kind = rec.get("kind")
                kinds[kind] += 1
                if kind == "heartbeat":
                    heartbeats.append(rec)
                elif kind == "access":
                    access_status[rec.get("status", "?")] += 1
                    bucket = rec.get("bucket")
                    if bucket is not None:
                        for f_ in ("queue_ms", "device_ms", "e2e_ms"):
                            if f_ in rec:
                                access[int(bucket)][f_].append(
                                    float(rec[f_])
                                )
    out: dict = {"record_kinds": dict(kinds), "bad_lines": bad_lines}
    if heartbeats:
        rates = [h["steps_per_s"] for h in heartbeats if "steps_per_s" in h]
        rss = [h["rss_mb"] for h in heartbeats if "rss_mb" in h]
        out["heartbeat"] = {
            "count": len(heartbeats),
            **({"steps_per_s_last": rates[-1],
                "steps_per_s_min": min(rates)} if rates else {}),
            **({"rss_mb_max": max(rss)} if rss else {}),
        }
    if access:
        out["access_status"] = dict(access_status)
        out["access_by_bucket"] = {
            bucket: {
                field: {
                    "count": len(vals),
                    **{k: round(v, 3) for k, v in percentile_summary(
                        vals, (50.0, 99.0), prefix="p"
                    ).items()},
                }
                for field, vals in sorted(fields.items())
            }
            for bucket, fields in sorted(access.items())
        }
    return out


# ----------------------------------------------------------------- output


def _fmt_table(rows: List[List[str]], header: List[str]) -> str:
    widths = [
        max(len(str(r[i])) for r in [header] + rows)
        for i in range(len(header))
    ]
    def line(cells):
        return "  ".join(str(c).ljust(w) for c, w in zip(cells, widths))
    sep = "  ".join("-" * w for w in widths)
    return "\n".join([line(header), sep] + [line(r) for r in rows])


def print_train(b: dict) -> None:
    print(f"\n== train attribution (pid {b['pid']}, tid {b['tid']}) ==")
    print(
        f"loop wall {b['wall_s']:.3f} s over {b['n_steps']} steps "
        f"({1e3 * b['wall_s'] / max(b['n_steps'], 1):.2f} ms/step)"
    )
    rows = []
    for name, p in b["phases"].items():
        rows.append([
            name, p["count"], f"{p['self_s']:.3f}",
            f"{1e3 * p['self_s'] / max(b['n_steps'], 1):.3f}",
            f"{100 * p['share']:.1f}%",
        ])
    rows.append([
        "unattributed", "-", f"{b['unattributed_s']:.3f}",
        f"{1e3 * b['unattributed_s'] / max(b['n_steps'], 1):.3f}",
        f"{100 * b['unattributed_share']:.1f}%",
    ])
    total_share = 100 * (
        sum(p["share"] for p in b["phases"].values())
        + b["unattributed_share"]
    )
    rows.append(["TOTAL", "-", f"{b['wall_s']:.3f}", "-",
                 f"{total_share:.1f}%"])
    print(_fmt_table(
        rows, ["phase", "count", "self_s", "ms/step", "share"]
    ))


def print_category(title: str, summary: dict) -> None:
    if not summary:
        return
    print(f"\n== {title} ==")
    rows = [
        [name, s["count"], f"{s['total_s']:.3f}",
         s.get("ms_p50", "-"), s.get("ms_p99", "-")]
        for name, s in summary.items()
    ]
    print(_fmt_table(rows, ["span", "count", "total_s", "p50_ms", "p99_ms"]))


def print_serve(b: dict) -> None:
    print("\n== serving decomposition ==")
    for bucket, phases in b["buckets"].items():
        print(f"bucket {bucket}:")
        rows = [
            [name, s["count"], s.get("ms_p50", "-"), s.get("ms_p99", "-")]
            for name, s in phases.items()
        ]
        print(_fmt_table(rows, ["phase", "count", "p50_ms", "p99_ms"]))
    if b["global"]:
        print("unbucketed (admission/plan):")
        rows = [
            [name, s["count"], s.get("ms_p50", "-"), s.get("ms_p99", "-")]
            for name, s in b["global"].items()
        ]
        print(_fmt_table(rows, ["phase", "count", "p50_ms", "p99_ms"]))


def build_report(trace_paths: List[str],
                 metrics_paths: List[str]) -> dict:
    events, meta = load_traces(trace_paths)
    pids = sorted({e["pid"] for e in events})
    report: dict = {
        "kind": "obs_report",
        "files": meta["files"],
        "run_ids": meta["run_ids"],
        "dropped_spans": meta["dropped_spans"],
        "events": len(events),
        "processes": {},
    }
    for pid in pids:
        proc: dict = {}
        tb = train_breakdown(events, pid)
        if tb is not None:
            proc["train"] = tb
        for cat, key in (("detail", "detail"), ("eval", "eval"),
                         ("ckpt", "ckpt"), ("data", "data"),
                         ("shard", "shard"), ("fleet", "fleet")):
            s = category_summary(events, pid, cat)
            if s:
                proc[key] = s
        sb = serve_breakdown(events, pid)
        if sb is not None:
            proc["serve"] = sb
        report["processes"][str(pid)] = proc
    if metrics_paths:
        report["metrics"] = load_metrics(metrics_paths)
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="offline span-trace attribution report"
    )
    ap.add_argument("traces", nargs="+",
                    help="Chrome trace-event JSON files (--obs_trace "
                         "exports and/or flight-recorder spans-*.json)")
    ap.add_argument("--metrics", action="append", default=[],
                    help="training metrics / access-log JSONL file "
                         "(repeatable)")
    ap.add_argument("--json", dest="json_out", default=None,
                    help="also write the machine-readable summary JSON "
                         "here (diffable across runs)")
    args = ap.parse_args(argv)

    report = build_report(args.traces, args.metrics)
    if not report["events"]:
        print("obs_report: no complete span events in the given traces",
              file=sys.stderr)
        return 2

    print(
        f"obs_report: {report['events']} spans from "
        f"{len(report['files'])} file(s), run_ids={report['run_ids']}"
        + (f", DROPPED {report['dropped_spans']} spans (ring wrap)"
           if report["dropped_spans"] else "")
    )
    for pid, proc in report["processes"].items():
        if "train" in proc:
            print_train(proc["train"])
        for key, title in (("detail", "boundary detail spans"),
                           ("eval", "eval pipeline"),
                           ("ckpt", "checkpoint pipeline"),
                           ("data", "prefetch producer"),
                           ("shard", "sharding plan (place/gather/"
                                     "restore)"),
                           ("fleet", "fleet (reload/canary/swap)")):
            if key in proc:
                print_category(f"{title} (pid {pid})", proc[key])
        if "serve" in proc:
            print_serve(proc["serve"])
    m = report.get("metrics")
    if m:
        print("\n== metrics JSONL ==")
        print(json.dumps(m, indent=2))
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(report, f, indent=2, sort_keys=True)
        print(f"\nsummary JSON -> {args.json_out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
