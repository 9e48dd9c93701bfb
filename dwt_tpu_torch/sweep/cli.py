"""``python -m dwt_tpu_torch.sweep.cli`` — the preemptible multi-run sweep entry point; the port of ``dwt_tpu.sweep.cli``.

One invocation drives the whole OfficeHome pair matrix as supervised
training subprocesses over bounded job slots::

    python -m dwt_tpu_torch.sweep.cli --sweep_root /runs/officehome --slots 4 \\
        --pairs Art:Clipart,Art:Product,... \\
        -- --synthetic --arch tiny --num_iters 100 ...

Everything after ``--`` is passed verbatim to each training job (the
fleet CLI's idiom); the supervisor owns the per-pair plumbing flags
(``--ckpt_dir``, ``--metrics_jsonl``, ``--results_json``,
``--preempt_notice_file``, ``--blob_store``, ``--metrics_port``), so
passing those after ``--`` is an error.

Relaunch is the same command line: the journal at
``<sweep_root>/sweep.json`` tells the new supervisor which pairs are
done, which jobs still run (adopted), and which to reschedule.  Exit
code: 0 when every pair completed (and the verdict table, if given,
passed); 1 when any pair was quarantined or a verdict failed.

Each job is ``python -m dwt_tpu_torch.cli.officehome_sweep`` for one pair;
it trains on the card unless the job flags carry ``--device cpu``.  The
supervisor itself imports no torch.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
from typing import List, Optional, Sequence

from dwt_tpu_torch.sweep.supervisor import JobSpec, SweepSupervisor

log = logging.getLogger(__name__)

# Plumbing the supervisor owns; a user value would be silently
# overridden per pair, so reject it loudly instead.
_RESERVED_JOB_FLAGS = (
    "--ckpt_dir", "--metrics_jsonl", "--results_json",
    "--preempt_notice_file", "--blob_store", "--metrics_port",
    "--pairs", "--expect_table", "--expect_accuracy",
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m dwt_tpu_torch.sweep.cli",
        description="preemptible multi-run sweep supervisor "
                    "(job args after --)",
    )
    p.add_argument("--sweep_root", type=str, required=True,
                   help="root dir: journal, per-pair run dirs, shared "
                        "blob store")
    p.add_argument("--domains", type=str,
                   default="Art,Clipart,Product,RealWorld",
                   help="comma-separated domain names")
    p.add_argument("--pairs", type=str, default=None,
                   help='subset like "Art:Clipart,Product:Art" '
                        "(default: all ordered pairs)")
    p.add_argument("--slots", type=int, default=2,
                   help="concurrent training jobs")
    p.add_argument("--job_max_respawns", type=int, default=2,
                   help="crashes per pair before quarantine "
                        "(preemption resumes are never charged)")
    p.add_argument("--job_backoff_s", type=float, default=2.0,
                   help="base crash-respawn backoff; attempt k waits "
                        "backoff * 2^(k-1)")
    p.add_argument("--poll_interval_s", type=float, default=1.0)
    p.add_argument("--job_stall_timeout_s", type=float, default=0.0,
                   help="SIGKILL a job silent (no metrics JSONL "
                        "activity) this long; 0 disables")
    p.add_argument("--blob_store", type=str, default=None,
                   help="shared CAS blob store for every run "
                        "(default <sweep_root>/blobs); 'none' gives "
                        "each run a private store")
    p.add_argument("--gc_every_polls", type=int, default=120,
                   help="cross-run shared-store GC cadence in poll "
                        "ticks; 0 = only once at sweep end")
    p.add_argument("--gc_min_age_s", type=float, default=None,
                   help="override the store's GC age guard (tests)")
    p.add_argument("--results_json", type=str, default=None,
                   help="aggregate per-pair accuracies here "
                        "(default <sweep_root>/results.json)")
    p.add_argument("--expect_table", type=str, default=None,
                   help="JSON of per-pair accuracy targets; verdicts "
                        "are evaluated over COMPLETED pairs after the "
                        "sweep")
    p.add_argument("--tolerance", type=float, default=1.0,
                   help="verdict tolerance in accuracy points")
    p.add_argument("--metrics_port", type=int, default=None,
                   help="serve the aggregated /metrics (supervisor + "
                        "every job under a pair label); 0 = ephemeral")
    p.add_argument("--alert_rules", type=str, default=None,
                   help="alert rules JSON evaluated against the "
                        "supervisor registry each poll")
    return p


def parse_pairs(domains: str, pairs: Optional[str]) -> List[tuple]:
    """The sweep CLI's own pair parsing — same grammar as
    ``officehome_sweep --pairs`` but independent of that parser (the
    supervisor must not construct a training argparser just to learn
    its matrix)."""
    names = [d.strip() for d in domains.split(",") if d.strip()]
    if pairs:
        out = []
        for item in pairs.split(","):
            item = item.strip()
            if not item:
                continue
            if ":" not in item:
                raise SystemExit(
                    f'--pairs entries must be "Source:Target"; got {item!r}'
                )
            s, t = item.split(":", 1)
            out.append((s.strip(), t.strip()))
    else:
        import itertools

        out = [(s, t) for s, t in itertools.permutations(names, 2)]
    if len(set(out)) != len(out):
        raise SystemExit(f"--pairs contains duplicates: {out}")
    if not out:
        raise SystemExit("empty pair matrix")
    return out


def make_argv_fn(job_argv: Sequence[str], blob_store: Optional[str],
                 python: str = sys.executable):
    """Build each pair's training command line: the single-pair
    ``officehome_sweep`` invocation with the supervisor-owned plumbing
    flags pointed into the pair's run dir."""

    def argv_fn(spec: JobSpec) -> List[str]:
        argv = [
            python, "-m", "dwt_tpu_torch.cli.officehome_sweep",
            "--pairs", f"{spec.source}:{spec.target}",
            "--results_json", spec.result_json,
            "--ckpt_dir", spec.ckpt_base,
            "--metrics_jsonl", spec.metrics_base,
            "--preempt_notice_file", spec.notice_file,
            "--metrics_port", "0",
        ]
        if blob_store:
            argv += ["--ckpt_format", "delta", "--blob_store", blob_store]
        return argv + list(job_argv)

    return argv_fn


def _write_aggregate(path: str, payload: dict) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.tmp-{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(payload, f, indent=2)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def main(argv: Optional[Sequence[str]] = None) -> int:
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
    )
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--" in argv:
        split = argv.index("--")
        own, job_argv = argv[:split], argv[split + 1:]
    else:
        own, job_argv = argv, []
    args = build_parser().parse_args(own)

    clash = sorted(set(_RESERVED_JOB_FLAGS) & set(job_argv))
    if clash:
        raise SystemExit(
            f"the sweep supervisor owns {clash} (set per pair); configure the sweep "
            "with its own flags before the --"
        )

    pairs = parse_pairs(args.domains, args.pairs)
    sweep_root = os.path.abspath(args.sweep_root)
    if args.blob_store and args.blob_store.lower() == "none":
        blob_store = None
    else:
        blob_store = os.path.abspath(
            args.blob_store or os.path.join(sweep_root, "blobs")
        )

    expected = None
    if args.expect_table:
        from dwt_tpu_torch.utils import load_expect_table

        expected = load_expect_table(args.expect_table)
        planned = {f"{s}->{t}" for s, t in pairs}
        unknown = sorted(
            k for k, v in expected.items()
            if v is not None and k not in planned
        )
        if unknown:
            raise SystemExit(
                f"--expect_table entries match no planned pair: {unknown} "
                f"(planned: {sorted(planned)})"
            )

    sup = SweepSupervisor(
        pairs, sweep_root, make_argv_fn(job_argv, blob_store),
        slots=args.slots,
        job_max_respawns=args.job_max_respawns,
        backoff_s=args.job_backoff_s,
        poll_interval_s=args.poll_interval_s,
        stall_timeout_s=args.job_stall_timeout_s,
        blob_store=blob_store,
        gc_every_polls=args.gc_every_polls,
        gc_min_age_s=args.gc_min_age_s,
        alert_rules=args.alert_rules,
        metrics_port=args.metrics_port,
    )
    summary = sup.run()

    for pair, acc in sorted(summary["pairs"].items()):
        print(f"[sweep] {pair}: {acc:.2f}")
    for tag, reason in sorted(summary["quarantined"].items()):
        print(f"[sweep] QUARANTINED {tag}: {reason}")
    print(f"[sweep] completed {summary['completed']}/{summary['total']} "
          f"mean={summary['mean']:.2f}")

    failed = bool(summary["quarantined"])
    if expected is not None and summary["pairs"]:
        from dwt_tpu_torch.utils import sweep_verdicts

        verdicts = sweep_verdicts(summary["pairs"], expected,
                                  args.tolerance)
        summary["verdicts"] = verdicts
        for pair, v in verdicts["pairs"].items():
            if v.get("skipped"):
                print(f"[verdict] {pair}: actual={v['actual']:.2f} "
                      "(no expectation)")
            else:
                status = "OK" if v["ok"] else "FAIL"
                print(f"[verdict] {pair}: actual={v['actual']:.2f} "
                      f"expected={v['expected']:.2f} Δ={v['delta']:+.2f} "
                      f"(±{v['tolerance']}) {status}")
        if verdicts["all_ok"] is False:
            failed = True

    results_json = args.results_json or os.path.join(
        sweep_root, "results.json"
    )
    _write_aggregate(results_json, summary)

    if summary["drained"]:
        # A drained supervisor exits 0 like a preempted job: parked in
        # good order, relaunch to continue.
        print("[sweep] drained (supervisor preempted); relaunch the same "
              "command to continue")
        return 0
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
