"""OfficeHome full 12-pair sweep (paper Table 3) — the port of ``dwt_tpu.cli.officehome_sweep``.

The reference has no sweep entry point (each of the 12 source→target pairs is a
separate ``resnet50_dwt_mec_officehome.py`` invocation); this CLI runs all
ordered domain pairs with the same recipe and reports the per-pair target
top-1 plus the Table-3-style mean.

Usage::

    python -m dwt_tpu_torch.cli.officehome_sweep \
        --dataset_root .../OfficeHomeDataset_10072016 \
        --resnet_path .../model_best_gr_4.pth.tar \
        --results_json sweep.json

Any OfficeHome flag applies to every pair (``--num_iters``, ``--remat``,
``--data_parallel``, ...).  ``--synthetic`` sweeps generated data — a
no-dataset smoke of the whole matrix.  Every pair trains through the port's
``officehome.run_from_args``: on the card unless ``--device cpu``.  The
sweep supervisor (``python -m dwt_tpu_torch.sweep.cli``) runs one such
invocation per pair.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os

from dwt_tpu_torch.cli import officehome as _oh


def build_parser() -> argparse.ArgumentParser:
    p = _oh.build_parser()
    p.description = "DWT-MEC OfficeHome 12-pair sweep (PyTorch/CUDA port)"
    p.add_argument("--dataset_root", type=str, default=None,
                   help="OfficeHomeDataset root containing the domain dirs")
    p.add_argument("--domains", type=str,
                   default="Art,Clipart,Product,RealWorld",
                   help="comma-separated domain dir names")
    p.add_argument("--pairs", type=str, default=None,
                   help='subset like "Art:Clipart,Product:Art" '
                        "(default: all ordered pairs)")
    p.add_argument("--results_json", type=str, default=None)
    p.add_argument("--expect_table", type=str, default=None,
                   help='JSON {"Source->Target": acc_or_null} of paper '
                        "Table-3 targets (see baselines/); after the sweep "
                        "a per-pair ±tolerance verdict table is produced "
                        "and the exit code reflects it")
    return p


def _pairs(args):
    domains = [d.strip() for d in args.domains.split(",") if d.strip()]
    if args.pairs:
        pairs = []
        for item in args.pairs.split(","):
            item = item.strip()
            if not item:
                continue
            if ":" not in item:
                raise SystemExit(
                    f'--pairs entries must be "Source:Target"; got {item!r}'
                )
            s, t = item.split(":", 1)
            pairs.append((s.strip(), t.strip()))
        return pairs
    return [(s, t) for s, t in itertools.permutations(domains, 2)]


def main(argv=None) -> float:
    args = build_parser().parse_args(argv)
    if not args.synthetic and not args.dataset_root:
        raise SystemExit("--dataset_root is required unless --synthetic")

    if getattr(args, "expect_accuracy", None) is not None:
        # One value cannot assert 12 different pairs; refusing beats
        # silently dropping the user's assertion.
        raise SystemExit(
            "--expect_accuracy is a single-run flag; the sweep takes "
            "per-pair targets via --expect_table (see baselines/)"
        )
    expected = None
    if args.expect_table:
        from dwt_tpu_torch.utils import load_expect_table

        expected = load_expect_table(args.expect_table)

    pairs = _pairs(args)
    if expected is not None:
        # Fail fast on typo'd table keys before hours of training: every
        # non-null expectation must correspond to a planned pair.
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
    if len(set(pairs)) != len(pairs):
        raise SystemExit(f"--pairs contains duplicates: {pairs}")
    if args.dataset_root:
        # Fail fast on typo'd domain names before any pair trains.
        missing = [
            d for pair in pairs for d in pair
            if not os.path.isdir(os.path.join(args.dataset_root, d))
        ]
        if missing:
            raise SystemExit(
                f"domain dirs not found under {args.dataset_root}: "
                f"{sorted(set(missing))}"
            )

    results = {}
    base_ckpt = args.ckpt_dir
    base_jsonl = args.metrics_jsonl

    def _payload(**extra):
        return {
            "pairs": results,
            "mean": sum(results.values()) / max(len(results), 1),
            "completed": len(results),
            "total": len(pairs),
            **extra,
        }

    def _write_results(**extra):
        # Atomic AND durable (tmp + fsync + rename): the sweep
        # supervisor treats this file as the pair's completion record —
        # an un-fsynced rename surviving a host crash as a zero-byte
        # file would erase a finished pair's result.
        tmp = args.results_json + ".tmp"
        with open(tmp, "w") as f:
            json.dump(_payload(**extra), f, indent=2)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, args.results_json)

    for source, target in pairs:
        tag = f"{source}2{target}"
        if args.dataset_root:
            args.s_dset_path = os.path.join(args.dataset_root, source)
            args.t_dset_path = os.path.join(args.dataset_root, target)
        if base_ckpt:
            args.ckpt_dir = os.path.join(base_ckpt, tag)
        if base_jsonl:
            # One metrics file per pair — records from different pairs are
            # otherwise indistinguishable (step counters restart per pair).
            root, ext = os.path.splitext(base_jsonl)
            args.metrics_jsonl = f"{root}.{tag}{ext or '.jsonl'}"
        acc = _oh.run_from_args(args)
        results[f"{source}->{target}"] = acc
        print(f"[sweep] {source}->{target}: {acc:.2f}")
        if args.results_json:
            # Written atomically after EVERY pair so a crash at any point
            # keeps all completed results.
            _write_results()

    mean = sum(results.values()) / max(len(results), 1)
    print(f"[sweep] mean over {len(results)} pairs: {mean:.2f}")

    if expected is not None:
        from dwt_tpu_torch.utils import sweep_verdicts

        summary = sweep_verdicts(results, expected, args.tolerance)
        for pair, v in summary["pairs"].items():
            if v.get("skipped"):
                print(f"[verdict] {pair}: actual={v['actual']:.2f} "
                      "(no expectation — fill baselines/ from the paper)")
            else:
                status = "OK" if v["ok"] else "FAIL"
                print(f"[verdict] {pair}: actual={v['actual']:.2f} "
                      f"expected={v['expected']:.2f} Δ={v['delta']:+.2f} "
                      f"(±{v['tolerance']}) {status}")
        print(f"[verdict] checked={summary['checked']} "
              f"skipped={summary['skipped']} all_ok={summary['all_ok']}")
        if args.results_json:
            _write_results(verdicts=summary)
        if summary["all_ok"] is False:
            raise SystemExit(1)
    return mean


if __name__ == "__main__":
    main()
