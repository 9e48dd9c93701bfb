#!/usr/bin/env python
"""Offline checkpoint-tree auditor of the PyTorch/CUDA port's checkpoints — the counterpart of ``tools/ckpt_fsck.py``.

Read-only walk over a ``--ckpt_dir`` tree — main steps, ``anchors/``,
``best_*/`` — reporting, per candidate:

* validity (``checkpoint_invalid_reason`` — the SAME authority the
  ranked restore walk uses, so "fsck says torn" == "resume will skip");
* on-disk format, and for ``cas_delta`` manifests the resolved chain
  depth (manifests a restore must read) and chain base;
* whether a ``data_state`` (exact mid-epoch resume cursor) is recorded;

plus store-level accounting for the content-addressed blob store:

* **missing** blobs — referenced by some manifest but absent/truncated
  (each shows up as an invalid candidate too);
* **orphaned** blobs — referenced by NO manifest (a crashed stage, a
  GC that hasn't run): their total bytes are the tree's reclaimable
  space (``gc_blobs`` would sweep them once aged);
* in-flight ``.tmp-*`` stages (informational — invisible to restore).

**Multi-run mode** (``--store``): audit a SHARED blob store against N
run trees at once — the sweep layout, where every pair's checkpoints
refcount into one CAS store and no single run dir can account for it.
References are unioned across all runs (exactly the view
``gc_blobs(..., manifest_roots=...)`` sweeps against), so "orphaned"
means referenced by NO run — per-run accounting would misreport a
sibling's blobs as garbage.  The report carries a per-run section
(candidates, torn count, referenced blobs) plus the store totals.

Exit codes: 0 = every kept/anchor/best candidate is restorable;
1 = at least one candidate is torn (its reason printed); 2 = unusable
input (no such directory).  ``--json`` emits one machine-readable
record instead of the table.

It reads the port's formats (``torch_full`` steps, ``cas_delta`` chains)
and the JAX package's ``cas_delta`` chains through the port's own
validity authority (``dwt_tpu_torch.ckpt.layout``, which
``dwt_tpu_torch.utils.checkpoint`` re-exports): the standard library only,
no torch and no JAX, so it runs beside a live sweep without a CUDA
context.  The report's keys and the exit codes are ``tools/ckpt_fsck.py``'s.

Usage::

    python tools/torch_ckpt_fsck.py /path/to/ckpt_dir
    python tools/torch_ckpt_fsck.py /path/to/ckpt_dir --json
    python tools/torch_ckpt_fsck.py --store /sweep/blobs /sweep/*/ckpt/*
"""

from __future__ import annotations

import argparse
import json
import os
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO not in sys.path:  # runnable as a script from anywhere
    sys.path.insert(0, _REPO)

from dwt_tpu_torch.ckpt.layout import (  # noqa: E402
    ANCHOR_SUBDIR,
    BLOBS_DIR,
    CAS_FORMAT,
    _TMP_PREFIX,
    _blob_path,
    _read_manifest,
    checkpoint_invalid_reason,
    resolve_leaves,
)


def _candidate_dirs(root: str):
    """``(label, step_dir)`` for every step candidate under the tree:
    main-dir digits, anchors/, and best_*/ one level down."""
    for name in sorted(os.listdir(root)):
        path = os.path.join(root, name)
        if name.isdigit() and os.path.isdir(path):
            yield "main", path
        elif name == ANCHOR_SUBDIR and os.path.isdir(path):
            for sub in sorted(os.listdir(path)):
                if sub.isdigit():
                    yield "anchor", os.path.join(path, sub)
        elif name.startswith("best") and os.path.isdir(path):
            for sub in sorted(os.listdir(path)):
                if sub.isdigit():
                    yield name, os.path.join(path, sub)


def _chain_info(step_dir: str, manifest: dict):
    """(depth, base_step, resolved) for a cas candidate — ONE chain
    resolution shared with the caller's blob accounting; (None, None,
    None) if broken (the validity column already carries the reason)."""
    try:
        resolved = resolve_leaves(step_dir, manifest)
    except ValueError:
        return None, None, None
    base = _read_manifest(resolved.chain_dirs[-1]) or {}
    return len(resolved.chain_dirs) - 1, base.get("step"), resolved


def _walk_tree(root: str, referenced: dict):
    """Audit one checkpoint tree: returns ``(candidates, tmp_stages)``
    and accumulates blob references into ``referenced``
    (digest -> (nbytes, store_root)) — shared by the single-dir audit
    and the multi-run union."""
    candidates = []
    for label, step_dir in _candidate_dirs(root):
        reason = checkpoint_invalid_reason(step_dir)
        manifest = _read_manifest(step_dir) or {}
        fmt = manifest.get("format", "orbax" if manifest else "legacy")
        rec = {
            "kind": label,
            "step": int(os.path.basename(step_dir)),
            "path": os.path.relpath(step_dir, root),
            "format": fmt,
            "valid": reason is None,
            "reason": reason,
            "data_state": manifest.get("data_state") is not None,
        }
        if fmt == CAS_FORMAT:
            depth, base, resolved = _chain_info(step_dir, manifest)
            rec["chain_depth"] = depth
            rec["chain_base_step"] = base
            if resolved is not None:
                for entry, store in resolved.entries.values():
                    referenced.setdefault(
                        entry["digest"],
                        (int(entry["nbytes"]), store),
                    )
        candidates.append(rec)
    # In-flight stages also pin blobs (a staged-but-unpromoted save's
    # fresh blobs are NOT orphans — gc_blobs counts them too).
    tmp_stages = []
    for name in sorted(os.listdir(root)) if os.path.isdir(root) else []:
        if not name.startswith(_TMP_PREFIX):
            continue
        tmp_stages.append(name)
        manifest = _read_manifest(os.path.join(root, name))
        if manifest and manifest.get("format") == CAS_FORMAT:
            try:
                resolved = resolve_leaves(os.path.join(root, name), manifest)
                for entry, store in resolved.entries.values():
                    referenced.setdefault(
                        entry["digest"], (int(entry["nbytes"]), store)
                    )
            except ValueError:
                pass
    return candidates, tmp_stages


def _scan_store(store: str) -> dict:
    """digest -> size for every blob physically in the store."""
    on_disk = {}
    if os.path.isdir(store):
        for shard in os.listdir(store):
            sdir = os.path.join(store, shard)
            if not os.path.isdir(sdir):
                continue
            for name in os.listdir(sdir):
                if name.endswith(".bin"):
                    try:
                        on_disk[name[:-4]] = os.path.getsize(
                            os.path.join(sdir, name)
                        )
                    except OSError:
                        continue
    return on_disk


def _store_accounting(store: str, referenced: dict) -> dict:
    """missing/orphaned/reclaimable totals for ``store`` against the
    given reference union.  References into OTHER stores are excluded —
    a tree whose manifests point at a different store (mixed layouts)
    must not spray phantom 'missing' blobs here."""
    store = os.path.abspath(store)
    on_disk = _scan_store(store)

    def _absent_or_truncated(digest, nbytes, st):
        try:
            return os.path.getsize(_blob_path(st, digest)) != int(nbytes)
        except OSError:
            return True

    here = {
        d: (nbytes, st) for d, (nbytes, st) in referenced.items()
        if os.path.abspath(st) == store
    }
    missing = sorted(
        d for d, (nbytes, st) in here.items()
        if _absent_or_truncated(d, nbytes, st)
    )
    orphaned = sorted(set(on_disk) - set(referenced))
    return {
        "blobs_on_disk": len(on_disk),
        "store_bytes": int(sum(on_disk.values())),
        "blobs_referenced": len(here),
        "blobs_missing": len(missing),
        "missing_digests": missing[:16],
        "blobs_orphaned": len(orphaned),
        "reclaimable_bytes": int(sum(on_disk[d] for d in orphaned)),
    }


def audit(ckpt_dir: str) -> dict:
    """The full single-tree read-only audit record (see module doc)."""
    root = os.path.abspath(os.path.expanduser(ckpt_dir))
    referenced = {}  # digest -> (nbytes, store_root)
    candidates, tmp_stages = _walk_tree(root, referenced)
    report = {
        "kind": "ckpt_fsck",
        "ckpt_dir": root,
        "candidates": candidates,
        "valid_candidates": sum(1 for c in candidates if c["valid"]),
        "torn_candidates": sum(1 for c in candidates if not c["valid"]),
        "tmp_stages": tmp_stages,
    }
    report.update(_store_accounting(os.path.join(root, BLOBS_DIR),
                                    referenced))
    return report


def audit_store(store: str, run_dirs: list) -> dict:
    """Multi-run audit: one shared store, N checkpoint trees (module
    doc).  The reference union across ALL trees is what decides
    orphaned/reclaimable — the same view cross-run GC uses."""
    store = os.path.abspath(os.path.expanduser(store))
    referenced = {}
    runs = []
    for run_dir in run_dirs:
        root = os.path.abspath(os.path.expanduser(run_dir))
        before = len(referenced)
        candidates, tmp_stages = _walk_tree(root, referenced)
        runs.append({
            "ckpt_dir": root,
            "candidates": candidates,
            "valid_candidates": sum(1 for c in candidates if c["valid"]),
            "torn_candidates": sum(
                1 for c in candidates if not c["valid"]
            ),
            "tmp_stages": tmp_stages,
            # Blobs THIS run introduced to the union — with heavy
            # cross-run dedup (frozen backbones) later runs add few.
            "new_blobs_referenced": len(referenced) - before,
        })
    report = {
        "kind": "ckpt_fsck_store",
        "store": store,
        "runs": runs,
        "valid_candidates": sum(r["valid_candidates"] for r in runs),
        "torn_candidates": sum(r["torn_candidates"] for r in runs),
    }
    report.update(_store_accounting(store, referenced))
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="read-only checkpoint-tree auditor (exit 1 on any "
                    "torn kept/anchor/best candidate)"
    )
    ap.add_argument("ckpt_dir", nargs="+",
                    help="checkpoint tree(s) to audit (several only "
                         "with --store)")
    ap.add_argument("--store", type=str, default=None,
                    help="shared blob store: audit it against the UNION "
                         "of references across every ckpt_dir (the "
                         "sweep layout)")
    ap.add_argument("--json", action="store_true",
                    help="one machine-readable JSON record instead of "
                         "the table")
    args = ap.parse_args(argv)
    if len(args.ckpt_dir) > 1 and not args.store:
        print("torch_ckpt_fsck: multiple ckpt_dirs require --store (whose "
              "store would the union audit?)", file=sys.stderr)
        return 2
    for d in args.ckpt_dir:
        if not os.path.isdir(d):
            print(f"torch_ckpt_fsck: {d}: not a directory", file=sys.stderr)
            return 2
    if args.store and not os.path.isdir(args.store):
        print(f"torch_ckpt_fsck: --store {args.store}: not a directory",
              file=sys.stderr)
        return 2

    def _print_candidates(candidates, tmp_stages, indent="  "):
        for c in candidates:
            chain = (
                f" chain_depth={c['chain_depth']}"
                f" base={c['chain_base_step']}"
                if c.get("chain_depth") is not None else ""
            )
            status = "ok" if c["valid"] else f"TORN ({c['reason']})"
            ds = "+data_state" if c["data_state"] else "-data_state"
            print(f"{indent}[{c['kind']:>7}] step {c['step']:>8} "
                  f"{c['format']:<12} {ds}{chain}  {status}")
        if tmp_stages:
            print(f"{indent}in-flight stages: {', '.join(tmp_stages)}")

    def _print_store_line(report, indent="  "):
        print(
            f"{indent}blobs: {report['blobs_on_disk']} on disk "
            f"({report['store_bytes']} bytes), "
            f"{report['blobs_referenced']} referenced, "
            f"{report['blobs_missing']} missing, "
            f"{report['blobs_orphaned']} orphaned "
            f"({report['reclaimable_bytes']} reclaimable bytes)"
        )

    if args.store:
        report = audit_store(args.store, args.ckpt_dir)
        if args.json:
            print(json.dumps(report))
        else:
            print(f"torch_ckpt_fsck: shared store {report['store']} against "
                  f"{len(report['runs'])} run(s)")
            for r in report["runs"]:
                print(f"  run {r['ckpt_dir']}: "
                      f"{r['valid_candidates']} valid, "
                      f"{r['torn_candidates']} torn, "
                      f"+{r['new_blobs_referenced']} new blob ref(s)")
                _print_candidates(r["candidates"], r["tmp_stages"],
                                  indent="    ")
            _print_store_line(report)
            verdict = (
                "clean" if report["torn_candidates"] == 0
                else f"{report['torn_candidates']} torn candidate(s)"
            )
            print(f"  verdict: {verdict}")
        return 0 if report["torn_candidates"] == 0 else 1

    report = audit(args.ckpt_dir[0])
    if args.json:
        print(json.dumps(report))
    else:
        print(f"torch_ckpt_fsck: {report['ckpt_dir']}")
        _print_candidates(report["candidates"], report["tmp_stages"])
        _print_store_line(report)
        verdict = (
            "clean" if report["torn_candidates"] == 0
            else f"{report['torn_candidates']} torn candidate(s)"
        )
        print(f"  verdict: {verdict}")
    return 0 if report["torn_candidates"] == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
