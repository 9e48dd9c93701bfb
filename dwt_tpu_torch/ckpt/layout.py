"""The checkpoint formats' on-disk layout, read without torch: manifests, validity, the newest valid step, delta chains and blob GC.

Everything here is the standard library: the sweep supervisor
(``dwt_tpu_torch.sweep``) and the checkpoint auditor
(``tools/torch_ckpt_fsck.py``) read it and must hold no CUDA context, as
the fleet's balancer holds none.  ``dwt_tpu_torch.utils.checkpoint`` and
``dwt_tpu_torch.ckpt.store`` re-export every name under its old home; the
save and restore paths, which need torch, stay there.

* **manifests** — ``<step>/manifest.json`` per finalized step; a save
  stages under ``.tmp-<...>`` and is renamed into place.  A full
  (``torch_full``) step lists its files and sizes; a ``cas_delta`` step
  lists leaves by digest and chains to ``parent_step`` back to a full
  manifest.
* **validity** (:func:`checkpoint_invalid_reason`) — the one authority
  the restore walk, the fleet's watcher, the sweep and the auditor share:
  files at their listed sizes, a delta chain that resolves to its full
  base with every blob present at its size.
* **GC** (:func:`gc_blobs`) — sweeps blobs that no manifest under the
  given roots references, sparing blobs younger than ``GC_MIN_AGE_S``.
"""

from __future__ import annotations

import json
import logging
import os
import time
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Tuple

log = logging.getLogger(__name__)

MANIFEST = "manifest.json"
STATE_FILE = "state.pt"
TORCH_FORMAT = "torch_full"
HOST_SHARD_FORMAT = "host_shards"
CAS_FORMAT = "cas_delta"
_TMP_PREFIX = ".tmp-"
# Anchor checkpoints (--anchor_every) live in a subdirectory that nothing
# prunes, so the distance back to a valid step stays bounded by the
# anchor cadence even when every main-directory checkpoint is torn.
ANCHOR_SUBDIR = "anchors"

BLOBS_DIR = "blobs"
# A blob younger than this is never swept, referenced or not: it may belong
# to a save whose manifest has not finalized yet, or have just been reused.
GC_MIN_AGE_S = 3600.0
# Ceiling on chain walks: a corrupted parent_step cycle ends as invalid.
_CHAIN_HARD_CAP = 512


def _root(ckpt_dir: str) -> str:
    return os.path.abspath(os.path.expanduser(ckpt_dir))


def _read_manifest(path: str) -> Optional[dict]:
    try:
        with open(os.path.join(path, MANIFEST)) as f:
            manifest = json.load(f)
    except (OSError, ValueError):
        return None
    return manifest if isinstance(manifest, dict) else None


def _blob_path(store_root: str, digest: str) -> str:
    return os.path.join(store_root, digest[:2], digest + ".bin")


# ------------------------------------------------------- chain resolution


@dataclass
class ResolvedChain:
    """One candidate's fully resolved leaf table."""

    manifest: dict                        # the newest (candidate) manifest
    entries: Dict[str, Tuple[dict, str]]  # key path -> (entry, store)
    chain_dirs: List[str]                 # candidate-first manifest dirs


def resolve_leaves(step_dir: str, manifest: Optional[dict] = None) -> ResolvedChain:
    """Resolve ``step_dir``'s leaf table through its parent chain (sibling
    step directories; a ``.tmp-cas-*`` stage resolves as a promoted one).
    Raises ``ValueError`` naming the first broken link.  Blob existence is
    :func:`cas_invalid_reason`'s second phase."""
    entries: Dict[str, Tuple[dict, str]] = {}
    chain_dirs: List[str] = []
    cur_dir = os.path.abspath(step_dir)
    cur = manifest if manifest is not None else _read_manifest(cur_dir)
    newest = cur
    hops = 0
    while True:
        if cur is None:
            raise ValueError(f"unreadable manifest at {cur_dir}"
                             + (" (torn/pruned parent of the chain)" if hops else ""))
        if cur.get("format") != CAS_FORMAT:
            raise ValueError(f"{cur_dir} is not a {CAS_FORMAT} checkpoint — a delta "
                             "cannot chain onto a whole-tree-format parent")
        store = os.path.normpath(os.path.join(cur_dir, cur.get("blob_root", "../" + BLOBS_DIR)))
        for entry in cur.get("leaves", []):
            entries.setdefault(entry["path"], (entry, store))
        chain_dirs.append(cur_dir)
        parent = cur.get("parent_step")
        if cur.get("mode") == "full":
            break
        if parent is None:
            raise ValueError(f"delta manifest at {cur_dir} has no parent_step")
        if int(parent) >= int(cur.get("step", -1)):
            raise ValueError(f"manifest at {cur_dir} chains to parent step {parent} "
                             ">= its own step (cycle)")
        hops += 1
        if hops > _CHAIN_HARD_CAP:
            raise ValueError(f"delta chain under {step_dir} exceeds {_CHAIN_HARD_CAP} links")
        cur_dir = os.path.join(os.path.dirname(cur_dir), str(int(parent)))
        cur = _read_manifest(cur_dir)
    want = newest.get("leaf_count")
    if want is not None and len(entries) != int(want):
        raise ValueError(f"chain under {step_dir} resolves {len(entries)} leaves; the "
                         f"manifest expects {want} (incomplete/mismatched chain)")
    return ResolvedChain(manifest=newest, entries=entries, chain_dirs=chain_dirs)


def _blobs_invalid_reason(resolved: ResolvedChain) -> Optional[str]:
    for path, (entry, store) in resolved.entries.items():
        blob = _blob_path(store, entry["digest"])
        try:
            size = os.path.getsize(blob)
        except OSError:
            return (f"missing blob {entry['digest'][:12]}… for leaf {path} "
                    "(torn or swept parent blob)")
        if size != int(entry["nbytes"]):
            return (f"truncated blob {entry['digest'][:12]}… for leaf {path} "
                    f"({size} bytes on disk, manifest says {entry['nbytes']})")
    return None


def cas_invalid_reason(step_dir: str, manifest: Optional[dict] = None) -> Optional[str]:
    """None when ``step_dir`` is a restorable cas checkpoint (chain and
    every blob at its size), else a one-line reason."""
    try:
        resolved = resolve_leaves(step_dir, manifest)
    except ValueError as e:
        return str(e)
    return _blobs_invalid_reason(resolved)


# ----------------------------------------------------------------- validity


def checkpoint_invalid_reason(path: str) -> Optional[str]:
    """None when ``path`` is a finalized checkpoint whose manifest checks
    out (a cas chain: every link and blob), else a one-line reason.
    Unfinalized ``.tmp-`` directories are never valid.  A directory
    without a manifest is a legacy Orbax artifact of the JAX package:
    valid here, refused by the readers."""
    if not os.path.isdir(path):
        return "not a directory"
    if os.path.basename(path).startswith(_TMP_PREFIX):
        return "unfinalized tmp directory"
    if not os.path.exists(os.path.join(path, MANIFEST)):
        return None
    manifest = _read_manifest(path)
    if manifest is None:
        return "unreadable manifest"
    if manifest.get("format") == CAS_FORMAT:
        return cas_invalid_reason(path, manifest)
    for rel, size in manifest.get("files", {}).items():
        full = os.path.join(path, rel)
        if not os.path.exists(full):
            return f"manifest-listed file {rel} missing"
        if os.path.getsize(full) != size:
            return (f"manifest-listed file {rel} truncated "
                    f"({os.path.getsize(full)} bytes, manifest says {size})")
    return None


def is_valid_checkpoint(path: str) -> bool:
    """A finalized checkpoint whose manifest checks out."""
    return checkpoint_invalid_reason(path) is None


def valid_steps(ckpt_dir: str) -> List[int]:
    """Ascending steps of the valid checkpoints under ``ckpt_dir``; each
    invalid candidate is logged with its reason."""
    root = _root(ckpt_dir)
    if not os.path.isdir(root):
        return []
    out = []
    for d in os.listdir(root):
        if not d.isdigit():
            continue
        reason = checkpoint_invalid_reason(os.path.join(root, d))
        if reason is None:
            out.append(int(d))
        else:
            log.warning("skipping checkpoint candidate %s: %s",
                        os.path.join(root, d), reason)
    return sorted(out)


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = valid_steps(ckpt_dir)
    return steps[-1] if steps else None


# -------------------------------------------------------------------- GC


def _iter_manifest_dirs(root: str) -> Iterable[str]:
    """Every directory under ``root`` (depth <= 2) holding a manifest: main
    steps, ``.tmp-*`` stages, ``anchors/`` and ``best_gr_*/`` steps."""
    try:
        names = os.listdir(root)
    except OSError:
        return
    for name in names:
        p = os.path.join(root, name)
        if name == BLOBS_DIR or not os.path.isdir(p):
            continue
        if os.path.exists(os.path.join(p, MANIFEST)):
            yield p
            continue
        try:
            subnames = os.listdir(p)
        except OSError:
            continue
        for sub in subnames:
            q = os.path.join(p, sub)
            if os.path.isdir(q) and os.path.exists(os.path.join(q, MANIFEST)):
                yield q


def gc_blobs(store_root: str, min_age_s: float = GC_MIN_AGE_S,
             manifest_roots: Optional[List[str]] = None) -> Tuple[int, int]:
    """Sweep blobs referenced by no cas manifest under the store's parent
    (or under every one of ``manifest_roots``); returns ``(files, bytes)``
    swept.  Blobs younger than ``min_age_s`` stay.  With no manifest at
    all it sweeps nothing (a store sited away from its manifests)."""
    store = os.path.abspath(store_root)
    roots = ([os.path.abspath(os.path.expanduser(r)) for r in manifest_roots]
             if manifest_roots is not None else [os.path.dirname(store)])
    referenced = set()
    for root in roots:
        for d in _iter_manifest_dirs(root):
            manifest = _read_manifest(d)
            if manifest is None or manifest.get("format") != CAS_FORMAT:
                continue
            referenced.update(e["digest"] for e in manifest.get("leaves", []))
    if not referenced:
        log.warning("blob GC skipped: no cas manifests found under %s", ", ".join(roots))
        return 0, 0
    swept = swept_bytes = 0
    now = time.time()
    try:
        shards = os.listdir(store)
    except OSError:
        return 0, 0
    for shard in shards:
        sdir = os.path.join(store, shard)
        if not os.path.isdir(sdir):
            continue
        for name in os.listdir(sdir):
            if name.endswith(".bin") and name[:-4] in referenced:
                continue
            blob = os.path.join(sdir, name)
            try:
                st = os.stat(blob)
                if now - st.st_mtime < min_age_s:
                    continue
                os.remove(blob)
                swept += 1
                swept_bytes += st.st_size
            except OSError:
                continue
        try:
            os.rmdir(sdir)  # an empty fan-out directory
        except OSError:
            pass
    if swept:
        log.info("checkpoint blob GC: swept %d unreferenced blobs (%d bytes) under %s",
                 swept, swept_bytes, store)
    return swept, swept_bytes
