"""Content-addressed delta checkpoints (``format: cas_delta``) — the single-process port of ``dwt_tpu.ckpt.store``.

A full checkpoint rewrites every byte of the state at every save; this
store writes, per save, only the leaves whose content moved:

* **blob store** — ``<store>/blobs/<d[:2]>/<digest>.bin``: a leaf's raw
  C-order bytes keyed by a SHA-256 over (dtype, shape, bytes).  Writes are
  tmp + fsync + rename; a blob that exists is reused and its mtime bumped
  (the GC age guard).
* **manifests** — each step directory holds one ``manifest.json``.  A
  ``full`` manifest lists every leaf (path, dtype, shape, digest, nbytes);
  a ``delta`` manifest lists only the leaves whose digest moved since
  ``parent_step`` and resolves the rest through the chain.  Past
  ``delta_max_chain`` links the next save is full.
* **atomic finalize** — the manifest stages under ``.tmp-cas-<step>/``
  and is renamed into place only after its chain validates.
* **validation** — a candidate is valid only if its whole chain resolves
  and every referenced blob exists at its recorded size, so a torn parent
  blob makes the walk fall back past it, never to a mixed-generation
  state.
* **GC** — :func:`gc_blobs` sweeps blobs no manifest under the store's
  root references, sparing blobs younger than ``GC_MIN_AGE_S``; pruning is
  chain-aware (``utils.checkpoint.prune_checkpoints``).

The port writes the leaves of ``TrainState.state_dict()`` under their
paths (``['model']['conv1.weight']``, ``['optimizer']['state'][0]
['momentum_buffer']``), every tensor as its contiguous CPU copy — a
channels_last weight as its OIHW bytes — and the rest of the state dict
(the optimizer's param groups, the step, ``lr_scale``) in the manifest's
``torch_meta``; its ``params_digest`` is ``utils.checkpoint.
params_digest``'s.  Chains the JAX package wrote (leaves under jax tree
key paths, no ``torch_meta``) are read too, with numpy, into the
``params``/``batch_stats`` trees the weight bridge loads: a TPU run saved
with ``--ckpt_format delta`` serves on the card and initializes a trainer.

Not ported: the sharded, memory-mapped restore (``restore_cas_state`` onto
a sharding) and the multi-host stage/promote split (ROADMAP queue 1
item 8).
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import shutil
import time
from dataclasses import dataclass
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from dwt_tpu_torch.resilience import inject
from dwt_tpu_torch.utils.checkpoint import (
    CAS_FORMAT,
    MANIFEST,
    _TMP_PREFIX,
    _finalize_rename,
    _read_manifest,
    _root,
    _sweep_stale_tmp,
    _with_retries,
    host_params_finite,
    is_valid_checkpoint,
    keystr_to_path,
    params_digest,
    prune_checkpoints,
)

log = logging.getLogger(__name__)

BLOBS_DIR = "blobs"
_CAS_TMP = _TMP_PREFIX + "cas-"  # still .tmp-*: invisible to valid_steps
DEFAULT_DELTA_MAX_CHAIN = 8
# A blob younger than this is never swept, referenced or not: it may belong
# to a save whose manifest has not finalized yet, or have just been reused.
GC_MIN_AGE_S = 3600.0
# Ceiling on chain walks: a corrupted parent_step cycle ends as invalid.
_CHAIN_HARD_CAP = 512
# The manifest key that marks a chain the port wrote.
TORCH_META = "torch_meta"


def blob_store_root(ckpt_dir: str) -> str:
    """The blob store of a run's checkpoint tree: main steps, anchors and
    best_* manifests under ``ckpt_dir`` all reference it."""
    return os.path.join(_root(ckpt_dir), BLOBS_DIR)


def _count_delta_bytes(mode: str, nbytes: int) -> None:
    # Deferred: utils.checkpoint imports this module.
    from dwt_tpu_torch.utils.checkpoint import count_ckpt_bytes

    count_ckpt_bytes(mode, nbytes)


def tree_bytes(path: str) -> int:
    """Total bytes of all files under ``path`` (the ``dwt_ckpt_dir_bytes``
    gauge)."""
    total = 0
    for sub, _, names in os.walk(path):
        for name in names:
            try:
                total += os.path.getsize(os.path.join(sub, name))
            except OSError:
                continue
    return total


def _leaf_digest(dtype: np.dtype, shape: Tuple[int, ...], raw: bytes) -> str:
    h = hashlib.sha256()
    h.update(str(dtype).encode())
    h.update(repr(tuple(int(s) for s in shape)).encode())
    h.update(raw)
    return h.hexdigest()


def _blob_path(store_root: str, digest: str) -> str:
    return os.path.join(store_root, digest[:2], digest + ".bin")


def _write_blob(store_root: str, digest: str, raw: bytes) -> int:
    """Write one blob atomically; returns the bytes written (0 when it
    already exists: its mtime is bumped instead)."""
    path = _blob_path(store_root, digest)
    try:
        if os.path.getsize(path) == len(raw):
            os.utime(path)
            return 0
    except OSError:
        pass
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.tmp-{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(raw)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return len(raw)


# ------------------------------------------------------- the port's leaves


def _keystr(path: Tuple) -> str:
    return "".join(f"[{k}]" if isinstance(k, int) else f"['{k}']" for k in path)


def payload_leaves(payload: Dict[str, Any]) -> Tuple[List[Tuple[str, np.ndarray]], dict]:
    """A ``TrainState.state_dict()`` payload as ``(leaves, meta)``: every
    tensor of its model and optimizer state under its key path, as a
    contiguous numpy array, and the rest as JSON."""
    leaves = [(_keystr(("model", name)), t.numpy())
              for name, t in payload["model"].items()]
    extra: Dict[str, dict] = {}
    for i, buffers in payload["optimizer"]["state"].items():
        for name, v in buffers.items():
            if torch.is_tensor(v):
                leaves.append((_keystr(("optimizer", "state", int(i), name)), v.numpy()))
            else:
                extra.setdefault(str(i), {})[name] = v
    meta = {"param_groups": payload["optimizer"]["param_groups"],
            "state_values": extra, "step": int(payload["step"]),
            "lr_scale": float(payload.get("lr_scale", 1.0))}
    return leaves, meta


def _payload_from_leaves(arrays: Dict[str, np.ndarray], meta: dict) -> Dict[str, Any]:
    """The inverse of :func:`payload_leaves`."""
    model, state = {}, {}
    for key, arr in arrays.items():
        path = keystr_to_path(key)
        t = torch.from_numpy(arr.copy())
        if path[0] == "model":
            model[path[1]] = t
        else:
            state.setdefault(int(path[2]), {})[path[3]] = t
    for i, values in meta.get("state_values", {}).items():
        state.setdefault(int(i), {}).update(values)
    return {"model": model,
            "optimizer": {"state": state, "param_groups": meta["param_groups"]},
            "step": int(meta["step"]), "lr_scale": float(meta.get("lr_scale", 1.0))}


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


# ------------------------------------------------------------------ saving


def _find_parent(root: str, step: int) -> Optional[ResolvedChain]:
    """The newest valid cas step below ``step`` in ``root``: the parent a
    delta diffs against.  A whole-tree-format previous step yields None
    (the save is full); a torn cas candidate is walked past."""
    try:
        names = os.listdir(root)
    except OSError:
        return None
    for s in sorted((int(d) for d in names if d.isdigit() and int(d) < step), reverse=True):
        p = os.path.join(root, str(s))
        manifest = _read_manifest(p)
        if manifest is None:
            continue
        if manifest.get("format") != CAS_FORMAT:
            return None
        try:
            resolved = resolve_leaves(p, manifest)
        except ValueError:
            continue
        if _blobs_invalid_reason(resolved) is not None:
            continue
        return resolved
    return None


def stage_delta(
    ckpt_dir: str, step: int, leaves: List[Tuple[str, np.ndarray]], *,
    digest: Optional[str], extra: Optional[dict] = None,
    store_root: Optional[str] = None,
    delta_max_chain: int = DEFAULT_DELTA_MAX_CHAIN,
) -> dict:
    """Write the moved blobs of ``leaves`` (``(key path, array)``) and a
    staged manifest under ``.tmp-cas-<step>/``; returns the manifest.  Pure
    host I/O, safe on the writer thread.  The per-leaf digests of content
    addressing are the delta decision: no byte comparison with the
    parent."""
    root = _root(ckpt_dir)
    store = os.path.abspath(store_root) if store_root else os.path.join(root, BLOBS_DIR)
    final = os.path.join(root, str(int(step)))
    tmp = os.path.join(root, f"{_CAS_TMP}{int(step)}")
    parent = _find_parent(root, int(step))
    parent_entries = parent.entries if parent is not None else None
    depth = int(parent.manifest.get("delta_depth", 0)) + 1 if parent is not None else 0
    paths = [p for p, _ in leaves]
    mode = "delta"
    if parent is None or depth > max(0, int(delta_max_chain)):
        mode = "full"
    elif set(paths) != set(parent_entries):
        mode = "full"  # the structure moved (another model or optimizer)

    def _write():
        inject.maybe_io_error(f"delta save @{step}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp, exist_ok=True)
        entries, written = [], 0
        for key, arr in leaves:
            arr = np.ascontiguousarray(arr)
            raw = arr.reshape(-1).view(np.uint8)  # hashed and written without a copy
            d = _leaf_digest(arr.dtype, arr.shape, raw)
            entry = {"path": key, "dtype": str(arr.dtype),
                     "shape": [int(s) for s in arr.shape], "digest": d,
                     "nbytes": len(raw)}
            if mode == "delta":
                prev = parent_entries.get(key)
                if prev is not None and prev[0]["digest"] == d:
                    continue  # unchanged: resolves through the chain
            written += _write_blob(store, d, raw)
            entries.append(entry)
        manifest = {
            "step": int(step), "format": CAS_FORMAT, "mode": mode,
            "parent_step": int(parent.manifest["step"]) if mode == "delta" else None,
            "delta_depth": depth if mode == "delta" else 0,
            "blob_root": os.path.relpath(store, final),
            "params_digest": digest, "timestamp": time.time(),
            "leaf_count": len(leaves), "leaves": entries,
            "bytes_written": written, **(extra or {}),
        }
        mtmp = os.path.join(tmp, MANIFEST + ".tmp")
        with open(mtmp, "w") as f:
            json.dump(manifest, f, indent=1)
            f.flush()
            os.fsync(f.fileno())
        os.replace(mtmp, os.path.join(tmp, MANIFEST))
        _count_delta_bytes(mode, written + os.path.getsize(os.path.join(tmp, MANIFEST)))
        return manifest

    return _with_retries(_write, f"delta save @{step}")


def _inherited_delta_blobs(resolved: ResolvedChain) -> List[str]:
    """Blobs the candidate inherits from DELTA ancestors (chain links
    strictly between it and the base full save): the
    ``missing_parent_blob`` fault's targets."""
    if len(resolved.chain_dirs) < 3:
        return []
    base = _read_manifest(resolved.chain_dirs[-1]) or {}
    base_digests = {e["digest"] for e in base.get("leaves", [])}
    own = {e["digest"] for e in resolved.manifest.get("leaves", [])}
    return sorted(_blob_path(store, e["digest"]) for e, store in resolved.entries.values()
                  if e["digest"] not in own and e["digest"] not in base_digests)


def promote_delta(ckpt_dir: str, step: int, keep: Optional[int] = None,
                  store_root: Optional[str] = None, gc: bool = True) -> str:
    """Finalize a staged save: validate its chain and blobs, rename
    ``.tmp-cas-<step>`` to ``<step>``, prune (chain-aware) and GC.
    Idempotent for a promoted step.  ``gc=False`` on a store other runs
    share (``--blob_store``): this run cannot see their manifests."""
    root = _root(ckpt_dir)
    tmp = os.path.join(root, f"{_CAS_TMP}{int(step)}")
    final = os.path.join(root, str(int(step)))
    store = os.path.abspath(store_root) if store_root else os.path.join(root, BLOBS_DIR)
    if not os.path.isdir(tmp) and is_valid_checkpoint(final):
        return final
    reason = cas_invalid_reason(tmp)
    if reason is not None:
        raise OSError(f"cannot promote delta checkpoint step {step}: {reason} — the "
                      "previous finalized step stays authoritative")
    inject.maybe_kill_mid_delta_promote(step)
    _finalize_rename(root, tmp, final, step)
    _sweep_stale_tmp(root)
    # Blobs can only lose their last reference when a manifest goes.
    if keep is not None and prune_checkpoints(root, keep) > 0 and gc:
        gc_blobs(store)
    plan = inject.current()
    if plan is not None and plan.missing_parent_blob is not None:
        inject.maybe_missing_parent_blob(step, _inherited_delta_blobs(resolve_leaves(final)))
    return final


def save_delta(ckpt_dir: str, step: int, state, *,
               store_root: Optional[str] = None,
               delta_max_chain: int = DEFAULT_DELTA_MAX_CHAIN,
               keep: Optional[int] = None, data_state: Optional[dict] = None,
               gc: bool = True) -> Optional[str]:
    """Stage and promote ``state`` (a ``TrainState`` or a ``HostState``) as
    ``ckpt_dir/<step>``; returns the path, or None when its parameters
    are not finite (nothing written, as ``save_state``)."""
    from dwt_tpu_torch.utils.checkpoint import host_state

    host = host_state(state)
    if not host_params_finite(host):
        log.warning("skipping delta save @%d: non-finite params (a NaN checkpoint "
                    "would poison newest-valid resume)", step)
        return None
    leaves, meta = payload_leaves(host.payload)
    digest = params_digest((n, host.payload["model"][n]) for n in host.param_names)
    extra = {TORCH_META: meta}
    if data_state is not None:
        extra["data_state"] = data_state  # every manifest carries its own
    stage_delta(ckpt_dir, step, leaves, digest=digest, extra=extra,
                 store_root=store_root, delta_max_chain=delta_max_chain)
    return promote_delta(ckpt_dir, step, keep=keep, store_root=store_root, gc=gc)


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


# ----------------------------------------------------------------- restore


def _read_blob_full(blob: str, entry: dict, what: str) -> np.ndarray:
    dtype, shape = np.dtype(entry["dtype"]), tuple(entry["shape"])
    with open(blob, "rb") as f:
        raw = f.read()
    if len(raw) != int(entry["nbytes"]):
        raise ValueError(f"{what}: blob for {entry['path']} is {len(raw)} bytes; "
                         f"manifest says {entry['nbytes']}")
    got = _leaf_digest(dtype, shape, raw)
    if got != entry["digest"]:
        raise ValueError(f"{what}: leaf {entry['path']} failed blob digest validation "
                         f"({got[:12]}… != manifest {entry['digest'][:12]}…)")
    count = int(np.prod(shape, dtype=np.int64)) if shape else 1
    return np.frombuffer(raw, dtype=dtype, count=count).reshape(shape)


def _read_arrays(path: str) -> Tuple[ResolvedChain, Dict[str, np.ndarray]]:
    resolved = resolve_leaves(path)
    what = f"checkpoint {path}"
    try:
        arrays = {key: _read_blob_full(_blob_path(store, entry["digest"]), entry, what)
                  for key, (entry, store) in resolved.entries.items()}
    except TypeError as e:  # a dtype numpy does not know (bfloat16)
        raise ValueError(f"{what}: {e}") from None
    except OSError as e:
        raise ValueError(f"{what}: {e}") from None
    return resolved, arrays


def is_torch_chain(manifest: Optional[dict]) -> bool:
    """A cas manifest the port wrote (its state dict's leaves)."""
    return manifest is not None and TORCH_META in manifest


def read_torch_payload(path: str) -> Dict[str, Any]:
    """A port-written cas checkpoint as the ``TrainState.state_dict()``
    payload it was saved from, every leaf's blob digest verified."""
    resolved, arrays = _read_arrays(path)
    return _payload_from_leaves(arrays, resolved.manifest[TORCH_META])


def restore_cas_tree(path: str) -> dict:
    """A JAX-written cas checkpoint as a nested dict of numpy arrays under
    its tree key paths (``params``, ``batch_stats``, ``step``, ...), every
    leaf's blob digest verified: the weight bridge's input."""
    _, arrays = _read_arrays(path)
    tree: dict = {}
    for key, arr in arrays.items():
        keys = keystr_to_path(key)
        if not keys:
            raise ValueError(f"checkpoint {path}: empty leaf path {key!r}")
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = arr
    return tree
