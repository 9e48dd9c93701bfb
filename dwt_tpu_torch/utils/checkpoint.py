"""Atomic, validated checkpoints of a ``TrainState`` — the single-process subset of ``dwt_tpu.utils.checkpoint``.

This module is the one authority on what a valid checkpoint is, on
walking the candidates of a run and on restoring them.  The JAX package's
three defenses, with its function names:

* **atomic finalize** — a save writes ``<ckpt_dir>/.tmp-<step>/`` and
  renames it to ``<step>`` only after its manifest is written
  (:func:`_finalize_rename`).  A kill at any point leaves the previous
  checkpoints untouched and, at worst, a ``.tmp-`` directory that a later
  save sweeps; a same-step re-save moves the old step aside first and
  never deletes it before the new one is in place.
* **per-step manifest** — ``manifest.json`` records the format, the
  step, a SHA-256 digest of the parameters (:func:`params_digest`), a
  timestamp, every file's size and the data plane's ``data_state``.  A
  checkpoint whose manifest is missing a listed file, or lists another
  size, is invalid (truncation found without reading the bytes); the
  digest is verified again after the read (bit corruption).
* **newest-valid fallback** — a restore walks the candidates newest
  first, across the main directory and ``anchors/``
  (:func:`restore_newest`), and returns the first that validates and
  restores.

The port's format (``format: torch_full``): ``<step>/state.pt`` holds
``{"model": state_dict, "optimizer": optimizer.state_dict(), "step":
int}``, every tensor a contiguous CPU copy, read back with
``torch.load(weights_only=True)``, so a checkpoint written on the card
loads on the CPU and the reverse.

The JAX package's **host-shard** directories (``format: host_shards``:
raw leaf bytes and a JSON manifest per process) are read too, into the
``params`` and ``batch_stats`` trees that
:func:`dwt_tpu_torch.convert.load_jax_variables` loads: a model trained
by the JAX package serves from them (:func:`restore_model`).  They are
validated by their manifests and file sizes; their digest is the JAX
package's own (tree key paths), so it is not recomputed here.  Orbax
directories (a manifest without ``format``, or none) and ``cas_delta``
directories are recognized and refused with a one-line reason: reading
them needs Orbax or the JAX package's blob store (ROADMAP queue 1
item 3).

Not ported (ROADMAP queue 1 item 3): the background writer thread
(``--async_ckpt``), the content-addressed delta format (``--ckpt_format
delta``), multi-host saves and restore onto a sharding plan.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import re
import shutil
import time
from typing import Any, Callable, Iterable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn

from dwt_tpu_torch.convert.from_jax import load_jax_variables
from dwt_tpu_torch.nn.norms import install_eval_matrix, whitening_sites

log = logging.getLogger(__name__)

MANIFEST = "manifest.json"
STATE_FILE = "state.pt"
TORCH_FORMAT = "torch_full"
HOST_SHARD_FORMAT = "host_shards"
CAS_FORMAT = "cas_delta"
SHARD_MANIFEST = "shard_manifest.json"
_LEAVES_FILE = "leaves.bin"
_TMP_PREFIX = ".tmp-"
# Anchor checkpoints (--anchor_every) live in a subdirectory that nothing
# prunes, so the distance back to a valid step stays bounded by the
# anchor cadence even when every main-directory checkpoint is torn.
ANCHOR_SUBDIR = "anchors"

# Transient-I/O retry policy of checkpoint reads and writes.
IO_RETRIES = 3
IO_BACKOFF_S = 0.05

# A .tmp- directory older than this is presumed abandoned (its writer
# dead) and swept; a younger one may be a live save of another job that
# shares the directory.
STALE_TMP_AGE_S = 3600.0

_UNREAD = "(ROADMAP queue 1 item 3)"


class Restored(NamedTuple):
    """What a restore read: the step, where from (``"checkpoint"``: the
    main directory, or ``"anchor"``) and the step directory."""

    step: Optional[int]
    source: str
    path: str


def _root(ckpt_dir: str) -> str:
    return os.path.abspath(os.path.expanduser(ckpt_dir))


def _with_retries(fn: Callable[[], Any], what: str) -> Any:
    """Run ``fn`` retrying transient ``OSError`` with bounded backoff."""
    for attempt in range(IO_RETRIES):
        try:
            return fn()
        except OSError as e:
            if attempt == IO_RETRIES - 1:
                raise
            delay = IO_BACKOFF_S * (2 ** attempt)
            log.warning("%s failed (%s); retry %d/%d in %.2fs",
                        what, e, attempt + 1, IO_RETRIES - 1, delay)
            time.sleep(delay)


def params_digest(named: Iterable[Tuple[str, torch.Tensor]]) -> str:
    """SHA-256 over ``(name, tensor)`` pairs in order — each name, dtype,
    shape and the tensor's contiguous CPU bytes, so a channels_last
    weight digests the same as its NCHW copy and a card tensor as its
    CPU copy.  Pass ``model.named_parameters()``."""
    h = hashlib.sha256()
    for name, t in named:
        t = t.detach().to("cpu").contiguous()
        h.update(name.encode())
        h.update(str(t.dtype).encode())
        h.update(str(tuple(t.shape)).encode())
        h.update(t.reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def params_finite(model: nn.Module) -> bool:
    """One device verdict: every floating parameter is finite."""
    flags = [torch.isfinite(p).all() for p in model.parameters()
             if p.is_floating_point()]
    return bool(torch.stack(flags).all()) if flags else True


def _write_manifest(path: str, step: int, digest: Optional[str],
                    extra: dict) -> None:
    files = {}
    for sub, _, names in os.walk(path):
        for name in names:
            full = os.path.join(sub, name)
            files[os.path.relpath(full, path)] = os.path.getsize(full)
    manifest = {"step": int(step), "params_digest": digest,
                "timestamp": time.time(), "files": files, **extra}
    with open(os.path.join(path, MANIFEST), "w") as f:
        json.dump(manifest, f, indent=1)
        f.flush()
        os.fsync(f.fileno())


def _read_manifest(path: str) -> Optional[dict]:
    try:
        with open(os.path.join(path, MANIFEST)) as f:
            manifest = json.load(f)
    except (OSError, ValueError):
        return None
    return manifest if isinstance(manifest, dict) else None


def checkpoint_invalid_reason(path: str) -> Optional[str]:
    """None when ``path`` is a finalized checkpoint whose manifest checks
    out, else a one-line reason.  Unfinalized ``.tmp-`` directories are
    never valid.  A directory without a manifest is a legacy Orbax
    artifact of the JAX package: valid here, refused by the readers."""
    if not os.path.isdir(path):
        return "not a directory"
    if os.path.basename(path).startswith(_TMP_PREFIX):
        return "unfinalized tmp directory"
    if not os.path.exists(os.path.join(path, MANIFEST)):
        return None
    manifest = _read_manifest(path)
    if manifest is None:
        return "unreadable manifest"
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


def _sweep_stale_tmp(root: str) -> None:
    """Remove ``.tmp-`` directories old enough that their writer is
    certainly dead."""
    now = time.time()
    for d in os.listdir(root):
        if not d.startswith(_TMP_PREFIX):
            continue
        full = os.path.join(root, d)
        try:
            if now - os.path.getmtime(full) <= STALE_TMP_AGE_S:
                continue
        except OSError:
            continue
        shutil.rmtree(full, ignore_errors=True)


def prune_checkpoints(root: str, keep: int) -> int:
    """Prune ``root`` to its newest ``keep`` valid steps; returns the
    number of step directories removed."""
    steps = valid_steps(root)
    if keep <= 0 or len(steps) <= keep:
        return 0
    for old in steps[:-keep]:
        shutil.rmtree(os.path.join(_root(root), str(old)), ignore_errors=True)
    return len(steps) - keep


def _finalize_rename(root: str, tmp: str, final: str, step: int) -> None:
    """Atomically promote ``tmp`` to ``final``.  A same-step re-save never
    opens a window with the old artifact deleted and the new one not yet
    in place: the old step is moved aside into the tmp namespace, the new
    one finalized, then the aside dropped."""
    if os.path.exists(final):
        aside = os.path.join(root, f"{_TMP_PREFIX}replaced-{int(step)}")
        if os.path.exists(aside):
            shutil.rmtree(aside)
        os.replace(final, aside)
        os.replace(tmp, final)
        shutil.rmtree(aside, ignore_errors=True)
    else:
        os.replace(tmp, final)


def load_data_state(step_dir: str) -> Optional[dict]:
    """The checkpoint's recorded ``data_state`` (``DataPlane.snapshot``),
    or None — a save made without a data plane, or a manifest-less
    artifact: the caller then resumes at an epoch boundary."""
    manifest = _read_manifest(step_dir)
    ds = None if manifest is None else manifest.get("data_state")
    return ds if isinstance(ds, dict) else None


def save_state(
    ckpt_dir: str, step: int, state, keep: Optional[int] = None,
    data_state: Optional[dict] = None,
) -> Optional[str]:
    """Atomically write ``state`` (a ``TrainState``) as
    ``ckpt_dir/<step>``; returns the path.

    A same-step checkpoint is replaced, so re-saves after a resume are
    idempotent.  ``keep=N`` prunes ``ckpt_dir`` to its newest ``N`` steps
    afterwards.  Non-finite parameters are refused: logged, nothing
    written, ``None`` returned — a NaN checkpoint would validate (the
    digest proves integrity, not health) and become the newest valid step
    a resume restores.  ``data_state`` goes into the manifest.
    """
    model = state.model
    if not params_finite(model):
        log.warning("skipping checkpoint save @%d: non-finite params (a NaN "
                    "checkpoint would poison newest-valid resume)", step)
        return None
    root = _root(ckpt_dir)
    os.makedirs(root, exist_ok=True)
    final = os.path.join(root, str(int(step)))
    tmp = os.path.join(root, f"{_TMP_PREFIX}{int(step)}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    payload = state.state_dict()
    weights = payload["model"]
    digest = params_digest((n, weights[n]) for n, _ in model.named_parameters())

    def _write():
        os.makedirs(tmp, exist_ok=True)
        with open(os.path.join(tmp, STATE_FILE), "wb") as f:
            torch.save(payload, f)
            f.flush()
            os.fsync(f.fileno())

    try:
        _with_retries(_write, f"checkpoint save @{step}")
        _write_manifest(tmp, step, digest,
                        {"format": TORCH_FORMAT, "data_state": data_state})
        _finalize_rename(root, tmp, final, step)
    except OSError:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    _sweep_stale_tmp(root)
    if keep is not None:
        prune_checkpoints(root, keep)
    return final


# ------------------------------------------------------------------ reads


def _refusal(path: str, manifest: Optional[dict]) -> Optional[str]:
    """Why the port does not read ``path``'s format, or None."""
    fmt = None if manifest is None else manifest.get("format")
    if manifest is None or fmt is None:
        return (f"checkpoint {path} is an Orbax directory of the JAX "
                f"package, which the port does not read {_UNREAD}")
    if fmt == CAS_FORMAT:
        return (f"checkpoint {path} is a JAX cas_delta checkpoint, which "
                f"the port does not read {_UNREAD}")
    if fmt not in (TORCH_FORMAT, HOST_SHARD_FORMAT):
        return f"checkpoint {path} has unknown format {fmt!r}"
    return None


def _read_payload(path: str) -> Tuple[dict, Optional[str]]:
    """The ``state.pt`` of a port checkpoint, on the CPU, and its
    manifest's parameter digest."""
    manifest = _read_manifest(path)
    reason = _refusal(path, manifest)
    if reason is None and manifest.get("format") != TORCH_FORMAT:
        reason = (f"checkpoint {path} is a JAX host-shard checkpoint: its "
                  "optimizer state is optax's, so it serves "
                  "(ServeEngine.from_checkpoint) but does not resume")
    if reason is not None:
        raise ValueError(reason)

    def _read():
        with open(os.path.join(path, STATE_FILE), "rb") as f:
            return torch.load(f, map_location="cpu", weights_only=True)

    try:
        payload = _with_retries(_read, f"checkpoint restore {path}")
    except (RuntimeError, EOFError) as e:  # torch's reader on bad bytes
        raise ValueError(f"checkpoint {path}: unreadable {STATE_FILE} ({e})")
    return payload, manifest.get("params_digest")


def _check_weights(path: str, model: nn.Module, weights: dict,
                   digest: Optional[str]) -> None:
    """Raise ``ValueError`` unless ``weights`` (a state dict) has exactly
    the model's entries and shapes, and its parameters ``digest``."""
    want = model.state_dict()
    missing = sorted(set(want) - set(weights))
    extra = sorted(set(weights) - set(want))
    if missing or extra:
        raise ValueError(
            f"checkpoint {path} does not match {type(model).__name__}: "
            f"missing {missing[:3]}, unexpected {extra[:3]}")
    for key, value in weights.items():
        if tuple(value.shape) != tuple(want[key].shape):
            raise ValueError(
                f"checkpoint {path}: {key} has shape {tuple(value.shape)}; "
                f"the model expects {tuple(want[key].shape)}")
    got = params_digest((n, weights[n]) for n, _ in model.named_parameters())
    if got != digest:
        raise ValueError(
            f"checkpoint {path} failed digest validation "
            f"({got[:12]}… != manifest {str(digest)[:12]}…)")


def _restore_state_at(path: str, state) -> int:
    payload, digest = _read_payload(path)
    _check_weights(path, state.model, payload["model"], digest)
    state.load_state_dict(payload)
    return state.step


def restore_state(ckpt_dir: str, state, step: Optional[int] = None) -> Restored:
    """Restore ``state`` (a ``TrainState``, in place) from
    ``ckpt_dir/<step>``.

    ``step=None`` restores the newest checkpoint of ``ckpt_dir`` that
    validates and restores, walking older ones on failure; an explicit
    ``step`` must be valid and restore, or this raises.
    """
    root = _root(ckpt_dir)
    if step is not None:
        path = os.path.join(root, str(int(step)))
        if not is_valid_checkpoint(path):
            raise FileNotFoundError(
                f"checkpoint step {step} under {ckpt_dir} is missing, "
                "unfinalized, or truncated")
        return Restored(_restore_state_at(path, state), "checkpoint", path)
    errors: List[str] = []
    for s in reversed(valid_steps(root)):
        path = os.path.join(root, str(s))
        try:
            return Restored(_restore_state_at(path, state), "checkpoint", path)
        except (OSError, ValueError) as e:
            errors.append(f"step {s}: {e}")
    raise FileNotFoundError(
        f"no restorable checkpoints under {ckpt_dir}"
        + (f" (tried: {'; '.join(errors)})" if errors else ""))


def restore_model(path: str, model: nn.Module) -> Optional[int]:
    """Load one finalized checkpoint's parameters and running stats into
    ``model`` (no optimizer), in the port's format or the JAX package's
    host-shard format; returns the checkpoint's step.  A structure or
    shape mismatch with ``model`` raises ``ValueError``."""
    manifest = _read_manifest(path)
    reason = _refusal(path, manifest)
    if reason is not None:
        raise ValueError(reason)
    if manifest.get("format") == HOST_SHARD_FORMAT:
        tree = read_host_shard_tree(path)
        if "params" not in tree or "batch_stats" not in tree:
            raise ValueError(f"checkpoint {path} holds no params/batch_stats")
        try:
            load_jax_variables(model, tree["params"], tree["batch_stats"])
        except KeyError as e:
            raise ValueError(f"checkpoint {path}: {e}") from None
        step = tree.get("step")
    else:
        payload, digest = _read_payload(path)
        _check_weights(path, model, payload["model"], digest)
        model.load_state_dict(payload["model"])
        step = payload["step"]
    for site in whitening_sites(model).values():
        install_eval_matrix(site, None)
    return None if step is None else int(np.asarray(step))


# -------------------------------------------------- JAX host-shard format

_KEYSTR_TOKEN = re.compile(
    r"\.([A-Za-z_]\w*)|\['([^']*)'\]|\[\"([^\"]*)\"\]|\[(\d+)\]"
)


def keystr_to_path(keystr: str) -> Tuple[str, ...]:
    """Parse a ``jax.tree_util.keystr`` string into a key tuple:
    ``.params['conv1']['kernel']`` → ``("params", "conv1", "kernel")``.
    Raises on unparsable residue rather than misfile a leaf."""
    path: List[str] = []
    pos = 0
    for m in _KEYSTR_TOKEN.finditer(keystr):
        if m.start() != pos:
            raise ValueError(f"unparsable keystr {keystr!r} at offset {pos}")
        path.append(next(g for g in m.groups() if g is not None))
        pos = m.end()
    if pos != len(keystr):
        raise ValueError(f"unparsable keystr {keystr!r} at offset {pos}")
    return tuple(path)


def _read_shard_manifest(shard_dir: str) -> Optional[dict]:
    try:
        with open(os.path.join(shard_dir, SHARD_MANIFEST)) as f:
            manifest = json.load(f)
    except (OSError, ValueError):
        return None
    for rel, size in manifest.get("files", {}).items():
        full = os.path.join(shard_dir, rel)
        if not os.path.exists(full) or os.path.getsize(full) != size:
            return None
    return manifest


# The subtrees of a JAX TrainState a model needs; the optimizer's optax
# state is not read.
_HOST_SHARD_KEYS = ("params", "batch_stats", "step")


def read_host_shard_tree(path: str) -> dict:
    """A promoted JAX host-shard checkpoint's ``params``, ``batch_stats``
    and ``step`` as nested dicts of numpy arrays, rebuilt from shard 0's
    manifest (any shard holds the full replica)."""
    shard_dir = os.path.join(path, "shard_0")
    shard = _read_shard_manifest(shard_dir)
    if shard is None:
        raise ValueError(f"checkpoint {path}: shard manifest missing/torn")
    with open(os.path.join(shard_dir, _LEAVES_FILE), "rb") as f:
        blob = f.read()
    tree: dict = {}
    for entry in shard["leaves"]:
        keys = keystr_to_path(entry["path"])
        if not keys:
            raise ValueError(f"checkpoint {path}: empty leaf path in shard manifest")
        if keys[0] not in _HOST_SHARD_KEYS:
            continue
        try:
            dtype = np.dtype(entry["dtype"])
        except TypeError:
            raise ValueError(f"checkpoint {path}: {entry['path']} has dtype "
                             f"{entry['dtype']}, which numpy does not read")
        shape = tuple(entry["shape"])
        arr = np.frombuffer(blob, dtype=dtype, count=int(np.prod(shape, dtype=np.int64)),
                            offset=entry["offset"]).reshape(shape)
        node = tree
        for key in keys[:-1]:
            node = node.setdefault(key, {})
        node[keys[-1]] = arr
    return tree


# ------------------------------------------------- ranked checkpoint walk


def anchor_dir(ckpt_dir: str) -> str:
    return os.path.join(ckpt_dir, ANCHOR_SUBDIR)


def ranked_checkpoints(ckpt_dir: str):
    """Every valid checkpoint across the main directory and its anchors as
    ``(step, is_main, source, dir)``, newest step first (a step saved to
    both prefers the main directory)."""
    ranked = []
    for src, d in (("checkpoint", ckpt_dir), ("anchor", anchor_dir(ckpt_dir))):
        for s in valid_steps(d):
            ranked.append((s, src == "checkpoint", src, d))
    ranked.sort(reverse=True)
    return ranked


def restore_newest(ckpt_dir: str, target, ranked=None) -> Restored:
    """Restore the newest step that validates and restores, ranked by step
    across the main directory and ``anchors/``.  Raises
    ``FileNotFoundError``, with every candidate's reason, when none does:
    a caller never trains or serves from init over checkpoints it could
    not read.

    ``target`` is a ``TrainState`` (resume: model, optimizer and step,
    port format only) or an ``nn.Module`` (serving: parameters and stats,
    either format; :func:`restore_model`).  ``ranked`` reuses a
    :func:`ranked_checkpoints` walk the caller already made.
    """
    if ranked is None:
        ranked = ranked_checkpoints(ckpt_dir)
    errors = []
    for s, _, src, d in ranked:
        path = os.path.join(_root(d), str(s))
        try:
            if isinstance(target, nn.Module):
                step = restore_model(path, target)
            else:
                step = _restore_state_at(path, target)
            if errors:
                log.warning("restored %s step %d after skipping newer "
                            "checkpoints: %s", src, s, "; ".join(errors))
            return Restored(step, src, path)
        except (OSError, ValueError) as e:
            errors.append(f"{src} step {s}: {e}")
    raise FileNotFoundError(
        f"no restorable checkpoints under {ckpt_dir} (main or anchors)"
        + (f": {' | '.join(errors)}" if errors else ""))
