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

The port's delta format (``format: cas_delta``, ``--ckpt_format delta``)
lives in ``dwt_tpu_torch.ckpt.store``; this module validates, ranks,
prunes (chain-aware: a kept manifest's ancestors stay) and restores it
like the full format.

The JAX package's **host-shard** directories (``format: host_shards``:
raw leaf bytes and a JSON manifest per process) and **cas_delta** chains
are read too, into the ``params`` and ``batch_stats`` trees that
:func:`dwt_tpu_torch.convert.load_jax_variables` loads: a model trained
by the JAX package serves from them (:func:`restore_model`) and starts a
trainer (``--init_ckpt``).  They are validated by their manifests, file
sizes and blob digests; their parameter digest is the JAX package's own
(tree key paths), so it is not recomputed here.  Orbax directories (a
manifest without ``format``, or none) are recognized and refused with a
one-line reason: reading them needs Orbax (ROADMAP queue 1 item 3).

Saves take a ``TrainState`` or a :class:`HostState` (the host copy of a
state that the background writer, ``dwt_tpu_torch.resilience.
async_ckpt``, takes on its own stream): one writer, the same bytes on
disk either way.  The fault hooks sit where the JAX package has them: an
injected ``OSError`` at the top of each write attempt, and an injected
crash between the manifest and the finalize rename.

Not ported (ROADMAP queue 1 item 8): multi-host saves and restore onto a
sharding plan.
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
from dwt_tpu_torch.resilience import inject

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
        # The array itself, not a bytes copy: hashlib reads the buffer with
        # the interpreter lock released (the writer thread's digest then
        # does not hold up the thread that launches the train steps).
        h.update(t.reshape(-1).view(torch.uint8).numpy())
    return h.hexdigest()


class HostState(NamedTuple):
    """A ``TrainState.state_dict()`` payload (CPU tensors) and the names
    of the model's parameters in order: what a save writes."""

    payload: dict
    param_names: Tuple[str, ...]


def host_state(state) -> HostState:
    """``state`` (a ``TrainState`` or a ``HostState``) copied to the host."""
    if isinstance(state, HostState):
        return state
    return HostState(state.state_dict(),
                     tuple(n for n, _ in state.model.named_parameters()))


def host_params_finite(host: HostState) -> bool:
    """Every floating parameter of the host copy is finite."""
    weights = host.payload["model"]
    return all(bool(torch.isfinite(weights[n]).all()) for n in host.param_names
               if weights[n].is_floating_point())


def _write_manifest(path: str, step: int, digest: Optional[str],
                    extra: dict) -> int:
    """Write ``path``'s manifest over the files already there; returns
    their bytes."""
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
    return sum(files.values())


def count_ckpt_bytes(mode: str, nbytes: int) -> None:
    """Live-metrics feed: ``dwt_ckpt_bytes_written_total{mode=full|delta}``,
    as the JAX package's (the heartbeat's ``ckpt_bytes_written``).  A
    full-format save counts its manifest's files; the delta store labels
    each save by its manifest's mode."""
    from dwt_tpu_torch.obs.registry import get_registry

    get_registry().counter(
        "dwt_ckpt_bytes_written_total",
        "checkpoint bytes written to disk, by save mode",
        labelnames=("mode",),
    ).labels(mode=mode).inc(int(nbytes))


def _read_manifest(path: str) -> Optional[dict]:
    try:
        with open(os.path.join(path, MANIFEST)) as f:
            manifest = json.load(f)
    except (OSError, ValueError):
        return None
    return manifest if isinstance(manifest, dict) else None


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
        from dwt_tpu_torch.ckpt.store import cas_invalid_reason

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
    """Prune ``root`` to its newest ``keep`` valid steps — chain-aware: a
    step that is a chain ancestor of a kept ``cas_delta`` manifest, or of
    a staged ``.tmp-cas-*`` one, is never deleted.  Returns the number of
    step directories removed (the delta store collects blobs only when it
    is nonzero)."""
    root = _root(root)
    steps = valid_steps(root)
    if keep <= 0 or len(steps) <= keep:
        return 0
    protect = set(steps[-keep:])

    def _protect_ancestors(manifest):
        hops = 0
        while (manifest is not None and manifest.get("format") == CAS_FORMAT
               and manifest.get("parent_step") is not None and hops < 1024):
            parent = int(manifest["parent_step"])
            if parent in protect:
                break
            protect.add(parent)
            manifest = _read_manifest(os.path.join(root, str(parent)))
            hops += 1

    for s in steps[-keep:]:
        _protect_ancestors(_read_manifest(os.path.join(root, str(s))))
    for name in os.listdir(root):
        if name.startswith(_TMP_PREFIX):
            _protect_ancestors(_read_manifest(os.path.join(root, name)))
    removed = 0
    for old in steps[:-keep]:
        if old not in protect:
            shutil.rmtree(os.path.join(root, str(old)), ignore_errors=True)
            removed += 1
    return removed


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
    """Atomically write ``state`` (a ``TrainState``, or the
    :class:`HostState` the background writer took) as
    ``ckpt_dir/<step>``; returns the path.

    A same-step checkpoint is replaced, so re-saves after a resume are
    idempotent.  ``keep=N`` prunes ``ckpt_dir`` to its newest ``N`` steps
    afterwards.  Non-finite parameters are refused: logged, nothing
    written, ``None`` returned — a NaN checkpoint would validate (the
    digest proves integrity, not health) and become the newest valid step
    a resume restores.  ``data_state`` goes into the manifest.
    """
    host = host_state(state)
    if not host_params_finite(host):
        log.warning("skipping checkpoint save @%d: non-finite params (a NaN "
                    "checkpoint would poison newest-valid resume)", step)
        return None
    root = _root(ckpt_dir)
    os.makedirs(root, exist_ok=True)
    final = os.path.join(root, str(int(step)))
    tmp = os.path.join(root, f"{_TMP_PREFIX}{int(step)}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    weights = host.payload["model"]
    digest = params_digest((n, weights[n]) for n in host.param_names)

    def _write():
        inject.maybe_io_error(f"save @{step}")
        os.makedirs(tmp, exist_ok=True)
        with open(os.path.join(tmp, STATE_FILE), "wb") as f:
            torch.save(host.payload, f)
            f.flush()
            os.fsync(f.fileno())

    try:
        _with_retries(_write, f"checkpoint save @{step}")
        nbytes = _write_manifest(tmp, step, digest,
                                 {"format": TORCH_FORMAT, "data_state": data_state})
        # A kill landing here leaves only the unfinalized tmp directory.
        inject.maybe_crash_mid_save(step)
        _finalize_rename(root, tmp, final, step)
    except OSError:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    count_ckpt_bytes("full", nbytes)
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
    if fmt not in (TORCH_FORMAT, HOST_SHARD_FORMAT, CAS_FORMAT):
        return f"checkpoint {path} has unknown format {fmt!r}"
    return None


def _is_jax_checkpoint(manifest: dict) -> bool:
    """A host-shard or cas checkpoint the JAX package wrote."""
    from dwt_tpu_torch.ckpt.store import is_torch_chain

    fmt = manifest.get("format")
    return fmt == HOST_SHARD_FORMAT or (fmt == CAS_FORMAT and not is_torch_chain(manifest))


def read_payload(path: str) -> Tuple[dict, Optional[str]]:
    """The ``TrainState.state_dict()`` payload of a port checkpoint (full
    or delta), on the CPU, and its manifest's parameter digest."""
    manifest = _read_manifest(path)
    reason = _refusal(path, manifest)
    if reason is None and _is_jax_checkpoint(manifest):
        reason = (f"checkpoint {path} is a JAX {manifest['format']} checkpoint: "
                  "its optimizer state is optax's, so it serves "
                  "(ServeEngine.from_checkpoint) and starts a trainer "
                  "(--init_ckpt) but does not resume")
    if reason is not None:
        raise ValueError(reason)
    if manifest["format"] == CAS_FORMAT:
        from dwt_tpu_torch.ckpt.store import read_torch_payload

        return read_torch_payload(path), manifest.get("params_digest")

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
    whiteners = {site.whitener for site in whitening_sites(model).values()}
    tracked = [k for k in missing + extra if k.endswith(".w")]
    if tracked and len(tracked) == len(missing + extra) and whiteners:
        # Only the whitening sites' tracked matrices differ: the stats of
        # another whitener (checkpoints are per-backend artifacts).
        raise ValueError(
            f"checkpoint {path} holds the whitening stats of "
            f"{'a factorizing whitener' if extra == [] else 'the swbn whitener'}, "
            f"not those of this run's --whitener {sorted(whiteners)[0]}")
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


def load_weights(path: str, model: nn.Module, weights: dict,
                 digest: Optional[str]) -> None:
    """Load a port payload's model state dict ``weights`` into ``model``
    once it has exactly the model's entries and shapes and its parameters
    hash to ``digest``; ``ValueError`` otherwise (``path`` names the
    payload in the message)."""
    _check_weights(path, model, weights, digest)
    model.load_state_dict(weights)


def is_jax_checkpoint(path: str) -> bool:
    """Is ``path`` a host-shard or cas checkpoint the JAX package wrote?"""
    manifest = _read_manifest(path)
    return (manifest is not None and _refusal(path, manifest) is None
            and _is_jax_checkpoint(manifest))


def _restore_state_at(path: str, state, jax_params: bool = False) -> int:
    """Restore ``path`` into ``state``; with ``jax_params`` a JAX
    checkpoint loads its parameters and stats only (the optimizer stays
    as it is) and sets the step it recorded."""
    if jax_params:
        manifest = _read_manifest(path)
        if manifest is not None and _is_jax_checkpoint(manifest):
            step = restore_model(path, state.model)
            state.step = int(step or 0)
            return state.step
    payload, digest = read_payload(path)
    _check_weights(path, state.model, payload["model"], digest)
    state.load_state_dict(payload)
    return state.step


def restore_state(ckpt_dir: str, state, step: Optional[int] = None,
                  jax_params: bool = False) -> Restored:
    """Restore ``state`` (a ``TrainState``, in place) from
    ``ckpt_dir/<step>``.

    ``step=None`` restores the newest checkpoint of ``ckpt_dir`` that
    validates and restores, walking older ones on failure; an explicit
    ``step`` must be valid and restore, or this raises.  ``jax_params``
    (``--init_ckpt``) also takes a JAX package's checkpoint, its
    parameters and stats only.
    """
    root = _root(ckpt_dir)
    if step is not None:
        path = os.path.join(root, str(int(step)))
        if not is_valid_checkpoint(path):
            raise FileNotFoundError(
                f"checkpoint step {step} under {ckpt_dir} is missing, "
                "unfinalized, or truncated")
        return Restored(_restore_state_at(path, state, jax_params), "checkpoint", path)
    errors: List[str] = []
    for s in reversed(valid_steps(root)):
        path = os.path.join(root, str(s))
        try:
            return Restored(_restore_state_at(path, state, jax_params),
                            "checkpoint", path)
        except (OSError, ValueError) as e:
            errors.append(f"step {s}: {e}")
    raise FileNotFoundError(
        f"no restorable checkpoints under {ckpt_dir}"
        + (f" (tried: {'; '.join(errors)})" if errors else ""))


def restore_model(path: str, model: nn.Module) -> Optional[int]:
    """Load one finalized checkpoint's parameters and running stats into
    ``model`` (no optimizer), in the port's formats or the JAX package's
    host-shard and cas formats; returns the checkpoint's step.  A
    structure or shape mismatch with ``model`` raises ``ValueError``."""
    manifest = _read_manifest(path)
    reason = _refusal(path, manifest)
    if reason is not None:
        raise ValueError(reason)
    if _is_jax_checkpoint(manifest):
        if manifest["format"] == HOST_SHARD_FORMAT:
            tree = read_host_shard_tree(path)
        else:
            from dwt_tpu_torch.ckpt.store import restore_cas_tree

            tree = restore_cas_tree(path)
        if "params" not in tree or "batch_stats" not in tree:
            raise ValueError(f"checkpoint {path} holds no params/batch_stats")
        try:
            load_jax_variables(model, tree["params"], tree["batch_stats"])
        except KeyError as e:
            raise ValueError(f"checkpoint {path}: {e}") from None
        step = tree.get("step")
    else:
        payload, digest = read_payload(path)
        load_weights(path, model, payload["model"], digest)
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
