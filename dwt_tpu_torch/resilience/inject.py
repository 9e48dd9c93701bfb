"""Deterministic fault injection for the port's trainers — the ported subset of ``dwt_tpu.resilience.inject``.

The production code consults these hooks at exactly the points where the
real fault would strike, so every recovery path can be driven on demand:

* ``maybe_nan(state, metrics, lo, hi)`` — called by the train loops after
  each step; poisons the parameters (in place, on their device) and the
  step's metrics with NaN when an armed step falls in ``[lo, hi]``.  A
  list of steps is a burst: the poison re-strikes after each recovery.
* ``maybe_crash_mid_save(step)`` — called by ``save_state`` after the
  bytes and the manifest are written, before the finalize rename; raises
  :class:`SimulatedCrash`, leaving an unfinalized tmp directory behind.
* ``maybe_io_error(what)`` — called at the top of each checkpoint write
  attempt; raises ``OSError`` for the first ``io_error_saves`` attempts
  (a small count is absorbed by the retries, a large one surfaces).
* ``at_step(lo, hi)`` — the step-boundary control faults: ``slow_step``,
  ``notice_at_step`` (the preemption notice becomes visible),
  ``sigterm_at_step`` (a self-delivered SIGTERM) and ``hang`` (never
  returns; only the hang watchdog ends the process).
* ``maybe_kill_mid_delta_promote(step)`` — SIGKILLs the process inside
  the delta store's promote, after the staged chain validates and before
  the finalize rename.
* ``maybe_missing_parent_blob(step, paths)`` — after the delta save at
  ``step`` finalizes, deletes one blob a delta ancestor wrote; the
  newest-valid walk must fall back to the last full save.
* ``wrap_dataset(ds, role)`` / :class:`FlakyDataset` — items that are
  corrupt (always raise), hang their first access (``dead_worker_at``:
  the data pool's stall detection must respawn them) or stall their
  first access (``slow_item_at``).
* ``maybe_shift_request(i, x)`` — applies ``serve_drift_shift``, an
  affine input-distribution shift from request ``at_request`` on
  (persistent: a shifted domain is a new steady state the online adapter
  must keep seeing until it adapts); ``maybe_poison_request(i, x)``
  applies ``serve_poison_requests`` — at each armed request index
  (one-shot per index) a strided slice of a copy of the payload becomes
  NaN, Inf or 1e6, cycling by index.  The two compose, drift first.

All hooks are no-ops (one ``is None`` check) unless a plan is armed.  Arm
with :func:`arm`, or through the ``DWT_FAULT_PLAN`` environment variable
(JSON, read once at first use) — the scheduler-facing contract both
packages share.  Every fault fires at most once per arm (each element of a
burst once).

The JAX package's host-shard, sweep-supervisor and multi-replica fleet
kinds are not ported: a plan naming one raises with the ROADMAP item that
takes it, since a plan that silently injects nothing proves nothing.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import signal
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import torch

ENV_VAR = "DWT_FAULT_PLAN"

# Kinds of the JAX package's plans that the port does not inject yet, with
# the ROADMAP queue 1 item that takes each.
UNPORTED_KINDS = {
    "kill_writer_mid_shard": "item 8 (multi-host host-shard writes)",
    "kill_supervisor_at_schedule": "item 9 (sweeps)",
    "sweep_preempt_pairs": "item 9 (sweeps)",
    "sweep_job_kill_mid_save": "item 9 (sweeps)",
    "traffic_spike": "item 7 (the fleet)",
    "replica_slow_at": "item 7 (the fleet)",
}


class SimulatedCrash(Exception):
    """Raised by an armed crash-mid-save hook (stands in for SIGKILL)."""


def _as_step_list(value: Any, field: str, minimum: int = 1) -> Optional[List[int]]:
    """Normalize an int-or-list spec; reject bools, floats, duplicates and
    values below ``minimum`` (steps are 1-based, item indices 0-based)."""
    if value is None:
        return None
    items = value if isinstance(value, list) else [value]
    steps: List[int] = []
    for v in items:
        if isinstance(v, bool) or not isinstance(v, int):
            raise ValueError(
                f"{ENV_VAR}: {field} must be an int step or list of int "
                f"steps; got {v!r}")
        if v < minimum:
            raise ValueError(
                f"{ENV_VAR}: {field} values must be >= {minimum} (got {v}) — "
                "a value that can never fire is a silent no-op, not a fault")
        steps.append(v)
    if len(set(steps)) != len(steps):
        raise ValueError(f"{ENV_VAR}: duplicate steps in {field}: {steps}")
    return sorted(steps)


def _opt_int(spec: dict, field: str) -> Optional[int]:
    v = spec.get(field)
    if v is None:
        return None
    if isinstance(v, bool) or not isinstance(v, int):
        raise ValueError(f"{ENV_VAR}: {field} must be an int step; got {v!r}")
    if v < 1:
        raise ValueError(f"{ENV_VAR}: {field} must be a 1-based step >= 1; "
                         f"got {v} (it would never fire)")
    return v


def _non_negative(spec: dict, field: str, default: float) -> float:
    v = spec.get(field, default)
    if isinstance(v, bool) or not isinstance(v, (int, float)) or v < 0:
        raise ValueError(f"{ENV_VAR}: {field} must be a non-negative number; "
                         f"got {v!r}")
    return float(v)


def _true_or_step(spec: dict, field: str) -> Any:
    v = spec.get(field)
    if v is not None and v is not True and (
            isinstance(v, bool) or not isinstance(v, int) or v < 1):
        raise ValueError(f"{ENV_VAR}: {field} must be true (next occurrence) "
                         f"or an int step >= 1; got {v!r}")
    return v


def _role_items(spec: dict, field: str) -> Optional[Dict[str, List[int]]]:
    """A stream role → 0-based item indices map (``corrupt_items`` and the
    data-pipeline kinds share its shape and rules)."""
    value = spec.get(field)
    if value is None:
        return None
    if not isinstance(value, dict):
        raise ValueError(f"{ENV_VAR}: {field} must map a stream role to a "
                         f"list of item indices; got {value!r}")
    out = {}
    for role, ids in value.items():
        if role not in ("source", "target"):
            raise ValueError(f"{ENV_VAR}: {field} role must be 'source' or "
                             f"'target'; got {role!r}")
        out[role] = _as_step_list(ids, f"{field}[{role!r}]", minimum=0)
    return out


def _drift_shift(drift: Any) -> Optional[Dict[str, Any]]:
    """A validated ``serve_drift_shift`` spec, normalized."""
    if drift is None:
        return None
    if not isinstance(drift, dict):
        raise ValueError(
            f"{ENV_VAR}: serve_drift_shift must be an object like "
            '{"at_request": N, "offset": f, "scale": f}; '
            f"got {drift!r}")
    bad_keys = sorted(set(drift) - {"at_request", "offset", "scale"})
    if bad_keys:
        raise ValueError(
            f"{ENV_VAR}: unknown serve_drift_shift key(s) {bad_keys}; "
            "valid: ['at_request', 'offset', 'scale']")
    at = drift.get("at_request", 0)
    if isinstance(at, bool) or not isinstance(at, int) or at < 0:
        raise ValueError(
            f"{ENV_VAR}: serve_drift_shift.at_request must be a 0-based "
            f"request index >= 0; got {at!r}")
    offset = drift.get("offset", 0.0)
    scale = drift.get("scale", 1.0)
    for name, v in (("offset", offset), ("scale", scale)):
        if isinstance(v, bool) or not isinstance(v, (int, float)) \
                or not math.isfinite(v):
            raise ValueError(
                f"{ENV_VAR}: serve_drift_shift.{name} must be a finite "
                f"number; got {v!r} — non-finite inputs are "
                "serve_poison_requests' job, not a domain shift")
    if float(scale) == 1.0 and float(offset) == 0.0:
        raise ValueError(
            f"{ENV_VAR}: serve_drift_shift with scale=1 and offset=0 is the "
            "identity — a shift that moves nothing proves nothing")
    return {"at_request": at, "offset": float(offset), "scale": float(scale)}


@dataclasses.dataclass
class FaultPlan:
    """One-shot fault schedule; every field defaults to "never fire".
    The fields are the JAX plan's, for the kinds the port injects."""

    nan_at_step: Any = None  # int, or a burst list of steps
    crash_in_save: Any = None  # True = next save; int = the save at that step
    hang_at_step: Optional[int] = None
    slow_step_at: Optional[int] = None
    slow_step_s: float = 1.0
    sigterm_at_step: Optional[int] = None
    io_error_saves: int = 0  # write ATTEMPTS that raise OSError
    corrupt_items: Optional[Dict[str, List[int]]] = None
    dead_worker_at: Optional[Dict[str, List[int]]] = None
    slow_item_at: Optional[Dict[str, List[int]]] = None
    slow_item_s: float = 1.0
    notice_at_step: Optional[int] = None
    kill_mid_delta_promote: Any = None  # True = next promote; int = that step
    missing_parent_blob: Optional[int] = None
    # 0-based request indices whose payload becomes garbage (NaN / Inf /
    # out-of-band magnitude, cycling by index); one-shot per index.
    serve_poison_requests: Optional[List[int]] = None
    # {"at_request": N, "offset": f, "scale": f}: from request N on, inputs
    # become x*scale + offset.  Persistent, not one-shot.
    serve_drift_shift: Optional[Dict[str, Any]] = None

    @classmethod
    def from_spec(cls, spec: Dict[str, Any]) -> "FaultPlan":
        """A validated plan from a parsed JSON object.  Unknown kinds, the
        JAX kinds this port does not inject, bad types, duplicate steps and
        overlapping control faults all raise instead of being dropped."""
        fields = [f.name for f in dataclasses.fields(cls)]
        unported = sorted(set(spec) & set(UNPORTED_KINDS))
        if unported:
            raise ValueError(
                f"{ENV_VAR}: fault kind(s) {unported} are not ported to "
                "dwt_tpu_torch: " + "; ".join(
                    f"{k} waits for ROADMAP queue 1 {UNPORTED_KINDS[k]}"
                    for k in unported))
        unknown = sorted(set(spec) - set(fields))
        if unknown:
            raise ValueError(f"{ENV_VAR}: unknown fault kind(s) {unknown}; "
                             f"valid kinds: {fields}")
        nan = _as_step_list(spec.get("nan_at_step"), "nan_at_step")
        if nan is not None and not isinstance(spec["nan_at_step"], list):
            nan = nan[0]  # scalar in, scalar out (burst lists stay lists)
        hang = _opt_int(spec, "hang_at_step")
        slow = _opt_int(spec, "slow_step_at")
        sigterm = _opt_int(spec, "sigterm_at_step")
        notice = _opt_int(spec, "notice_at_step")
        if notice is not None and sigterm is not None and notice >= sigterm:
            raise ValueError(
                f"{ENV_VAR}: notice_at_step ({notice}) must precede "
                f"sigterm_at_step ({sigterm}) — a notice is the scheduler's "
                "advance warning, and a plan where it cannot fire before the "
                "SIGTERM proves nothing about the proactive save")
        if hang is not None and sigterm is not None:
            raise ValueError(
                f"{ENV_VAR}: hang_at_step and sigterm_at_step cannot compose "
                "in one plan — a hang ends the process's useful life and can "
                "swallow the SIGTERM; pick one control fault per plan")
        slow_s = _non_negative(spec, "slow_step_s", 1.0)
        if "slow_step_s" in spec and slow is None:
            raise ValueError(f"{ENV_VAR}: slow_step_s without slow_step_at arms "
                             "nothing — name the step the stall should hit")
        io_saves = spec.get("io_error_saves", 0)
        if isinstance(io_saves, bool) or not isinstance(io_saves, int) or io_saves < 0:
            raise ValueError(f"{ENV_VAR}: io_error_saves must be a non-negative "
                             f"int; got {io_saves!r}")
        crash = spec.get("crash_in_save")
        if crash is not None and crash is not True and (
                isinstance(crash, bool) or not isinstance(crash, int) or crash < 1):
            raise ValueError(f"{ENV_VAR}: crash_in_save must be true (next save) "
                             f"or an int step >= 1; got {crash!r}")
        slow_item = _role_items(spec, "slow_item_at")
        slow_item_s = _non_negative(spec, "slow_item_s", 1.0)
        if "slow_item_s" in spec and slow_item is None:
            raise ValueError(f"{ENV_VAR}: slow_item_s without slow_item_at arms "
                             "nothing — name the item the stall should hit")
        return cls(
            serve_poison_requests=_as_step_list(
                spec.get("serve_poison_requests"), "serve_poison_requests",
                minimum=0),
            serve_drift_shift=_drift_shift(spec.get("serve_drift_shift")),
            nan_at_step=nan, crash_in_save=crash, hang_at_step=hang,
            slow_step_at=slow, slow_step_s=slow_s, sigterm_at_step=sigterm,
            io_error_saves=io_saves,
            corrupt_items=_role_items(spec, "corrupt_items"),
            dead_worker_at=_role_items(spec, "dead_worker_at"),
            slow_item_at=slow_item, slow_item_s=slow_item_s,
            notice_at_step=notice,
            kill_mid_delta_promote=_true_or_step(spec, "kill_mid_delta_promote"),
            missing_parent_blob=_opt_int(spec, "missing_parent_blob"),
        )

    @classmethod
    def from_env(cls) -> Optional["FaultPlan"]:
        raw = os.environ.get(ENV_VAR)
        if not raw:
            return None

        def _no_duplicates(pairs):
            keys = [k for k, _ in pairs]
            dupes = sorted({k for k in keys if keys.count(k) > 1})
            if dupes:
                raise ValueError(f"{ENV_VAR}: duplicate fault kind(s) {dupes} — "
                                 "the second spec would silently shadow the first")
            return dict(pairs)

        try:
            spec = json.loads(raw, object_pairs_hook=_no_duplicates)
        except json.JSONDecodeError as e:
            raise ValueError(f"{ENV_VAR} is not valid JSON: {e}") from e
        if not isinstance(spec, dict):
            raise ValueError(f"{ENV_VAR} must be a JSON object of fault kinds; "
                             f"got {type(spec).__name__}")
        return cls.from_spec(spec)


_plan: Optional[FaultPlan] = None
_env_checked = False


def arm(plan: FaultPlan) -> None:
    global _plan, _env_checked
    _plan = plan
    _env_checked = True


def disarm() -> None:
    """Drop the plan for good in this process (the environment is not read
    again) and clear a notice an injected ``notice_at_step`` latched."""
    global _plan, _env_checked
    _plan = None
    _env_checked = True
    from dwt_tpu_torch.resilience import notice

    notice.reset_injected()


def current() -> Optional[FaultPlan]:
    """The armed plan, picking up ``DWT_FAULT_PLAN`` once."""
    global _plan, _env_checked
    if not _env_checked:
        _env_checked = True
        _plan = FaultPlan.from_env()
    return _plan


def maybe_nan(state, metrics, lo: int, hi: Optional[int] = None) -> Tuple[Any, Any]:
    """Poison ``state``'s parameters (in place, on their device) and
    ``metrics`` with NaN if an armed step is in ``[lo, hi]``; returns
    ``(state, metrics)``.  The step's device-side ``finite`` flag is
    cleared too, as a real NaN would have cleared it."""
    plan = current()
    if plan is None or plan.nan_at_step is None:
        return state, metrics
    hi = lo if hi is None else hi
    steps = (plan.nan_at_step if isinstance(plan.nan_at_step, list)
             else [plan.nan_at_step])
    hit = [s for s in steps if lo <= s <= hi]
    if not hit:
        return state, metrics
    plan.nan_at_step = [s for s in steps if s not in hit] or None
    with torch.no_grad():
        for p in state.model.parameters():
            if p.is_floating_point():
                p.fill_(float("nan"))
    metrics = {k: (torch.full_like(v, float("nan"))
                   if torch.is_tensor(v) and v.is_floating_point() else v)
               for k, v in metrics.items()}
    if "finite" in metrics:
        metrics["finite"] = torch.zeros_like(metrics["finite"])
    return state, metrics


def maybe_crash_mid_save(step: int) -> None:
    """Raise :class:`SimulatedCrash` if armed for this save.  Fires once."""
    plan = current()
    if plan is None or plan.crash_in_save is None:
        return
    if plan.crash_in_save is True or int(plan.crash_in_save) == int(step):
        plan.crash_in_save = None
        raise SimulatedCrash(f"injected crash during checkpoint save @{step}")


def maybe_io_error(what: str = "save") -> None:
    """Raise ``OSError`` for the first ``io_error_saves`` write attempts."""
    plan = current()
    if plan is None or not plan.io_error_saves:
        return
    plan.io_error_saves -= 1
    raise OSError(f"injected I/O error during checkpoint {what}")


def at_step(lo: int, hi: Optional[int] = None) -> None:
    """Step-boundary control faults, in this order: slow, notice, SIGTERM,
    hang (a slow step finishes first, a notice is visible before the
    SIGTERM it warns of; the hang never returns)."""
    plan = current()
    if plan is None:
        return
    hi = lo if hi is None else hi
    if plan.slow_step_at is not None and lo <= plan.slow_step_at <= hi:
        plan.slow_step_at = None
        time.sleep(plan.slow_step_s)
    if plan.notice_at_step is not None and lo <= plan.notice_at_step <= hi:
        plan.notice_at_step = None
        from dwt_tpu_torch.resilience import notice

        notice.trigger_injected()
    if plan.sigterm_at_step is not None and lo <= plan.sigterm_at_step <= hi:
        plan.sigterm_at_step = None
        os.kill(os.getpid(), signal.SIGTERM)
    if plan.hang_at_step is not None and lo <= plan.hang_at_step <= hi:
        plan.hang_at_step = None
        while True:  # a wedged step polls no flag either
            time.sleep(60.0)


def maybe_kill_mid_delta_promote(step: int) -> None:
    """SIGKILL the process if armed for this delta promote (called after
    the staged chain validates, before the finalize rename)."""
    plan = current()
    if plan is None or plan.kill_mid_delta_promote is None:
        return
    if plan.kill_mid_delta_promote is True or (
            int(plan.kill_mid_delta_promote) == int(step)):
        plan.kill_mid_delta_promote = None
        os.kill(os.getpid(), signal.SIGKILL)


def maybe_missing_parent_blob(step: int, inherited_blobs: Any) -> None:
    """Delete one blob a delta ancestor wrote if armed for this save's
    step; raises when the save inherits none (the fault would be a no-op)."""
    plan = current()
    if plan is None or plan.missing_parent_blob is None:
        return
    if int(plan.missing_parent_blob) != int(step):
        return
    plan.missing_parent_blob = None
    for path in inherited_blobs:
        if os.path.exists(path):
            os.remove(path)
            return
    raise ValueError(
        f"{ENV_VAR}: missing_parent_blob armed at step {step}, but that save "
        "inherits no delta-ancestor blobs (a full save or a chain-base save) "
        "— the fault would be a silent no-op")


def wrap_dataset(dataset: Any, role: str) -> Any:
    """``dataset`` wrapped in :class:`FlakyDataset` when the plan condemns
    items of ``role`` (``source``/``target``) under any item kind."""
    plan = current()
    if plan is None:
        return dataset

    def _ids(table):
        ids = (table or {}).get(role)
        if isinstance(ids, int):
            ids = [ids]
        return tuple(int(i) for i in ids or ())

    corrupt = _ids(plan.corrupt_items)
    hang = _ids(plan.dead_worker_at)
    slow = _ids(plan.slow_item_at)
    if not (corrupt or hang or slow):
        return dataset
    return FlakyDataset(dataset, corrupt=corrupt, hang=hang, slow=slow,
                        slow_s=plan.slow_item_s)


class FlakyDataset:
    """Dataset wrapper whose chosen indices misbehave on access.

    ``fail={idx: n}`` raises ``OSError`` for the first ``n`` accesses;
    ``corrupt`` indices always raise; ``hang`` indices block forever on
    their first access (a lost worker); ``slow`` indices sleep ``slow_s``
    on their first access.  The access counts are lock-guarded: the hooks
    fire on concurrent pool workers.
    """

    def __init__(self, base, fail: Optional[Dict[int, int]] = None,
                 corrupt: Tuple[int, ...] = (), hang: Tuple[int, ...] = (),
                 slow: Tuple[int, ...] = (), slow_s: float = 1.0):
        self.base = base
        self.fail = dict(fail or {})
        self.corrupt = frozenset(corrupt)
        self.hang = frozenset(hang)
        self.slow = frozenset(slow)
        self.slow_s = float(slow_s)
        self._counts: Dict[int, int] = {}
        self._lock = threading.Lock()

    def __len__(self) -> int:
        return len(self.base)

    def __getitem__(self, i: int):
        i = int(i)
        if i in self.corrupt:
            raise OSError(f"injected corrupt item {i}")
        with self._lock:
            seen = self._counts.get(i, 0)
            self._counts[i] = seen + 1
        if seen < self.fail.get(i, 0):
            raise OSError(f"injected transient failure {i} (attempt {seen + 1})")
        if seen == 0 and i in self.hang:
            threading.Event().wait()  # a dead worker never comes back
        if seen == 0 and i in self.slow:
            time.sleep(self.slow_s)
        return self.base[i]


def maybe_shift_request(i: int, x: Any) -> Any:
    """Apply the armed ``serve_drift_shift`` to request ``i``'s payload.

    From ``at_request`` onward every input becomes ``x*scale + offset``
    — a synthetic target-domain shift.  Deliberately NOT one-shot: a
    domain shift is a new steady state, not an event, and the online
    adapter must keep seeing the shifted distribution until it adapts.
    Returns a shifted copy (never mutates the caller's array)."""
    plan = current()
    if plan is None or plan.serve_drift_shift is None:
        return x
    shift = plan.serve_drift_shift
    if int(i) < int(shift.get("at_request", 0)):
        return x
    import numpy as np

    x = np.asarray(x)
    return (x * float(shift.get("scale", 1.0))
            + float(shift.get("offset", 0.0))).astype(x.dtype)


def maybe_poison_request(i: int, x: Any) -> Any:
    """Replace request ``i``'s payload with garbage when armed.

    One-shot per armed index.  The poison cycles by index — ``i % 3``
    picks NaN, Inf, or an out-of-band magnitude (1e6) — so one composed
    plan exercises every branch of the serve-side sanitizer.  Values are
    written to a strided slice of a COPY: part of the row stays
    plausible, the way a half-corrupted payload looks in production.
    Compose with :func:`maybe_shift_request` drift-first (the world
    moved; the poison rides the drifted stream)."""
    plan = current()
    if plan is None or not plan.serve_poison_requests:
        return x
    if int(i) not in plan.serve_poison_requests:
        return x
    plan.serve_poison_requests = [
        r for r in plan.serve_poison_requests if r != int(i)
    ] or None
    import numpy as np

    x = np.array(x, copy=True)
    if not np.issubdtype(x.dtype, np.floating):
        x = x.astype(np.float32)
    val = (float("nan"), float("inf"), 1e6)[int(i) % 3]
    x.reshape(-1)[::3] = val
    return x
