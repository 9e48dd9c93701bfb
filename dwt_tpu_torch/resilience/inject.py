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
* ``maybe_kill_writer_mid_shard(step)`` — called by ``save_host_shard``
  between the leaf bytes and the shard manifest of a multi-process save;
  SIGKILLs the process, a rank dying mid-shard-write (promotion must
  refuse the torn shard; the previous finalized step stays
  authoritative).
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
* the fleet kinds: ``traffic_spike()`` — the load generator
  (``tools/torch_serve_bench.py``) divides its Poisson gaps by ``factor``
  from request ``at_request`` on (persistent: a demand step is the new
  steady state); ``take_replica_slow(rid)`` yields, once, the
  ``DWT_FAULT_PLAN`` the fleet puts in replica ``rid``'s spawn
  environment, and inside that replica ``maybe_replica_slow()`` sleeps
  the dispatcher ``sleep_s`` per batch — a straggler that answers probes
  and serves slowly, so the weighted router, not the prober, must starve
  it.
* the sweep kinds, which the sweep supervisor (``dwt_tpu_torch.sweep``)
  consults: ``maybe_kill_supervisor_at_schedule(event)`` SIGKILLs the
  supervisor inside its Nth scheduling event, after the journal records
  the spawn and before it happens; ``take_sweep_preempt(tag)`` says, once
  per armed pair tag, to preempt that pair's running job (notice file,
  then SIGTERM); ``take_sweep_job_fault(tag)`` yields, once per armed tag,
  the ``DWT_FAULT_PLAN`` the supervisor puts in that pair's next spawn
  environment (``kill_mid_delta_promote``: the job dies inside a save).

All hooks are no-ops (one ``is None`` check) unless a plan is armed.  Arm
with :func:`arm`, or through the ``DWT_FAULT_PLAN`` environment variable
(JSON, read once at first use) — the scheduler-facing contract both
packages share.  Every fault fires at most once per arm (each element of a
burst once).
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

ENV_VAR = "DWT_FAULT_PLAN"

# Kinds of the JAX package's plans that the port does not inject yet, with
# the ROADMAP queue 1 item that takes each (none since the host-shard
# writer landed; a plan naming one would raise rather than inject nothing).
UNPORTED_KINDS: Dict[str, str] = {}


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


def _tag_list(spec: dict, field: str) -> Optional[List[str]]:
    """A validated pair-tag list spec (a scalar string allowed)."""
    value = spec.get(field)
    if value is None:
        return None
    items = value if isinstance(value, list) else [value]
    if not items:
        raise ValueError(f"{ENV_VAR}: {field} must name at least one pair tag "
                         "— an empty list injects nothing")
    tags = []
    for v in items:
        if not isinstance(v, str) or not v:
            raise ValueError(f"{ENV_VAR}: {field} entries must be non-empty "
                             f"pair tags like 'Art2Clipart'; got {v!r}")
        tags.append(v)
    if len(set(tags)) != len(tags):
        raise ValueError(f"{ENV_VAR}: duplicate tags in {field}: {tags}")
    return tags


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


def _traffic_spike(spike: Any) -> Optional[Dict[str, Any]]:
    """Validate a ``traffic_spike`` spec (the JAX plan's messages)."""
    if spike is None:
        return None
    if not isinstance(spike, dict):
        raise ValueError(
            f"{ENV_VAR}: traffic_spike must be an object like "
            '{"at_request": N, "factor": f}; '
            f"got {spike!r}")
    bad_keys = sorted(set(spike) - {"at_request", "factor"})
    if bad_keys:
        raise ValueError(
            f"{ENV_VAR}: unknown traffic_spike key(s) {bad_keys}; "
            "valid: ['at_request', 'factor']")
    at = spike.get("at_request", 0)
    if isinstance(at, bool) or not isinstance(at, int) or at < 0:
        raise ValueError(
            f"{ENV_VAR}: traffic_spike.at_request must be a "
            f"0-based request index >= 0; got {at!r}")
    factor = spike.get("factor")
    if isinstance(factor, bool) or not isinstance(
            factor, (int, float)) or not math.isfinite(factor) or factor <= 0:
        raise ValueError(
            f"{ENV_VAR}: traffic_spike.factor must be a finite "
            f"number > 0; got {factor!r}")
    if float(factor) == 1.0:
        raise ValueError(
            f"{ENV_VAR}: traffic_spike with factor=1 is the "
            "identity — a rate step that steps nowhere proves nothing")
    return {"at_request": at, "factor": float(factor)}


def _replica_slow(slow: Any) -> Optional[Dict[str, Any]]:
    """Validate a ``replica_slow_at`` spec (the JAX plan's messages)."""
    if slow is None:
        return None
    if not isinstance(slow, dict):
        raise ValueError(
            f"{ENV_VAR}: replica_slow_at must be an object like "
            '{"rid": R, "sleep_s": s}; '
            f"got {slow!r}")
    bad_keys = sorted(set(slow) - {"rid", "sleep_s"})
    if bad_keys:
        raise ValueError(
            f"{ENV_VAR}: unknown replica_slow_at key(s) "
            f"{bad_keys}; valid: ['rid', 'sleep_s']")
    rid = slow.get("rid")
    if isinstance(rid, bool) or not isinstance(rid, int) or rid < 0:
        raise ValueError(
            f"{ENV_VAR}: replica_slow_at.rid must be a replica "
            f"id >= 0; got {rid!r}")
    sleep_s = slow.get("sleep_s")
    if isinstance(sleep_s, bool) or not isinstance(
            sleep_s, (int, float)) or not math.isfinite(sleep_s) or sleep_s <= 0:
        raise ValueError(
            f"{ENV_VAR}: replica_slow_at.sleep_s must be a finite "
            f"number > 0 (a zero-second straggler is a silent "
            f"no-op); got {sleep_s!r}")
    return {"rid": rid, "sleep_s": float(sleep_s)}


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
    kill_writer_mid_shard: Any = None  # True = next shard write; int = that step
    missing_parent_blob: Optional[int] = None
    # The sweep supervisor's kinds: SIGKILL the supervisor inside its Nth
    # scheduling event (1-based), between the journal write and the spawn;
    # the pair tags preempted (notice, then SIGTERM) the first time each is
    # seen running; the pair tags whose first spawn dies inside a save.
    kill_supervisor_at_schedule: Optional[int] = None
    sweep_preempt_pairs: Optional[List[str]] = None
    sweep_job_kill_mid_save: Optional[List[str]] = None
    # 0-based request indices whose payload becomes garbage (NaN / Inf /
    # out-of-band magnitude, cycling by index); one-shot per index.
    serve_poison_requests: Optional[List[int]] = None
    # {"at_request": N, "offset": f, "scale": f}: from request N on, inputs
    # become x*scale + offset.  Persistent, not one-shot.
    serve_drift_shift: Optional[Dict[str, Any]] = None
    # {"at_request": N, "factor": f}: from request N on, the load
    # generator's Poisson gaps divide by f.  Persistent, not one-shot.
    traffic_spike: Optional[Dict[str, Any]] = None
    # {"rid": R, "sleep_s": s}: replica R's dispatcher sleeps s per batch.
    # The fleet takes it once, at R's spawn (a respawn runs clean); inside
    # the replica the sleep is persistent.
    replica_slow_at: Optional[Dict[str, Any]] = None

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
            traffic_spike=_traffic_spike(spec.get("traffic_spike")),
            replica_slow_at=_replica_slow(spec.get("replica_slow_at")),
            nan_at_step=nan, crash_in_save=crash, hang_at_step=hang,
            slow_step_at=slow, slow_step_s=slow_s, sigterm_at_step=sigterm,
            io_error_saves=io_saves,
            corrupt_items=_role_items(spec, "corrupt_items"),
            dead_worker_at=_role_items(spec, "dead_worker_at"),
            slow_item_at=slow_item, slow_item_s=slow_item_s,
            notice_at_step=notice,
            kill_mid_delta_promote=_true_or_step(spec, "kill_mid_delta_promote"),
            kill_writer_mid_shard=_true_or_step(spec, "kill_writer_mid_shard"),
            missing_parent_blob=_opt_int(spec, "missing_parent_blob"),
            kill_supervisor_at_schedule=_opt_int(spec, "kill_supervisor_at_schedule"),
            sweep_preempt_pairs=_tag_list(spec, "sweep_preempt_pairs"),
            sweep_job_kill_mid_save=_tag_list(spec, "sweep_job_kill_mid_save"),
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
    import torch

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


def maybe_kill_writer_mid_shard(step: int) -> None:
    """SIGKILL the process if armed for this shard write (called after the
    leaf bytes, before the shard manifest): a real kill, which the writer
    thread cannot catch — the rank dies mid-write."""
    plan = current()
    if plan is None or plan.kill_writer_mid_shard is None:
        return
    if plan.kill_writer_mid_shard is True or (
            int(plan.kill_writer_mid_shard) == int(step)):
        plan.kill_writer_mid_shard = None
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


def traffic_spike() -> Optional[Dict[str, Any]]:
    """The armed ``traffic_spike`` spec, or None: the load generator
    divides its Poisson gaps by ``factor`` from request ``at_request`` on.
    Persistent (not one-shot): a demand step is the new steady state."""
    plan = current()
    if plan is None:
        return None
    return plan.traffic_spike


def take_replica_slow(rid: int) -> Optional[Dict[str, Any]]:
    """The fault plan (a ``DWT_FAULT_PLAN`` object) the fleet puts in
    replica ``rid``'s spawn environment, or None.  One-shot per arm: a
    respawn of the straggler runs clean, so what a test proves is the
    router starving the straggler, not the prober reaping it."""
    plan = current()
    if plan is None or not plan.replica_slow_at:
        return None
    if int(plan.replica_slow_at["rid"]) != int(rid):
        return None
    spec = dict(plan.replica_slow_at)
    plan.replica_slow_at = None
    return {"replica_slow_at": spec}


def maybe_replica_slow() -> None:
    """Sleep the armed ``replica_slow_at.sleep_s`` once per call.  The
    serve dispatcher calls it at the top of every batch; inside a replica
    the plan arrives through its own environment (the fleet matched the
    rid), so the sleep is unconditional while armed."""
    plan = current()
    if plan is None or not plan.replica_slow_at:
        return
    time.sleep(float(plan.replica_slow_at["sleep_s"]))


def maybe_kill_supervisor_at_schedule(event: int) -> None:
    """SIGKILL the sweep supervisor if armed for its ``event``-th scheduling
    event (1-based).  Called between the journal update that records the
    pair as scheduled and the job's spawn — the ordering that leaves the
    journal claiming a job that never started: the relaunched supervisor
    must reschedule it, not wait on a ghost."""
    plan = current()
    if plan is None or plan.kill_supervisor_at_schedule is None:
        return
    if int(plan.kill_supervisor_at_schedule) == int(event):
        plan.kill_supervisor_at_schedule = None
        os.kill(os.getpid(), signal.SIGKILL)


def take_sweep_preempt(tag: str) -> bool:
    """True (once per tag) when the supervisor should preempt the running
    job of ``tag``: its notice file, then a SIGTERM on the next poll — the
    scheduler reclaiming a slot."""
    plan = current()
    if plan is None or not plan.sweep_preempt_pairs:
        return False
    if tag not in plan.sweep_preempt_pairs:
        return False
    plan.sweep_preempt_pairs = [t for t in plan.sweep_preempt_pairs if t != tag] or None
    return True


def take_sweep_job_fault(tag: str) -> Optional[Dict[str, Any]]:
    """The fault plan (a ``DWT_FAULT_PLAN`` object) the supervisor puts in
    ``tag``'s next spawn environment, or None.  One-shot per tag: the
    respawn of a job killed inside a save runs clean, so what a test proves
    is the resume, not the quarantine budget."""
    plan = current()
    if plan is None or not plan.sweep_job_kill_mid_save:
        return None
    if tag not in plan.sweep_job_kill_mid_save:
        return None
    plan.sweep_job_kill_mid_save = [
        t for t in plan.sweep_job_kill_mid_save if t != tag] or None
    return {"kill_mid_delta_promote": True}
