"""Divergence guard: amortized finite checks with an escalation ladder — the port of ``dwt_tpu.resilience.guard`` in its unharvested mode.

A NaN from an ill-conditioned Cholesky at one whitened site poisons every
later step.  Checking every step from the host would stall the launch
queue, so the guard keeps device references to the newest loss and
gradient norm and reads back one boolean per ``interval`` steps
(``torch.isfinite(torch.stack(...)).all().item()``, the only sync it
adds).  NaN is absorbing, so the amortized check still catches any
divergence, at most ``interval - 1`` steps late.

Recovery is a ladder, mildest rung first:

* ``lr_backoff`` (optional, a factor in (0, 1)) — revert to the snapshot
  of the last passing check and scale every group's lr by the factor
  (``TrainState.lr_scale``); after ``backoff_recovery`` clean checks the
  scale returns to 1.0.  A divergence while backed off escalates.
* ``skip_step`` — revert to the snapshot and continue on fresh batches.
* ``rollback`` — raise :class:`RollbackRequest`; the loop restores the
  newest valid checkpoint and reseeds its data streams.
* ``halt`` — raise :class:`DivergenceError`.  ``rollback`` escalates here
  after ``max_rollbacks``.

The snapshot is a set of device copies of the parameters, the running
stats, the optimizer's buffers and ``lr_scale``, each keeping its
tensor's strides, refreshed in place at every passing check under
``torch.no_grad()``.  A revert copies them back into the live tensors
(``copy_``), so the optimizer's references stay valid, and clears each
site's cached eval matrix, as ``TrainState.load_state_dict`` does.

Harvested mode (``--harvest_depth > 0``, :meth:`DivergenceGuard.
enable_harvest`): the train step computes a device-side ``finite`` flag
and :class:`~dwt_tpu_torch.train.harvest.AsyncMetricHarvester` hands the
drained flags to :meth:`DivergenceGuard.observe_flags`, so the guard reads
no value back itself.  The verdict is stale by at most the ring's depth: a
NaN at step *s* is acted on at the boundary at *s + depth*.  A history of
``(step, snapshot)`` pairs keeps that safe: each passing boundary check
pushes one, and a bad flag for step *s* reverts to the newest snapshot
strictly older than *s* (one taken inside the undrained window may be
poisoned already).  The history holds at most ``depth + 2`` snapshots and
the harvester's deterministic floor prunes it toward two; each is a
device copy of the whole state, 189.8 MB for ResNet50-DWT with its SGD
momentum, so depth 2 holds up to ~760 MB of history on the card.

:meth:`DivergenceGuard.mirror_recovery` takes a remote rank's verdict: the
boundary consensus reports that another rank's guard fired while this
rank's metrics looked finite (a rank-local fault), and this rank takes
the same rung from the snapshot both hold — in harvested mode the history
reverted to the remote's bad step; in the synchronous mode the snapshot
before this boundary's refresh, which a guard built with
``keep_previous=True`` (multi-process runs) keeps beside the newest (a
second device copy of the state).
"""

from __future__ import annotations

import collections
from typing import Optional

import numpy as np
import torch

POLICIES = ("none", "halt", "skip_step", "rollback")


class DivergenceError(RuntimeError):
    """Non-finite loss/grad detected and the policy says stop."""


class RollbackRequest(Exception):
    """Control flow: restore the last valid checkpoint and retry.  Raised
    by :class:`DivergenceGuard`, caught by the loops."""

    def __init__(self, step: int, reason: str):
        super().__init__(reason)
        self.step = step
        self.reason = reason


class DivergenceGuard:
    def __init__(self, policy: str, interval: int, logger=None,
                 max_rollbacks: int = 3, lr_backoff: float = 0.0,
                 backoff_recovery: int = 3, keep_previous: bool = False):
        if policy not in POLICIES or policy == "none":
            raise ValueError(f"guard policy must be one of {POLICIES[1:]}; got {policy!r}")
        if lr_backoff and not (0.0 < lr_backoff < 1.0):
            raise ValueError("guard lr_backoff must be a scale factor in (0, 1) "
                             f"(0 disables the rung); got {lr_backoff!r}")
        self.policy = policy
        self.interval = max(1, int(interval))
        self.max_rollbacks = max_rollbacks
        self.rollbacks = 0
        self.lr_backoff = float(lr_backoff or 0.0)
        self.backoff_recovery = max(1, int(backoff_recovery))
        self.backoffs = 0  # lifetime count of rung-1 engagements
        self.recoveries = 0  # in-memory recoveries (lr_backoff + skip_step)
        self.checks = 0  # host readbacks (one each)
        self._scale = 1.0
        self._clean_checks = 0
        self._logger = logger  # logger(kind, step, **fields)
        self._since_check = 0
        self._good = None  # StateSnapshot of the last passing check
        # The synchronous mode's snapshot before the newest refresh
        # (keep_previous: mirror_recovery's target), double-buffered.
        self.keep_previous = bool(keep_previous)
        self._prev_good = None
        # The newest backoff episode as [engage step, recover step or None]:
        # a strike at a step inside it escalates, as the JAX guard's (under
        # harvested verdicts a strike's flag can drain after the scale
        # recovered).
        self._backoff_span: Optional[list] = None
        # Harvested mode (enable_harvest): the (step, snapshot) history, the
        # earliest observed bad step not yet acted on, and the harvester's
        # prune floor.  None: the synchronous mode.
        self._snaps: Optional[collections.deque] = None
        self._pending_bad: Optional[int] = None
        self._floor_fn = None
        self.harvest_depth = 0
        self.last_bad_step = -1  # the bad step of the newest harvested verdict

    @property
    def _keeps_good(self) -> bool:
        # The backoff rung reverts too (NaN is absorbing), even under halt.
        return self.policy in ("skip_step", "rollback") or self.lr_backoff > 0

    def _finite(self, metrics) -> bool:
        """The one host sync: are the loss and the gradient norm finite
        (scalars, or a chunk's ``[n]`` of them)."""
        self.checks += 1
        loss = metrics["loss"]
        gn = metrics.get("grad_norm", loss)
        return bool(torch.isfinite(torch.cat([loss.detach().float().reshape(-1),
                                              gn.detach().float().reshape(-1)]))
                    .all().item())

    def _log(self, kind: str, step: int, **values) -> None:
        if self._logger is not None:
            self._logger(kind, step, **values)

    def _snapshot(self, state) -> None:
        from dwt_tpu_torch.resilience.coord import assert_not_writer_thread

        assert_not_writer_thread("guard snapshot")
        # Harvested mode keeps every snapshot of its history as it is; the
        # synchronous mode refreshes its one snapshot in place (with
        # keep_previous, the older of two, so the newest survives it).
        if self._snaps is not None:
            self._good = state.snapshot()
        elif self.keep_previous:
            self._prev_good, self._good = self._good, state.snapshot(self._prev_good)
        else:
            self._good = state.snapshot(self._good)

    def _revert(self, state, scale: float):
        """The last good state, in place, at backoff ``scale``."""
        state.load_state_dict(self._good.payload)
        return self._set_scale(state, scale)

    def _set_scale(self, state, scale: float):
        self._scale = float(scale)
        state.lr_scale = self._scale
        return state

    # ------------------------------------------------------------------ API

    def prime(self, state) -> None:
        """Record the initial known-good state (before training, after a
        resume or a rollback's restore)."""
        if self._keeps_good:
            self._snapshot(state)
            if self._snaps is not None:
                # After a rollback's restore the history restarts at the
                # restored state, and a verdict observed but not acted on
                # belongs to the poisoned trajectory.
                self._snaps.clear()
                self._snaps.append((int(state.step), self._good))
                self._pending_bad = None
                # The replay's steps rewind below the old episode's bounds.
                self._backoff_span = [int(state.step), None] if self.in_backoff else None

    def enable_harvest(self, depth: int, start_step: int, floor_fn=None) -> None:
        """Switch to harvested-flag verdicts (module docstring).  ``depth``
        bounds the history: between two drains at most ``depth`` boundaries
        pass, so ``depth + 2`` snapshots always hold one strictly older than
        any bad step still in flight.  ``floor_fn`` (the harvester's
        ``pending_floor``) prunes it toward two.  Call after
        :meth:`prime`."""
        self.harvest_depth = max(1, int(depth))
        self._snaps = collections.deque()
        self._pending_bad = None
        self._floor_fn = floor_fn
        if self._good is not None:
            self._snaps.append((int(start_step), self._good))

    @property
    def harvest_enabled(self) -> bool:
        return self._snaps is not None

    @property
    def good_state(self):
        """The last known-good snapshot (None before :meth:`prime`)."""
        return self._good

    @property
    def has_good_state(self) -> bool:
        return self._good is not None

    @property
    def in_backoff(self) -> bool:
        return self._scale != 1.0

    def reapply_backoff(self, state):
        """Re-impose the current backoff scale on a state restored from
        disk, so the replayed segment trains gently too."""
        if not self.in_backoff:
            return state
        self._clean_checks = 0
        return self._set_scale(state, self._scale)

    def restore_good(self, state):
        """The rollback's last resort: the in-memory good state, in place."""
        return self._revert(state, self._good.payload["lr_scale"])

    def step(self, state, metrics, n_steps: int, step_no: int):
        """Account ``n_steps`` finished steps whose newest metrics are
        ``metrics`` (device tensors); check when due.  Returns the state to
        continue from (reverted in place by ``lr_backoff``/``skip_step``)."""
        self._since_check += n_steps
        if self._since_check < self.interval:
            return state
        self._since_check = 0
        if self._finite(metrics):
            if self.in_backoff:
                self._clean_checks += 1
                if self._clean_checks >= self.backoff_recovery:
                    state = self._set_scale(state, 1.0)
                    if self._backoff_span is not None:
                        self._backoff_span[1] = int(step_no)
                    self._log("lr_recover", step_no, scale=1.0,
                              clean_checks=self._clean_checks)
            if self._keeps_good:
                self._snapshot(state)
            return state
        return self._diverged(state, step_no)

    # -------------------------------------------------- harvested verdicts

    def observe_flags(self, lo: int, hi: int, flags) -> None:
        """Record the drained finite verdict of steps ``[lo, hi]`` (a host
        bool, or ``[n]`` of them on the chunked path).  Bookkeeping only:
        the rung fires at the next boundary (:meth:`check_harvested`)."""
        arr = np.atleast_1d(np.asarray(flags)).astype(bool)
        if bool(arr.all()):
            return
        bad = int(lo) + int(np.argmax(~arr))  # the first non-finite step
        if self._pending_bad is None or bad < self._pending_bad:
            self._pending_bad = bad

    def check_harvested(self, state, n_steps: int, step_no: int):
        """The harvested boundary check: act on an observed bad flag at
        once (detection lags the ring, not the interval); otherwise the
        interval's bookkeeping as :meth:`step` does (the backoff's
        recovery, a snapshot pushed on the history)."""
        if self._pending_bad is not None:
            bad, self._pending_bad = self._pending_bad, None
            self.last_bad_step = bad
            self._revert_history_to(bad)
            return self._diverged(state, bad, detected_at=step_no)
        self._since_check += n_steps
        if self._since_check < self.interval:
            return state
        self._since_check = 0
        if self.in_backoff:
            self._clean_checks += 1
            if self._clean_checks >= self.backoff_recovery:
                state = self._set_scale(state, 1.0)
                if self._backoff_span is not None:
                    self._backoff_span[1] = int(step_no)
                self._log("lr_recover", step_no, scale=1.0,
                          clean_checks=self._clean_checks)
        if self._keeps_good:
            self._snapshot(state)
            self._snaps.append((int(step_no), self._good))
            while len(self._snaps) > self.harvest_depth + 2:
                self._snaps.popleft()
            self._prune_history()
        return state

    def _prune_history(self) -> None:
        """Drop what no future bad step can need: a pending flag covers no
        step below ``floor_fn()``, so only the newest snapshot strictly
        below that floor and the newer ones stay."""
        if self._floor_fn is None:
            return
        floor = self._floor_fn()
        if floor is None:
            return
        while len(self._snaps) >= 2 and self._snaps[1][0] < floor:
            self._snaps.popleft()

    def _revert_history_to(self, bad_step: int) -> None:
        """Discard the snapshots taken at or after ``bad_step`` (poisoned:
        NaN is absorbing); the oldest always stays, it predates every flag
        in flight by the history's bound."""
        if self._snaps is None:
            return
        while len(self._snaps) > 1 and self._snaps[-1][0] >= bad_step:
            self._snaps.pop()
        self._good = self._snaps[-1][1]

    def mirror_recovery(self, state, step_no: int, bad_step: int = -1):
        """Take the rung a remote rank's guard took, without a local
        verdict (module docstring): revert the snapshots this rank took
        that the firing rank did not — in harvested mode those at or after
        the remote's ``bad_step`` (else this boundary's refresh), in the
        synchronous mode this boundary's refresh — then act as
        :meth:`step` does on a divergence (it may raise, as there)."""
        if self._snaps is not None:
            if bad_step >= 0:
                self._revert_history_to(bad_step)
            elif len(self._snaps) > 1:
                self._snaps.pop()
                self._good = self._snaps[-1][1]
        elif self._prev_good is not None:
            self._good, self._prev_good = self._prev_good, None
        elif self._keeps_good and not self.keep_previous:
            raise RuntimeError("mirror_recovery in the synchronous mode needs a "
                               "guard built with keep_previous=True")
        return self._diverged(state, step_no)

    def _diverged(self, state, step_no: int, detected_at: Optional[int] = None):
        # Harvested mode: the verdict for step_no acted on at a later
        # boundary, the staleness the depth bounds.
        self._log("divergence", step_no, policy=self.policy, scale=self._scale,
                  **({} if detected_at is None else {"detected_at": detected_at}))
        span = self._backoff_span
        struck_backed_off = self.in_backoff or (
            span is not None and span[0] < step_no
            and (span[1] is None or step_no <= span[1]))
        if self.lr_backoff and not struck_backed_off and self._good is not None:
            self.backoffs += 1
            self.recoveries += 1
            self._clean_checks = 0
            self._backoff_span = [int(step_no), None]
            state = self._revert(state, self.lr_backoff)
            self._log("lr_backoff", step_no, scale=self.lr_backoff, backoffs=self.backoffs)
            return state
        if self.policy == "skip_step" and self._good is not None:
            self._log("skip_step", step_no)
            self.recoveries += 1
            self._clean_checks = 0  # a backed-off skip re-earns recovery
            # The snapshot predates the backoff's engagement: keep the scale.
            return self._revert(state, self._scale)
        if self.policy == "rollback":
            if self.rollbacks >= self.max_rollbacks:
                raise DivergenceError(
                    f"non-finite loss/grad at step {step_no}; "
                    f"{self.rollbacks} rollbacks already spent — halting")
            self.rollbacks += 1
            raise RollbackRequest(step_no, f"non-finite loss/grad at step {step_no}")
        raise DivergenceError(
            f"non-finite loss/grad at step {step_no} (policy={self.policy})")
