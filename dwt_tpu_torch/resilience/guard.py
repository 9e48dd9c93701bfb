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

This is the JAX package's ``--harvest_depth 0`` guard.  The harvested mode
(``observe_flags``, ``check_harvested``: verdicts from the step's drained
``finite`` flags, no sync of the guard's own, detection at *s + depth*)
waits for ``train/harvest.py`` (ROADMAP queue 1 item 4).
"""

from __future__ import annotations

from typing import Optional

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
                 backoff_recovery: int = 3):
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
        # The newest backoff episode as [engage step, recover step or None]:
        # a strike at a step inside it escalates, as the JAX guard's.
        self._backoff_span: Optional[list] = None

    @property
    def _keeps_good(self) -> bool:
        # The backoff rung reverts too (NaN is absorbing), even under halt.
        return self.policy in ("skip_step", "rollback") or self.lr_backoff > 0

    def _finite(self, metrics) -> bool:
        """The one host sync: are the loss and the gradient norm finite."""
        self.checks += 1
        loss = metrics["loss"]
        gn = metrics.get("grad_norm", loss)
        return bool(torch.isfinite(torch.stack([loss.detach().float().reshape(()),
                                                gn.detach().float().reshape(())]))
                    .all().item())

    def _log(self, kind: str, step: int, **values) -> None:
        if self._logger is not None:
            self._logger(kind, step, **values)

    def _snapshot(self, state) -> None:
        from dwt_tpu_torch.resilience.coord import assert_not_writer_thread

        assert_not_writer_thread("guard snapshot")
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

    def _diverged(self, state, step_no: int):
        self._log("divergence", step_no, policy=self.policy, scale=self._scale)
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
