"""Per-slot respawn budgeting — the port of ``dwt_tpu.fleet.retry``: the
fleet's retry arithmetic, factored out of
:class:`~dwt_tpu_torch.fleet.balancer.Respawner` so that a sweep control
plane can apply the SAME policy to training job slots that the serving
fleet applies to HTTP replica slots:

* each key (a replica id, a sweep pair tag) gets a bounded attempt
  budget — a crash-looping artifact must not burn CPU forever;
* attempts back off exponentially (``backoff_s × 2^(attempts-1)``), so
  a slot that dies on arrival retries gently;
* exhaustion is sticky and reported once (the caller logs/quarantines).

Pure accounting: no threads, no processes.  The caller owns the spawn
itself and the decision of WHAT counts as a failed attempt (the fleet
counts every respawn; the sweep counts crashes but not preemptions —
a preempted job's reschedule calls :meth:`reset_backoff`-free
:meth:`begin` with ``count=False``).  ``clock`` is injectable so unit
tests drive the backoff deterministically.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Hashable, List


class RespawnBudget:
    """Bounded-attempt, exponential-backoff accounting per key."""

    def __init__(self, max_attempts: int, backoff_s: float = 1.0,
                 clock: Callable[[], float] = time.monotonic):
        self.max_attempts = int(max_attempts)
        self.backoff_s = float(backoff_s)
        self._clock = clock
        self._attempts: Dict[Hashable, int] = {}
        self._next_due: Dict[Hashable, float] = {}
        self._exhausted_seen: set = set()

    def attempts(self, key: Hashable) -> int:
        return self._attempts.get(key, 0)

    def exhausted(self, key: Hashable) -> bool:
        return self._attempts.get(key, 0) >= self.max_attempts

    def exhausted_first_time(self, key: Hashable) -> bool:
        """True exactly once per exhausted key — the caller's log/
        quarantine guard (repeat polls must not re-announce it)."""
        if not self.exhausted(key) or key in self._exhausted_seen:
            return False
        self._exhausted_seen.add(key)
        return True

    def ready(self, key: Hashable) -> bool:
        """Budget left AND the backoff window has elapsed."""
        if self.exhausted(key):
            return False
        return self._clock() >= self._next_due.get(key, 0.0)

    def begin(self, key: Hashable, count: bool = True) -> int:
        """Record the start of an attempt; returns the attempt number
        (1-based).  ``count=False`` starts the attempt WITHOUT charging
        the budget or arming backoff — the sweep's preemption path: a
        preempted job did nothing wrong, its resume reschedules free.
        """
        attempts = self._attempts.get(key, 0)
        if not count:
            return attempts + 1
        self._attempts[key] = attempts + 1
        self._next_due[key] = (
            self._clock() + self.backoff_s * (2 ** attempts)
        )
        return attempts + 1

    def exhausted_keys(self) -> List[Hashable]:
        """Every key whose budget is spent — the autoscaler's crash-loop
        guard: while any replica slot is exhausted, extra capacity is a
        config problem wearing a load costume, and scale-up is refused."""
        return [k for k, n in self._attempts.items()
                if n >= self.max_attempts]

    def forgive(self, key: Hashable) -> None:
        """Refund one attempt after a demonstrated success (a scaled-up
        replica that reached healthy).  Keeps the budget a *crash* budget:
        sustained legitimate growth never exhausts it, a crash loop —
        where no attempt is ever forgiven — still does."""
        n = self._attempts.get(key, 0)
        if n > 0:
            self._attempts[key] = n - 1
            self._exhausted_seen.discard(key)

    def restore(self, key: Hashable, attempts: int) -> None:
        """Seed a key's attempt count (a relaunched supervisor adopting
        its journal's recorded history — backoff restarts fresh; the
        dead supervisor's wall-clock is gone anyway)."""
        self._attempts[key] = int(attempts)
