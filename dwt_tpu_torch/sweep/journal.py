"""Atomic journaled sweep manifest — the supervisor's crash survival; the port of ``dwt_tpu.sweep.journal``, every name kept.

One JSON file (``<sweep_root>/sweep.json``) records, per pair: status
(``pending`` → ``running`` → ``done`` | ``quarantined``), run dir, pid,
crash/attempt counts, resume step, accuracy.  Every mutation rewrites
the file atomically (tmp + fsync + rename — the same finalize contract
as every checkpoint artifact), so a SIGKILLed supervisor's relaunch
reads a consistent snapshot of its predecessor's last decision, never a
torn one.

The journal is written BEFORE the action it describes (a pair is marked
``running`` before its subprocess spawns): the failure mode that leaves
a journal claiming a job that never started is recoverable (the
relaunch sees no live pid and reschedules), while the inverse — a live
job no journal entry claims — would leak a training process forever.

:func:`decide_adoption` is the relaunch policy: a ``running`` entry is
adopted only when its recorded pid is alive AND the process's command
line still carries the run-dir token (pid reuse across a reboot must
not adopt an innocent bystander); anything else reschedules.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Callable, Dict, List, Optional, Tuple

log = logging.getLogger(__name__)

JOURNAL_NAME = "sweep.json"

# Pair lifecycle states.  "running" covers journal-before-spawn too —
# an entry with pid None is a schedule the supervisor died inside.
PENDING = "pending"
RUNNING = "running"
DONE = "done"
QUARANTINED = "quarantined"


def _fresh_entry(source: str, target: str, tag: str, run_dir: str) -> dict:
    return {
        "source": source,
        "target": target,
        "tag": tag,
        "status": PENDING,
        "run_dir": run_dir,
        "pid": None,
        "attempts": 0,     # subprocess spawns, preemption resumes included
        "crashes": 0,      # budget-charged failures (quarantine counts these)
        "preempts": 0,     # save-and-exit-0 reschedules (never charged)
        # `preempt` records in the pair's metrics JSONL at last spawn:
        # the baseline that tells a NEW preemption (this attempt parked;
        # its partial result must not read as final) from an old one.
        # Journaled so a relaunched supervisor classifies correctly.
        "preempt_baseline": 0,
        "resume_step": None,
        "accuracy": None,
        "reason": None,    # quarantine reason / last crash diagnosis
    }


class SweepJournal:
    """The sweep's single source of scheduling truth (module doc)."""

    def __init__(self, path: str):
        self.path = os.path.abspath(path)
        self.pairs: Dict[str, dict] = {}

    @classmethod
    def load(cls, path: str) -> "SweepJournal":
        """Read an existing journal (a relaunch), or start empty."""
        j = cls(path)
        try:
            with open(j.path) as f:
                payload = json.load(f)
        except FileNotFoundError:
            return j
        except (OSError, ValueError) as e:
            # A torn journal is impossible under the atomic-rename write
            # (either the old or the new version is read whole); an
            # unreadable one means something else owns this path —
            # refuse to silently restart the matrix over it.
            raise RuntimeError(
                f"sweep journal {j.path} exists but cannot be read ({e}); "
                "refusing to overwrite — move it aside to restart the "
                "sweep from scratch"
            ) from e
        j.pairs = dict(payload.get("pairs", {}))
        return j

    def ensure_pairs(
        self, pairs: List[Tuple[str, str]],
        run_dir_fn: Callable[[str], str],
    ) -> None:
        """Add journal entries for pairs not yet present (first launch
        adds all; a relaunch adds none) and verify a relaunch's plan
        matches the journal — silently running a DIFFERENT matrix over
        an old journal would report the old pairs as already done."""
        want = {f"{s}2{t}": (s, t) for s, t in pairs}
        stale = sorted(set(self.pairs) - set(want))
        if stale:
            raise RuntimeError(
                f"sweep journal {self.path} tracks pair(s) {stale} not in "
                "this invocation's matrix — same sweep_root, different "
                "--pairs?  Use a fresh sweep_root per matrix."
            )
        changed = False
        for tag, (s, t) in want.items():
            if tag not in self.pairs:
                self.pairs[tag] = _fresh_entry(s, t, tag, run_dir_fn(tag))
                changed = True
        if changed:
            self.save()

    def update(self, tag: str, **fields) -> dict:
        """Merge ``fields`` into the pair's entry and persist atomically.
        Unknown tags raise — a typo'd update would otherwise invent a
        pair the scheduler never runs."""
        entry = self.pairs[tag]
        entry.update(fields)
        self.save()
        return entry

    def save(self) -> None:
        payload = {"kind": "sweep_journal", "pairs": self.pairs}
        tmp = f"{self.path}.tmp-{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(payload, f, indent=1)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path)

    # ---------------------------------------------------------- queries

    def by_status(self, status: str) -> List[dict]:
        return [e for e in self.pairs.values() if e["status"] == status]

    def all_settled(self) -> bool:
        return all(
            e["status"] in (DONE, QUARANTINED) for e in self.pairs.values()
        )


# -------------------------------------------------------- relaunch policy


def job_process_alive(pid: Optional[int],
                      token: Optional[str] = None) -> bool:
    """True when ``pid`` is a live process AND (when ``token`` is given)
    its command line contains the token — the run-dir path makes a good
    token: unique per pair, present verbatim in the job's argv.  The
    cmdline check defeats pid reuse: a recycled pid belonging to some
    unrelated process must read as 'job gone', not 'job adopted'."""
    if not pid:
        return False
    try:
        os.kill(int(pid), 0)
    except (OSError, ValueError):
        return False
    if token is None:
        return True
    try:
        with open(f"/proc/{int(pid)}/cmdline", "rb") as f:
            cmdline = f.read().decode("utf-8", "replace")
    except OSError:
        # No /proc (non-Linux): the liveness check above is all we have.
        return True
    return token in cmdline


def decide_adoption(
    entry: dict,
    alive: Callable[[Optional[int], Optional[str]], bool] = job_process_alive,
) -> str:
    """Relaunch policy for one journal entry: ``"adopt"`` (a live job
    this supervisor should monitor rather than respawn), ``"reschedule"``
    (run it again — resume comes free from the run dir's checkpoints),
    or ``"keep"`` (nothing to do: pending/done/quarantined entries).

    Only ``running`` entries are interesting: pid recorded and alive
    with the run-dir token on its cmdline → adopt; pid dead, recycled,
    or never recorded (the supervisor died between the journal write
    and the spawn) → reschedule.
    """
    if entry["status"] != RUNNING:
        return "keep"
    if alive(entry.get("pid"), entry.get("run_dir")):
        return "adopt"
    return "reschedule"
