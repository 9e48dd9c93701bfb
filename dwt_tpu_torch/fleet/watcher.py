"""Checkpoint watcher: candidate-version events off the ranked walk.

The port of ``dwt_tpu.fleet.watcher``, over the port's own ranked walk
(``dwt_tpu_torch.utils.checkpoint.ranked_checkpoints``).

The training loop's save path already guarantees that a checkpoint
directory is either finalized-and-valid or invisible (``.tmp-*`` writes
+ atomic rename + manifest/size validation — ``utils.checkpoint``).  The
watcher therefore needs no coordination with the writer at all: polling
:func:`~dwt_tpu_torch.utils.checkpoint.ranked_checkpoints` sees exactly the
finalized steps, in every on-disk format the port reads (its own full
and delta saves, the JAX package's host-shard and delta saves), with
unpromoted and torn writes excluded by construction —
a ``cas_delta`` step is a candidate only once its whole
parent chain and every referenced blob validate, so the fleet can never
deploy a delta the restore walk would refuse.  A candidate event is
"the newest valid step changed": step + manifest params digest (the
delta manifests record the same whole-params digest), which together
are the version identity the whole fleet speaks — the dedup key is
unchanged, and a delta save whose digest moved IS a new candidate
(:class:`~dwt_tpu_torch.serve.engine.Version`).

One deviation from the JAX watcher: a same-step re-save (the trainer's
post-collection save over its last periodic one) moves the finalized step
aside for a moment (``utils.checkpoint._finalize_rename``), and a poll in
that window sees the step before it as the newest.  The JAX watcher emits
that older step at once, and its reloader deploys it and then the re-saved
step again.  Here a candidate older than the last one emitted is emitted
only when the next poll sees it newest too: a step an operator deleted is
still rolled back to, one poll later.
"""

from __future__ import annotations

import logging
import os
import threading
from dataclasses import dataclass
from typing import Callable, Optional

from dwt_tpu_torch.utils.checkpoint import MANIFEST, _read_manifest, ranked_checkpoints

log = logging.getLogger(__name__)


@dataclass(frozen=True)
class Candidate:
    """One finalized checkpoint proposed for deployment."""

    step: int
    digest: Optional[str]  # manifest params_digest (None: legacy artifact)
    path: str              # the step directory (the restore's input)
    source: str            # "checkpoint" | "anchor"

    @property
    def key(self):
        """Version identity: a re-saved step with different params is a
        DIFFERENT candidate (the digest moves), a re-poll of the same
        artifact is not."""
        return (self.step, self.digest)


def newest_candidate(ckpt_dir: str) -> Optional[Candidate]:
    """The newest valid checkpoint under ``ckpt_dir`` (main + anchors,
    every format) as a :class:`Candidate`, or None.  One validity walk —
    the same ranking every restore path uses, so the fleet can never
    deploy a step that resume would refuse."""
    for step, _, source, d in ranked_checkpoints(ckpt_dir):
        path = os.path.join(
            os.path.abspath(os.path.expanduser(d)), str(step)
        )
        manifest = _read_manifest(path)
        if manifest is None and os.path.exists(
                os.path.join(path, MANIFEST)):
            # Manifest present but unreadable: ranked_checkpoints would
            # not have listed it; defensive skip for the race where it
            # was torn between the walk and this read.
            continue
        digest = (manifest or {}).get("params_digest")
        return Candidate(step=int(step), digest=digest, path=path,
                         source=source)
    return None


class CheckpointWatcher:
    """Daemon polling ``ckpt_dir`` and emitting candidate events.

    Two forms share one core:

    * ``poll_once()`` — pure pull: the newest candidate if its version
      identity differs from the last one returned (the reloader's loop
      calls this; trivially unit-testable, no thread, no sleeps);
    * ``start(callback)`` / ``stop()`` — the daemon form: a thread polls
      every ``poll_s`` and invokes ``callback(candidate)`` on change.

    The watcher dedups on ``(step, digest)``, so a torn poll can never
    emit the same artifact twice, while a same-step re-save (digest
    moved) IS a new candidate.  A step older than the last one emitted
    must be the newest on two polls in a row (the module docstring).
    """

    def __init__(self, ckpt_dir: str, poll_s: float = 2.0):
        self.ckpt_dir = ckpt_dir
        self.poll_s = float(poll_s)
        self._last_key = None
        self._held_key = None  # an older step seen newest once
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def prime(self, candidate: Optional[Candidate]) -> None:
        """Mark ``candidate`` as already deployed so the first poll does
        not re-emit the version the server just loaded at startup."""
        self._last_key = candidate.key if candidate else None

    def poll_once(self) -> Optional[Candidate]:
        try:
            cand = newest_candidate(self.ckpt_dir)
        except OSError as e:  # transient fs hiccup: poll again later
            log.warning("checkpoint watch poll failed: %s", e)
            return None
        if cand is None or cand.key == self._last_key:
            self._held_key = None
            return None
        if (self._last_key is not None and cand.step < self._last_key[0]
                and cand.key != self._held_key):
            # The newer step may be mid-replace: wait one poll.
            self._held_key = cand.key
            return None
        self._held_key = None
        self._last_key = cand.key
        return cand

    # ------------------------------------------------------------ daemon

    def start(self, callback: Callable[[Candidate], None]) -> None:
        if self._thread is not None:
            raise RuntimeError("watcher already started")

        def _run():
            while not self._stop.wait(self.poll_s):
                cand = self.poll_once()
                if cand is not None:
                    try:
                        callback(cand)
                    except Exception:
                        log.exception(
                            "checkpoint watcher callback failed for "
                            "step %s", cand.step,
                        )

        self._thread = threading.Thread(
            target=_run, name="dwt-ckpt-watcher", daemon=True
        )
        self._thread.start()

    def stop(self, timeout: float = 10.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None
