"""Cooperative SIGTERM/SIGINT handling for preemptible runs — ``dwt_tpu.resilience.preemption`` for the port (framework-free, copied).

Cloud preemption (and most cluster schedulers) delivers SIGTERM with a
short grace window before SIGKILL.  A training loop that dies mid-step
loses everything since the last periodic checkpoint; one that blocks in a
long save inside the signal handler risks re-entrancy and torn state.

:class:`PreemptionHandler` does the minimal safe thing: the handler only
sets a flag, and the loops poll ``should_stop`` at step/chunk boundaries
— the natural consistency points where the train state is whole — then
save a final checkpoint and return normally (exit code 0, so schedulers
don't mark the job failed).  A second SIGINT restores the previous
handler and raises ``KeyboardInterrupt``: an operator double Ctrl-C still
kills a run whose final save hangs.

The SIGTERM is usually *announced*: GCE flips an instance-metadata key
~30 s earlier, and most schedulers can touch a notice file from a
prolog/preStop hook.  :class:`~dwt_tpu_torch.resilience.notice.NoticeWatcher`
watches those sources so the loops save proactively (all hosts, same
boundary) while training continues — when
the SIGTERM then lands here, the stop path finds ``notice_step`` already
durable and exits without writing a second full checkpoint, spending the
grace window on nothing but the flush/finalize rendezvous.
"""

from __future__ import annotations

import os
import signal
import threading
from typing import Optional


class PreemptionHandler:
    """Context manager installing graceful SIGTERM/SIGINT handlers.

    Signal handlers can only be installed from the main thread; elsewhere
    (e.g. a loop driven from a worker thread) the handler degrades to an
    inert flag that never fires — training behavior is unchanged.

    The ``logger`` is NOT written from inside the handler: a signal can
    land while the main thread is inside the logger's own buffered
    print/write, and a reentrant buffered-I/O call raises RuntimeError at
    an arbitrary point in the training loop — the opposite of graceful.
    The handler sets the flag and emits one unbuffered ``os.write`` to
    stderr; the durable JSONL narration is the loop's own ``preempt``
    record, logged with the final checkpoint at the next step boundary.
    """

    SIGNALS = (signal.SIGTERM, signal.SIGINT)

    def __init__(self, logger=None):
        self._logger = logger  # kept for API symmetry; see class docstring
        self._stop = threading.Event()
        self._previous = {}
        self._installed = False
        self.signum: Optional[int] = None

    @property
    def should_stop(self) -> bool:
        return self._stop.is_set()

    def _handle(self, signum, frame):
        if signum == signal.SIGINT and self._stop.is_set():
            # Second Ctrl-C: the operator wants out NOW.
            self._restore()
            raise KeyboardInterrupt
        self.signum = signum
        self._stop.set()
        try:  # async-signal-safe enough: single unbuffered write
            os.write(
                2,
                b"[preempt] %s received; saving a final checkpoint at the "
                b"next step boundary\n"
                % signal.Signals(signum).name.encode(),
            )
        except OSError:
            pass  # a closed stderr must not kill the grace window

    def __enter__(self) -> "PreemptionHandler":
        try:
            for s in self.SIGNALS:
                self._previous[s] = signal.signal(s, self._handle)
            self._installed = True
        except ValueError:  # not the main thread
            self._previous.clear()
        return self

    def _restore(self) -> None:
        if not self._installed:
            return
        for s, old in self._previous.items():
            signal.signal(s, old)
        self._previous.clear()
        self._installed = False

    def __exit__(self, *exc) -> None:
        self._restore()
