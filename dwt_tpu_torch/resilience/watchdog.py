"""Hang watchdog: turn a wedged step into a diagnosed, relaunchable exit — ``dwt_tpu.resilience.watchdog`` for the port.

The one failure the rest of the resilience layer cannot see is the one
where nothing happens: a deadlocked collective (one host restarted, the
others blocked in an all-reduce), a wedged device runtime, or an I/O mount
that stops answering.  The process is alive, the scheduler is happy, and
the job burns its allocation making zero progress until a human notices.

:class:`HangWatchdog` is a daemon thread fed by step-boundary heartbeats
from the training loops.  When no heartbeat arrives for
``timeout_s`` seconds it (1) dumps ALL thread stacks to
``ckpt_dir/watchdog/stacks-<pid>-<ts>.txt`` — capped at the newest
``keep`` dumps (``--watchdog_keep``), so a relaunch loop (113 → resume →
hang again) cannot fill the disk — (``faulthandler`` — exactly the
evidence a post-mortem needs: *which* collective/syscall every thread is
blocked in), (2) writes one unbuffered line to stderr naming the dump,
and (3) hard-exits with :data:`WATCHDOG_EXIT_CODE` — distinct from both
a clean preemption exit (0) and an ordinary crash (1), so schedulers can
recognize "hang, relaunch me" and the relaunch lands in the existing
newest-valid-checkpoint resume path.

``os._exit`` (not ``sys.exit``) on purpose: the main thread is wedged,
so unwinding it is impossible — raising in a daemon thread would be
silently discarded, and any attempt to run atexit/finally handlers could
block on the very lock that hung the process.

Heartbeats are a single monotonic-clock store (no lock: CPython assigns
floats atomically, and the worst race costs one poll interval of
detection latency), so the hot path pays nothing measurable.  Timeouts
must budget for the slowest legitimate gap between heartbeats — the
first step's kernel builds and any boundary eval — which is why the loops
also beat after evals/saves, and why the default is "off" (0) on CPU
test configs.
"""

from __future__ import annotations

import contextlib
import faulthandler
import os
import sys
import threading
import time
from typing import Callable, Optional

# "Hang detected" — distinct from 0 (clean preempt save) and 1 (error),
# outside the shell's 126/127/128+N conventions, documented in README's
# failure-semantics table.  Schedulers treat it as "relaunch to resume".
WATCHDOG_EXIT_CODE = 113


class HangWatchdog:
    """Context manager running the stall detector while a loop trains.

    ``timeout_s <= 0`` disables everything — ``heartbeat()`` stays a
    no-op-cheap call so the loops need no conditionals.  ``_exit`` is
    injectable for unit tests (the default really exits the process).
    """

    # Default stack-dump retention: a relaunch loop (exit 113 → scheduler
    # resume → hang again) writes one dump per attempt, forever — without
    # a cap it fills the checkpoint mount with the evidence of its own
    # failure.  The newest few dumps carry all the diagnostic value.
    DEFAULT_KEEP = 5

    def __init__(
        self,
        timeout_s: float,
        ckpt_dir: Optional[str] = None,
        logger=None,
        keep: int = DEFAULT_KEEP,
        _exit: Callable[[int], None] = os._exit,
    ):
        self.timeout_s = float(timeout_s or 0.0)
        self.enabled = self.timeout_s > 0
        self.keep = max(int(keep), 1)  # the dump being written always stays
        self._ckpt_dir = ckpt_dir
        self._logger = logger  # unused in the handler (see preemption.py);
        # kept for API symmetry with the other resilience context managers.
        self._exit = _exit
        self._beat = time.monotonic()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._suspended = 0
        self.fired = False  # observable by injected-_exit unit tests
        self.stacks_path: Optional[str] = None

    # ------------------------------------------------------------------ API

    def heartbeat(self) -> None:
        """Step-boundary liveness signal (atomic store; safe anywhere)."""
        self._beat = time.monotonic()

    @contextlib.contextmanager
    def suspended(self):
        """Mask the watchdog across a legitimately-unbounded blocking
        section — a SYNCHRONOUS checkpoint save (multi-host downgrade or
        ``--no-async_ckpt``) can run longer than any sane step timeout,
        and killing it mid-write every attempt would livelock the run on
        the same save boundary forever.  The trade is explicit: a save
        hung on dead storage is not caught while masked (its bounded
        I/O retries are the defense there).  Exiting re-heartbeats, so
        the save's duration never counts against the next interval."""
        self._suspended += 1
        try:
            yield
        finally:
            # Heartbeat BEFORE unmasking: the reverse order leaves a
            # window where the poll thread sees _suspended == 0 with a
            # beat predating the whole masked section and fires on a
            # healthy process.
            self.heartbeat()
            self._suspended -= 1

    def __enter__(self) -> "HangWatchdog":
        if self.enabled:
            self._beat = time.monotonic()
            self._thread = threading.Thread(
                target=self._watch, name="dwt-hang-watchdog", daemon=True
            )
            self._thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    # ------------------------------------------------------------- internals

    def _watch(self) -> None:
        # Poll at a quarter of the timeout: detection latency stays under
        # 1.25x the configured timeout without a busy loop.
        poll = max(min(self.timeout_s / 4.0, 1.0), 0.05)
        while not self._stop.wait(poll):
            if self._suspended:
                continue  # inside a masked blocking section (sync save)
            stalled = time.monotonic() - self._beat
            if stalled > self.timeout_s:
                self._fire(stalled)
                return

    def _prune_dumps(self, d: str, keep: int) -> None:
        """Cap ``stacks-*.txt`` files to the newest ``keep`` (oldest
        mtime first out) — relaunch loops must not fill the disk with
        dumps."""
        try:
            dumps = [
                os.path.join(d, name)
                for name in os.listdir(d)
                if name.startswith("stacks-") and name.endswith(".txt")
            ]
            dumps.sort(key=os.path.getmtime)
            for stale in dumps[: max(len(dumps) - keep, 0)]:
                os.unlink(stale)
        except OSError:
            pass  # retention is best-effort; never blocks the dump/exit

    def _dump_stacks(self, stalled: float) -> Optional[str]:
        if not self._ckpt_dir:
            return None
        try:
            d = os.path.join(self._ckpt_dir, "watchdog")
            os.makedirs(d, exist_ok=True)
            # pid+timestamp name: successive relaunches (fresh pids) AND a
            # recycled pid both get distinct files; retention prunes by
            # age, keeping room for this dump inside the cap.
            self._prune_dumps(d, self.keep - 1)
            path = os.path.join(d, f"stacks-{os.getpid()}-{int(time.time())}.txt")
            with open(path, "w") as f:
                f.write(
                    f"hang watchdog: pid={os.getpid()} "
                    f"stalled={stalled:.1f}s timeout={self.timeout_s:.1f}s "
                    f"exit_code={WATCHDOG_EXIT_CODE}\n"
                    "all-thread stacks at detection time:\n\n"
                )
                f.flush()
                faulthandler.dump_traceback(file=f, all_threads=True)
                f.flush()
                os.fsync(f.fileno())
            return path
        except OSError:
            return None  # a dead ckpt mount must not stop the exit

    def _fire(self, stalled: float) -> None:
        self.fired = True
        self.stacks_path = self._dump_stacks(stalled)
        try:
            # Unbuffered, signal-handler-grade write: the process state is
            # unknown (that is the premise), so no logging machinery here.
            os.write(
                2,
                (
                    f"[watchdog] no step-boundary heartbeat for "
                    f"{stalled:.1f}s (timeout {self.timeout_s:.1f}s); "
                    f"stacks: {self.stacks_path or 'unavailable'}; "
                    f"exiting {WATCHDOG_EXIT_CODE} for scheduler relaunch\n"
                ).encode(),
            )
        except OSError:
            pass
        if self.stacks_path is None:
            # No ckpt_dir: at least leave the stacks on stderr.
            try:
                faulthandler.dump_traceback(file=sys.stderr, all_threads=True)
            except Exception:  # noqa: BLE001 — nothing may block the exit
                pass
        self._exit(WATCHDOG_EXIT_CODE)
