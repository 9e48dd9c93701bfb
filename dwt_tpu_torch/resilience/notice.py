"""Scheduler preemption NOTICE watcher: act before the SIGTERM lands — ``dwt_tpu.resilience.notice`` for the port (framework-free, copied).

Cloud schedulers usually warn before they kill.  GCE flips the instance
metadata key ``instance/preempted`` to ``TRUE`` ~30 seconds before
delivering the preemption SIGTERM; SLURM and k8s setups can touch a file
from a prolog/preStop hook.  A run that only reacts to the SIGTERM
spends its short grace window writing a checkpoint; a run that sees the
*notice* saves proactively while training continues, so the eventual
SIGTERM path finds a recent checkpoint already durable and exits
immediately.

:class:`NoticeWatcher` polls the configured sources on a daemon thread
and latches ``noticed``:

* **metadata endpoint** — the GCE URL by default (test-overridable via
  ``DWT_PREEMPT_METADATA_URL`` or the constructor); a response body of
  ``TRUE`` (GCE's convention) marks the notice.  Enabled by
  ``--preempt_notice_metadata`` — off by default so non-GCE runs never
  probe a dead endpoint.
* **notice file** — ``--preempt_notice_file PATH``: the file coming into
  existence is the notice (generic scheduler integration: anything that
  can ``touch`` a file can warn the run).

The watcher never acts by itself: the training loops read ``noticed`` at
step boundaries and feed it into the :class:`~dwt_tpu_torch.resilience.coord.
Coordinator` consensus — one host's notice becomes every host's
proactive save at the same boundary (the notice usually lands on a
single VM of a multi-host slice, but the save must be global to be
restorable).  Deterministic tests arm the ``notice_at_step`` fault kind
(:mod:`~dwt_tpu_torch.resilience.inject`), which latches the same module flag
without any watcher thread at all.
"""

from __future__ import annotations

import logging
import os
import threading
from typing import Optional

log = logging.getLogger(__name__)

# GCE's preemption warning key; ~30 s of advance notice on preemptible /
# spot VMs.  The body is the string "TRUE" once preemption is scheduled.
GCE_METADATA_URL = (
    "http://metadata.google.internal/computeMetadata/v1/instance/preempted"
)
METADATA_URL_ENV = "DWT_PREEMPT_METADATA_URL"

# Module-level latch for the deterministic notice_at_step fault kind:
# injected notices must be visible to the boundary WITHOUT a watcher
# thread (subprocess chaos tests poll nothing).
_injected = False


def trigger_injected() -> None:
    global _injected
    _injected = True


def reset_injected() -> None:
    """Test hygiene: clear the latch between in-process tests."""
    global _injected
    _injected = False


def post_notice(path: str) -> None:
    """Deliver a file-based preemption notice: the sender half of the
    ``--preempt_notice_file`` contract (the sweep supervisor warning a
    job before its SIGTERM, a scheduler prolog, a test).  Durable write
    (tmp + fsync + rename): the watcher keys on existence, and a torn
    zero-byte file appearing briefly then vanishing under a crashed
    sender would be a notice that un-happens."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.tmp-{os.getpid()}"
    with open(tmp, "w") as f:
        f.write("preempt\n")
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


class NoticeWatcher:
    """Context manager polling preemption-notice sources (class doc).

    Inert (no thread) when neither source is configured — ``noticed``
    still reflects injected notices, so the loops wire it
    unconditionally.  Poll errors are logged once and never raise: a
    flaky metadata server must not kill the run it is trying to warn.
    """

    def __init__(
        self,
        file_path: Optional[str] = None,
        metadata: bool = False,
        metadata_url: Optional[str] = None,
        poll_s: float = 2.0,
    ):
        self.file_path = file_path or None
        self.metadata_url = None
        if metadata or metadata_url:
            self.metadata_url = (
                metadata_url
                or os.environ.get(METADATA_URL_ENV)
                or GCE_METADATA_URL
            )
        self.poll_s = max(float(poll_s), 0.1)
        self._noticed = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._warned = False

    @property
    def enabled(self) -> bool:
        return bool(self.file_path or self.metadata_url)

    @property
    def noticed(self) -> bool:
        return self._noticed.is_set() or _injected

    # ------------------------------------------------------------- internals

    def _check_once(self) -> bool:
        if self.file_path and os.path.exists(self.file_path):
            log.warning(
                "preemption notice: file %s exists — proactive save at "
                "the next step boundary", self.file_path,
            )
            return True
        if self.metadata_url:
            try:
                import urllib.request

                req = urllib.request.Request(
                    self.metadata_url,
                    headers={"Metadata-Flavor": "Google"},
                )
                with urllib.request.urlopen(req, timeout=1.5) as resp:
                    body = resp.read(64).decode("ascii", "replace").strip()
                if body.upper() == "TRUE":
                    log.warning(
                        "preemption notice: metadata %s reports TRUE — "
                        "proactive save at the next step boundary",
                        self.metadata_url,
                    )
                    return True
            except Exception as e:  # noqa: BLE001 — warning path must not kill
                if not self._warned:
                    self._warned = True
                    log.warning(
                        "preemption-notice metadata poll failed (%s: %s); "
                        "will keep retrying quietly", type(e).__name__, e,
                    )
        return False

    def _watch(self) -> None:
        while not self._stop.wait(self.poll_s):
            if self._check_once():
                self._noticed.set()
                return  # latched; nothing further to poll

    # ------------------------------------------------------------------ API

    def __enter__(self) -> "NoticeWatcher":
        if self.enabled:
            self._thread = threading.Thread(
                target=self._watch, name="dwt-preempt-notice", daemon=True
            )
            self._thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
