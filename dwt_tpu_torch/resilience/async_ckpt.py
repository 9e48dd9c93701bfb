"""Background checkpoint saves: snapshot on the compute stream, copy and write on a writer thread — the single-process port of ``dwt_tpu.resilience.async_ckpt``.

``utils.checkpoint.save_state`` blocks the loop for a device-to-host copy,
a SHA-256 of the parameters, ``torch.save``, fsyncs and a rename.
:class:`AsyncCheckpointer` splits a save in two:

* **hot path** — :meth:`AsyncCheckpointer.save` copies the state's
  tensors into device buffers of its own on the compute stream
  (``TrainState.snapshot``: a few ``torch._foreach_copy_`` launches, no
  sync; each copy keeps its tensor's strides), records an event after
  them and starts the writer.  The loop
  launches its next step at once.  The copies are needed because the
  optimizer overwrites the parameters and its buffers in place at the
  next step (JAX arrays are immutable, so the JAX writer reads a
  ``jnp.copy``).  The buffers belong to the checkpointer and are reused
  by the next save, which joins this one first, so the caching allocator
  never hands them to anyone while the writer reads them.
* **writer thread** — waits on the event on its own CUDA stream, copies
  the snapshot to the host there (a channels_last weight as its own
  bytes, made contiguous on the host), then runs ``save_state`` (or the delta
  store's ``save_delta``) on the host copy: the finite gate, the digest
  and the write are those of a synchronous save, so the bytes on disk
  are the same.  It never launches work on the compute stream
  (``coord.assert_not_writer_thread`` guards the paths that do).

The JAX docstring's three rules hold here too:

* **single in-flight** — a second save joins the first (backpressure).
* **rendezvous** — :meth:`flush` joins the in-flight save; the loops call
  it before the preemption exit, the final save, a rollback's restore and
  a ``best.json`` update.
* **errors surface** — a writer exception is raised on the next
  :meth:`save`/:meth:`flush`.

Each target's write is the writer thread's ``ckpt_write`` span, as in the
JAX writer.  ``MultiHostAsyncCheckpointer`` (and with it the
``shard_write``, ``ckpt_host_fetch`` and ``ckpt_promote`` spans) waits
for multi-process training (ROADMAP queue 1 item 8).
"""

from __future__ import annotations

import logging
import threading
import time
from typing import List, Optional, Tuple

import torch

from dwt_tpu_torch import obs
from dwt_tpu_torch.resilience.coord import WRITER_THREAD_PREFIX

log = logging.getLogger(__name__)


def snapshot_state(state, reuse=None):
    """``state.snapshot(reuse)``: device copies enqueued on the current
    (compute) stream, which must not be the writer thread's."""
    from dwt_tpu_torch.resilience.coord import assert_not_writer_thread

    assert_not_writer_thread("checkpoint snapshot")
    return state.snapshot(reuse)


class AsyncCheckpointer:
    """Single-in-flight background writer (module doc).  All public
    methods are for the loop's thread.  Every save gets a sequence number
    (``seq``, counting from 1); each one the writer finishes appends
    ``{"seq", "step", "writer_s", "paths"}`` to ``done`` (``writer_s``:
    its wall seconds; a path is None where the finite gate refused)."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._error_step: Optional[int] = None
        self._last_path: Optional[str] = None
        self._pending_step: Optional[int] = None
        self._snapshot = None  # device buffers reused by every save
        self._stream = None
        self.seq = 0
        self.done: List[dict] = []

    # ------------------------------------------------------------- internals

    def _save_target(self, ckpt_dir: str, step: int, host, kwargs: dict):
        # Deferred: utils.checkpoint imports this package's inject module.
        from dwt_tpu_torch.utils.checkpoint import save_state

        return save_state(ckpt_dir, step, host, **kwargs)

    def _run(self, targets, seq: int, step: int, snapshot,
             names: Tuple[str, ...]) -> None:
        from dwt_tpu_torch.utils.checkpoint import HostState

        t0 = time.perf_counter()
        try:
            host = HostState(snapshot.host_payload(self._stream), names)
            paths = []
            for ckpt_dir, kwargs in targets:
                # The writer thread's span: one background save (digest,
                # write, rename), what the loop no longer pays.
                with obs.span("ckpt_write", "ckpt", step=int(step)):
                    path = self._save_target(ckpt_dir, step, host, kwargs)
                paths.append(path)
                if path is not None:  # None: refused (non-finite), no artifact
                    self._last_path = path
            self.done.append({"seq": seq, "step": step, "paths": paths,
                              "writer_s": time.perf_counter() - t0})
        except BaseException as e:  # surfaced on the next save/flush
            self._error, self._error_step = e, step
            log.warning("async checkpoint save @%d failed: %s", step, e)

    def _join(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
            self._pending_step = None

    def _raise_pending(self) -> None:
        if self._error is not None:
            e, step = self._error, self._error_step
            self._error = self._error_step = None
            log.error("surfacing failed async checkpoint save @%s", step)
            raise e

    # ------------------------------------------------------------------ API

    @property
    def in_flight(self) -> Optional[int]:
        """Step of the save being written, or None."""
        return self._pending_step

    def save(self, ckpt_dir: str, step: int, state, **kwargs) -> None:
        self.save_multi([(ckpt_dir, kwargs)], step, state)

    def save_multi(self, targets: List[Tuple[str, dict]], step: int, state) -> None:
        """One snapshot, one writer task for every ``(dir, kwargs)`` of
        ``targets``; returns once the copies are enqueued, unless the
        previous save is still being written (backpressure).  A previous
        writer failure is raised here, before anything is enqueued."""
        self._join()
        self._raise_pending()
        self._snapshot = snapshot_state(state, self._snapshot)
        if self._snapshot.event is not None and self._stream is None:
            device = next(state.model.parameters()).device
            self._stream = torch.cuda.Stream(device=device)
        names = tuple(n for n, _ in state.model.named_parameters())
        self.seq += 1
        self._pending_step = int(step)
        self._thread = threading.Thread(
            target=self._run,
            args=(list(targets), self.seq, int(step), self._snapshot, names),
            name=f"{WRITER_THREAD_PREFIX}-{int(step)}", daemon=True)
        self._thread.start()

    def flush(self) -> Optional[str]:
        """Join the in-flight save; raise its error if it failed.  Returns
        the newest finalized checkpoint's path (None before any)."""
        self._join()
        self._raise_pending()
        return self._last_path

    def close(self, raise_errors: bool = True) -> None:
        """Final rendezvous; ``raise_errors=False`` on abnormal exits,
        where a writer error (already logged) must not mask the original
        exception."""
        if raise_errors:
            self.flush()
            return
        self._join()
        self._error = self._error_step = None


class DeltaAsyncCheckpointer(AsyncCheckpointer):
    """The background writer for the content-addressed delta format
    (``--ckpt_format delta``): the same contract, with the delta store's
    ``save_delta`` as the write."""

    def __init__(self, store_root=None, delta_max_chain: Optional[int] = None,
                 gc: bool = True):
        super().__init__()
        self._store_root = store_root
        self._delta_max_chain = delta_max_chain
        self._gc = gc  # False on a store other runs share (--blob_store)

    def _save_target(self, ckpt_dir: str, step: int, host, kwargs: dict):
        from dwt_tpu_torch.ckpt.store import DEFAULT_DELTA_MAX_CHAIN, save_delta

        return save_delta(
            ckpt_dir, step, host, store_root=self._store_root,
            delta_max_chain=(self._delta_max_chain if self._delta_max_chain is not None
                             else DEFAULT_DELTA_MAX_CHAIN),
            gc=self._gc, **kwargs)
