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
JAX writer.

**Multi-process runs** (:class:`MultiHostAsyncCheckpointer`, JAX's
collective-free writer): the loop's thread copies the state to the host
itself (``ckpt_host_fetch``: the save's whole cost on the hot path), and
the writer thread writes this rank's shard of the
host-shard format (``utils.checkpoint.save_host_shard``; ``shard_write``)
and then reports the save's sequence number as done.  The step boundary's
consensus carries every rank's done sequence; the minimum is the
promotion frontier, up to which rank 0 promotes the steps
(:meth:`MultiHostAsyncCheckpointer.promote_up_to`; ``ckpt_promote``).
:class:`MultiHostDeltaAsyncCheckpointer` is the same for the delta
format: rank 0 stages the blobs and the manifest for every rank (the
state is replicated), the others run the finite gate only.  Under a
gspmd plan whose rules shard the state, both take the plan's gather and
run it inside ``ckpt_host_fetch`` (the ``gather`` span), so every rank's
host copy is the whole state and the format is the replica mode's.
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


class MultiHostAsyncCheckpointer(AsyncCheckpointer):
    """The multi-process writer (module docstring): the same
    single-in-flight, backpressure and error contract; saves are numbered
    by a sequence that is the same on every rank (saves come from
    lockstep control flow)."""

    def __init__(self, gather=None):
        super().__init__()
        from dwt_tpu_torch.parallel.mesh import process_count, process_index

        # A gspmd plan's gather: the sharded leaves all-gathered on the
        # loop's thread (a collective) before the host fetch, so a shard's
        # bytes do not depend on the plan.
        self._gather = gather
        self.process_index = process_index()
        self.process_count = process_count()
        self._done_seq = -1
        # [(seq, step, ckpt_dir, kwargs)] written here, awaiting promotion;
        # appended by the writer, drained on the loop's thread.
        self._due: List[Tuple[int, int, str, dict]] = []
        self._due_lock = threading.Lock()

    def _write_target(self, ckpt_dir: str, step: int, host, kwargs: dict) -> bool:
        from dwt_tpu_torch.utils.checkpoint import save_host_shard

        return save_host_shard(ckpt_dir, step, host, self.process_index,
                               data_state=kwargs.get("data_state"))

    def _promote(self, ckpt_dir: str, step: int, kwargs: dict) -> str:
        from dwt_tpu_torch.utils.checkpoint import promote_host_shards

        return promote_host_shards(ckpt_dir, step, self.process_count,
                                   keep=kwargs.get("keep"))

    def _run(self, targets, seq: int, step: int, host) -> None:
        t0 = time.perf_counter()
        try:
            paths = []
            for ckpt_dir, kwargs in targets:
                with obs.span("shard_write", "ckpt", step=int(step)):
                    wrote = self._write_target(ckpt_dir, step, host, kwargs)
                paths.append(wrote)
                if wrote:
                    with self._due_lock:
                        self._due.append((int(seq), int(step), ckpt_dir, dict(kwargs)))
            # Done only once every target's shard is durable.
            self._done_seq = int(seq)
            self.done.append({"seq": seq, "step": step, "paths": paths,
                              "writer_s": time.perf_counter() - t0})
        except BaseException as e:  # surfaced on the next save/flush
            self._error, self._error_step = e, step
            log.warning("async shard save @%d failed: %s", step, e)

    @property
    def done_seq(self) -> int:
        """The newest save this rank's writer has finished (-1: none)."""
        return self._done_seq

    def join(self) -> None:
        """Join the writer without raising its error: the rendezvous's
        collectives must run on every rank before a rank-local failure
        surfaces."""
        self._join()

    def save_multi(self, targets: List[Tuple[str, dict]], step: int, state) -> None:
        from dwt_tpu_torch.resilience.coord import assert_not_writer_thread
        from dwt_tpu_torch.utils.checkpoint import host_state

        self._join()
        self._raise_pending()
        assert_not_writer_thread("multi-process checkpoint fetch")
        with obs.span("ckpt_host_fetch", "ckpt", step=int(step)):
            host = host_state(self._gather(state) if self._gather is not None else state)
        self.seq += 1
        self._pending_step = int(step)
        self._thread = threading.Thread(
            target=self._run, args=(list(targets), self.seq, int(step), host),
            name=f"{WRITER_THREAD_PREFIX}-{int(step)}", daemon=True)
        self._thread.start()

    def promote_up_to(self, agreed_seq: int) -> List[Tuple[int, int, str, Optional[str]]]:
        """Finalize every written save with a sequence up to ``agreed_seq``
        (the consensus minimum of the ranks' done sequences): rank 0
        promotes, the others drop the entries.  Returns ``(seq, step, dir,
        path)`` of each (path None off rank 0 or where the promotion
        failed; its error surfaces at the next save or flush)."""
        if agreed_seq < 0:
            return []
        with self._due_lock:
            due = [d for d in self._due if d[0] <= agreed_seq]
            self._due = [d for d in self._due if d[0] > agreed_seq]
        out = []
        for seq, step, ckpt_dir, kwargs in due:
            path = None
            if self.process_index == 0:
                try:
                    with obs.span("ckpt_promote", "ckpt", step=int(step)):
                        path = self._last_path = self._promote(ckpt_dir, step, kwargs)
                except OSError as e:
                    if self._error is None:
                        self._error, self._error_step = e, step
                    log.warning("checkpoint promotion @%d failed: %s", step, e)
            out.append((seq, step, ckpt_dir, path))
        return out


class MultiHostDeltaAsyncCheckpointer(MultiHostAsyncCheckpointer):
    """The multi-process writer in the delta format: rank 0 stages the
    moved blobs and the manifest for every rank (the state is replicated),
    the others run only the finite gate, so that every rank reports the
    same verdict; promotion as the host-shard writer's."""

    def __init__(self, store_root=None, delta_max_chain: Optional[int] = None,
                 gc: bool = True, gather=None):
        super().__init__(gather=gather)
        self._store_root = store_root
        self._delta_max_chain = delta_max_chain
        self._gc = gc

    def _write_target(self, ckpt_dir: str, step: int, host, kwargs: dict) -> bool:
        from dwt_tpu_torch.ckpt.store import (
            DEFAULT_DELTA_MAX_CHAIN,
            TORCH_META,
            payload_leaves,
            stage_delta,
        )
        from dwt_tpu_torch.utils.checkpoint import host_params_finite, params_digest

        if not host_params_finite(host):
            log.warning("skipping delta save @%d: non-finite params", step)
            return False
        if self.process_index != 0:
            return True
        leaves, meta = payload_leaves(host.payload)
        digest = params_digest((n, host.payload["model"][n]) for n in host.param_names)
        extra = {TORCH_META: meta}
        if kwargs.get("data_state") is not None:
            extra["data_state"] = kwargs["data_state"]
        stage_delta(ckpt_dir, step, leaves, digest=digest, extra=extra,
                    store_root=self._store_root,
                    delta_max_chain=(self._delta_max_chain if self._delta_max_chain
                                     is not None else DEFAULT_DELTA_MAX_CHAIN))
        return True

    def _promote(self, ckpt_dir: str, step: int, kwargs: dict) -> str:
        from dwt_tpu_torch.ckpt.store import promote_delta

        return promote_delta(ckpt_dir, step, keep=kwargs.get("keep"),
                             store_root=self._store_root, gc=self._gc)
