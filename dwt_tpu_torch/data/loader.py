"""Batching and device prefetch — ``batch_iterator`` and ``prefetch_to_device`` of ``dwt_tpu.data.loader``, copied for PyTorch.

``batch_iterator`` takes each epoch's order from the seekable sampler
(``dwt_tpu_torch.data.sampler``), loads every item under its seed token
``(seed, epoch, index)`` (so ``ThreadLocalRng`` transforms draw the same
numbers on any thread and at any worker count), retries a failing item
once and then quarantines it, and with ``num_workers > 1`` loads items on
an ``OrderedWorkerPool`` (PIL decode, the native passes and numpy release
the GIL).  ``start_batch`` opens an epoch at an exact batch cursor, and
``substitute=True`` (the train loops) replaces a quarantined item by the
nearest good one, so an epoch's batch count never changes.

``prefetch_to_device`` moves batches to the device from a background
thread: on CUDA through a small ring of reused pinned host buffers and a
side stream, on the CPU as ``torch.from_numpy`` tensors.

A :class:`QuarantineRegistry` persists quarantined ids under the
checkpoint directory (``quarantine.json``), so a resumed run skips
known-bad items without reading them.

Not ported yet: the per-process ``shard=(index, count)`` split (with DDP,
ROADMAP queue 1 item 8).
"""

from __future__ import annotations

import json
import logging
import os
import queue
import threading
from typing import Callable, Dict, FrozenSet, Iterable, Iterator, Optional, Tuple

import numpy as np
import torch

from dwt_tpu_torch import obs
from dwt_tpu_torch.data.pipeline import DEFAULT_STALL_TIMEOUT_S, OrderedWorkerPool
from dwt_tpu_torch.data.sampler import SeekableSampler
from dwt_tpu_torch.data.transforms import set_item_seed

log = logging.getLogger(__name__)

# Per-item retry count: one immediate retry covers transient
# failures (an NFS hiccup, a file being replaced) without stalling the
# pool on a corrupt file.
ITEM_RETRIES = 1

# Sentinel yielded in place of an item that exhausted its retries under
# quarantine semantics; batch assembly drops or substitutes it.
QUARANTINED = object()


class QuarantineRegistry:
    """Durable record of quarantined item ids, keyed by stream role.

    A quarantined item (undecodable image, persistently failing read) is
    skipped for the rest of the epoch, but a resumed run would pay the
    retries for the same file every epoch.  The registry persists the ids
    under the run's ``ckpt_dir`` (``quarantine.json``) so a resume skips
    known-bad items without a single access attempt.

    Keys separate index spaces ("source"/"target"): the same integer id
    names different files in different datasets.  Writes are atomic (tmp
    + replace), lock-guarded (quarantine fires from loader worker
    threads), and merge with the ids already on disk first, so a second
    writer of the same directory loses nothing it wrote before.
    """

    FILENAME = "quarantine.json"

    def __init__(self, path: str):
        self.path = path
        self._lock = threading.Lock()
        self._known: Dict[str, set] = {}
        self._merge_from_disk()

    def _merge_from_disk(self) -> None:
        """Fail-soft merge: a torn or malformed registry file never stops a
        run — the worst it costs is re-quarantining items as they fail
        again; every surprise is a warning and whatever parsed cleanly."""
        try:
            with open(self.path) as f:
                raw = json.load(f)
        except FileNotFoundError:
            return
        except (OSError, ValueError) as e:
            log.warning("quarantine registry %s unreadable (%s); starting "
                        "from an empty registry", self.path, e)
            return
        if not isinstance(raw, dict):
            log.warning("quarantine registry %s is not a JSON object (got %s); "
                        "starting from an empty registry",
                        self.path, type(raw).__name__)
            return
        for k, v in raw.items():
            try:
                ids = {int(i) for i in v}
            except (ValueError, TypeError) as e:
                log.warning("quarantine registry %s: ignoring malformed entry "
                            "%r (%s)", self.path, k, e)
                continue
            self._known.setdefault(str(k), set()).update(ids)

    @classmethod
    def for_ckpt_dir(cls, ckpt_dir: str) -> "QuarantineRegistry":
        return cls(os.path.join(
            os.path.abspath(os.path.expanduser(ckpt_dir)), cls.FILENAME))

    def known(self, key: str) -> FrozenSet[int]:
        with self._lock:
            return frozenset(self._known.get(key, ()))

    def add(self, key: str, index: int) -> None:
        with self._lock:
            ids = self._known.setdefault(key, set())
            if int(index) in ids:
                return
            ids.add(int(index))
            self._merge_from_disk()  # keep concurrent writers additive
            payload = {k: sorted(v) for k, v in self._known.items()}
            tmp = f"{self.path}.{os.getpid()}.tmp"
            try:
                os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
                with open(tmp, "w") as f:
                    json.dump(payload, f, indent=1)
                os.replace(tmp, self.path)
            except OSError as e:
                # Best-effort: the in-memory record still protects this run.
                log.warning("could not persist quarantine registry %s: %s",
                            self.path, e)


def _load_item(dataset, i: int, token, quarantine: bool = True,
               known_bad: FrozenSet[int] = frozenset(),
               on_quarantine: Optional[Callable[[int], None]] = None):
    """``dataset[i]`` under the item-seed context ``token``, so stochastic
    transforms on ``ThreadLocalRng`` draw from a stream set by ``token``
    alone.

    A failing load is retried ``ITEM_RETRIES`` times, each attempt in a
    fresh context of the same token (a retry that succeeds is bitwise a
    first-try success).
    An item that keeps failing is quarantined: logged, passed to
    ``on_quarantine`` and returned as ``QUARANTINED``.  ``quarantine=False``
    re-raises the last exception.  An item of ``known_bad`` (a registry's
    ids) is ``QUARANTINED`` without an access attempt, unless
    ``quarantine=False``.
    """
    if quarantine and int(i) in known_bad:
        return QUARANTINED
    last: Optional[BaseException] = None
    for attempt in range(ITEM_RETRIES + 1):
        set_item_seed(token)
        try:
            return dataset[int(i)]
        except Exception as e:
            last = e
            if attempt < ITEM_RETRIES:
                log.warning(
                    "item %d failed (%s: %s); retry %d/%d",
                    i, type(e).__name__, e, attempt + 1, ITEM_RETRIES,
                )
        finally:
            set_item_seed(None)
    if not quarantine:
        raise last
    log.warning(
        "quarantined item %d after %d attempts (%s: %s)",
        i, ITEM_RETRIES + 1, type(last).__name__, last,
    )
    if on_quarantine is not None:
        on_quarantine(int(i))
    return QUARANTINED


def _stack(parts):
    first = parts[0]
    if np.isscalar(first) or (isinstance(first, np.ndarray) and first.ndim == 0):
        return np.asarray(parts)
    return np.stack(parts)


def batch_iterator(
    dataset,
    batch_size: int,
    shuffle: bool = True,
    drop_last: bool = True,
    seed: int = 0,
    epoch: int = 0,
    num_workers: int = 0,
    quarantine: bool = True,
    pad_and_mask: bool = False,
    start_batch: int = 0,
    substitute: bool = False,
    on_batch_ids: Optional[Callable] = None,
    on_substitute: Optional[Callable[[], None]] = None,
    quarantine_registry: Optional[QuarantineRegistry] = None,
    quarantine_key: str = "items",
    stall_timeout: float = DEFAULT_STALL_TIMEOUT_S,
) -> Iterator[Tuple[np.ndarray, ...]]:
    """Yield tuples of stacked numpy batches from an indexable dataset.

    * ``drop_last=True`` by default (the reference's halves/thirds batch
      split relies on it);
    * ``seed``/``epoch`` set the epoch's order (``SeekableSampler``) and
      every item's seed token ``(seed, epoch, index)``;
    * ``num_workers > 1``: items load on a thread pool, in order;
    * ``quarantine``: a failing item is retried once, then logged and
      dropped (a later batch boundary moves by one sample);
      ``quarantine=False`` re-raises instead;
    * ``pad_and_mask=True`` (eval): every tuple gains a trailing boolean
      ``mask`` and the ragged tail is padded to ``batch_size`` by
      repeating its last item with ``mask=False``, so masked counters stay
      exact; a quarantined item is substituted and masked out.  Requires
      ``shuffle=False, drop_last=False``;
    * ``start_batch=k``: open the epoch at batch cursor ``k``; the prefix
      is never generated or loaded, and the batches are bitwise the suffix
      of an epoch opened at 0 (train path only);
    * ``substitute=True`` (the train loops): a quarantined item is
      replaced by the nearest preceding good item (before the first good
      one, by the next), so the epoch's batch count is fixed;
      ``on_substitute`` is called once per substituted sample;
    * ``on_batch_ids``: called with the dataset indices of every yielded
      batch (after substitution);
    * ``stall_timeout``: the worker pool's head-of-window stall budget in
      seconds (0 disables the detection);
    * ``quarantine_registry``/``quarantine_key``: persist quarantined ids
      under the key (the stream role), and skip the ids already recorded
      without an access attempt — with the same drop or substitute
      semantics as a freshly quarantined item.
    """
    n = len(dataset)
    sampler = SeekableSampler(n, seed=seed, epoch=epoch, shuffle=shuffle)
    start_batch = int(start_batch)
    if start_batch < 0:
        raise ValueError(f"start_batch must be >= 0; got {start_batch}")
    mask = None
    prior_positions = None
    if pad_and_mask:
        if shuffle or drop_last:
            raise ValueError(
                "pad_and_mask is an eval-path contract: it requires "
                "shuffle=False and drop_last=False"
            )
        if start_batch:
            raise ValueError(
                "start_batch is a train-path resume cursor; the "
                "pad_and_mask eval contract always starts at 0"
            )
        order = sampler.positions()
        target = -(-n // batch_size) * batch_size
        mask = np.ones(target, bool)
        if target > n:
            mask[n:] = False
            pad_src = order[-1:] if n else np.zeros(1, order.dtype)
            order = np.concatenate([order, np.repeat(pad_src, target - n)])
        indices = order
    else:
        # Pure position arithmetic, then one seekable map of exactly the
        # remaining positions: a start_batch seek never generates (or
        # loads) the skipped prefix.
        stop = n - n % batch_size if drop_last else n
        first = start_batch * batch_size
        indices = sampler.take(np.arange(first, stop, dtype=np.int64))
        # The positions before the cursor, newest first: the substitution
        # walk below needs them so that a quarantined item at the cursor
        # substitutes the item the uninterrupted epoch used.
        if first:
            prior_positions = np.arange(first, dtype=np.int64)[::-1]
    token_of = lambda i: (seed, epoch, int(i))
    known_bad: FrozenSet[int] = frozenset()
    on_quarantine = None
    if quarantine_registry is not None:
        known_bad = quarantine_registry.known(quarantine_key)
        on_quarantine = lambda i: quarantine_registry.add(quarantine_key, i)
    load = lambda i: _load_item(dataset, i, token_of(i), quarantine,
                                known_bad, on_quarantine)
    if num_workers and num_workers > 1:
        items_iter = OrderedWorkerPool(num_workers, stall_timeout).imap(load, indices)
    else:
        items_iter = (load(i) for i in indices)

    masked = mask is not None

    def _emit(batch, bits, ids):
        fields = tuple(
            _stack([item[f] for item in batch]) for f in range(len(batch[0]))
        )
        if masked:
            fields += (np.asarray(bits, bool),)
        if on_batch_ids is not None:
            on_batch_ids(list(ids))
        return fields

    def _note_sub():
        if on_substitute is not None:
            on_substitute()

    prefix_walked = False

    def _seed_from_prefix():
        """The nearest good item before the resume cursor: a quarantined
        item substitutes the nearest preceding good item, which an
        iterator opened at ``start_batch > 0`` has not loaded.  Walking
        the prefix backward (item loads only until the first good one)
        reproduces the uninterrupted epoch's substitute; a fully bad
        prefix returns None, the uninterrupted epoch's own deficit case."""
        nonlocal prefix_walked
        prefix_walked = True
        if prior_positions is None:
            return None
        for p in prior_positions:
            i = int(sampler.take([int(p)])[0])
            item = load(i)
            if item is not QUARANTINED:
                return item, i
        return None

    batch, bits, ids = [], [], []
    last_good = None
    last_good_id = None
    deficit = 0  # quarantined items seen before the first good one
    for pos, item in enumerate(items_iter):
        item_id = int(indices[pos])
        bit = bool(mask[pos]) if masked else True
        if item is QUARANTINED:
            if not masked and not substitute:
                continue
            # Masked or substitute: replace instead of dropping; a masked
            # slot counts as absent, an unmasked one as a substitution.
            if masked:
                bit = False
            if last_good is None and not prefix_walked:
                seeded = _seed_from_prefix()
                if seeded is not None:
                    last_good, last_good_id = seeded
            if last_good is None:
                deficit += 1
                continue
            item, item_id = last_good, last_good_id
            if not masked:
                _note_sub()
        else:
            if deficit:
                # Repay leading quarantined slots now that a good item
                # exists, keeping the item count exact.
                for _ in range(deficit):
                    batch.append(item)
                    bits.append(not masked)
                    ids.append(int(indices[pos]))
                    if not masked:
                        _note_sub()
                    if len(batch) == batch_size:
                        yield _emit(batch, bits, ids)
                        batch, bits, ids = [], [], []
                deficit = 0
            last_good, last_good_id = item, item_id
        batch.append(item)
        bits.append(bit)
        ids.append(item_id)
        if len(batch) == batch_size:
            yield _emit(batch, bits, ids)
            batch, bits, ids = [], [], []
    if batch and not drop_last:  # trailing partial batch
        yield _emit(batch, bits, ids)


def _map(fn, batch):
    """``fn`` over the arrays of a batch: an array, or a dict, tuple or
    list of them."""
    if isinstance(batch, dict):
        return {k: fn(v) for k, v in batch.items()}
    if isinstance(batch, (tuple, list)):
        return type(batch)(fn(v) for v in batch)
    return fn(batch)


def _leaves(batch):
    if isinstance(batch, dict):
        return list(batch.values())
    if isinstance(batch, (tuple, list)):
        return list(batch)
    return [batch]


class _PinnedRing:
    """H2D staging for one CUDA device: ``slots`` sets of pinned host
    buffers, used in turn, each reused only after the copies that last
    read it have completed (its event), and a side stream for the copies.
    Runs on the producer thread."""

    def __init__(self, device: torch.device, slots: int):
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self.slots = [({}, None) for _ in range(slots)]
        self.next = 0

    def _pinned(self, buffers: dict, key: int, a: np.ndarray) -> torch.Tensor:
        dtype = torch.from_numpy(a[:0]).dtype
        buf = buffers.get(key)
        if buf is None or buf.dtype != dtype or buf.shape != a.shape:
            buf = buffers[key] = torch.empty(a.shape, dtype=dtype,
                                             pin_memory=True)
        buf.copy_(torch.from_numpy(a))
        return buf

    def stage(self, batch):
        """The batch on the device, and the event its copies record."""
        buffers, done = self.slots[self.next]
        if done is not None:
            done.synchronize()  # the slot's last copies have read it
        leaves = iter(range(len(_leaves(batch))))

        with torch.cuda.stream(self.stream):
            def to_device(a):
                host = self._pinned(buffers, next(leaves),
                                    np.ascontiguousarray(a))
                out = torch.empty(host.shape, dtype=host.dtype,
                                  device=self.device)
                out.copy_(host, non_blocking=True)
                return out

            staged = _map(to_device, batch)
            event = torch.cuda.Event()
            event.record(self.stream)
        self.slots[self.next] = (buffers, event)
        self.next = (self.next + 1) % len(self.slots)
        return staged, event


def prefetch_to_device(
    iterator: Iterable,
    size: int = 2,
    device=None,
) -> Iterator:
    """Background-thread prefetch of ``size`` batches onto ``device``.

    A batch is a numpy array, or a dict, tuple or list of them; it arrives
    as the same structure of tensors.  On a CUDA device the producer
    thread copies each batch into pinned host buffers from a ring of
    ``size + 1`` sets that it reuses (a set is rewritten only after its
    last copies completed) and issues the host-to-device copies
    ``non_blocking`` on a side stream, recording an event; the consumer
    makes its current stream wait on that event, and marks each tensor as
    used on that stream, before it yields the batch.  On the CPU (the
    default ``device``) the batch arrives as ``torch.from_numpy`` tensors.

    The producer's puts are bounded, so it notices a consumer that stopped
    pulling; an exception in the producer is raised in the consumer; and
    closing the generator joins the producer.
    """
    device = torch.device("cpu" if device is None else device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    q: "queue.Queue" = queue.Queue(maxsize=size)
    sentinel = object()
    stop = threading.Event()

    def _put(item) -> bool:
        # Bounded puts: the producer notices a consumer that stopped
        # pulling (an exception in the step, a generator close()) instead
        # of blocking forever.
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            if device.type == "cuda":
                torch.cuda.set_device(device)
                ring = _PinnedRing(device, size + 1)
                stage = ring.stage
            else:
                stage = lambda batch: (_map(
                    lambda a: torch.from_numpy(np.ascontiguousarray(a)), batch), None)
            # The JAX producer's spans, on this thread's ring: batch_build
            # waits on the source iterator (assembly, augmentation),
            # h2d_stage is the staging call, so a trace tells a consumer
            # starved for data from one starved for staging.
            it = iter(iterator)
            while True:
                with obs.span("batch_build", "data"):
                    try:
                        item = next(it)
                    except StopIteration:
                        break
                with obs.span("h2d_stage", "data"):
                    staged = stage(item)
                if not _put(staged):
                    return
        except BaseException as e:  # re-raised in the consumer below
            _put((sentinel, e))
            return
        _put((sentinel, None))

    thread = threading.Thread(target=producer, name="dwt-prefetch", daemon=True)
    thread.start()
    try:
        while True:
            batch, event = q.get()
            if batch is sentinel:
                if event is not None:
                    # Batch assembly, augmentation or staging failed: the
                    # run must stop, not end early.
                    raise event
                return
            if event is not None:
                current = torch.cuda.current_stream(device)
                current.wait_event(event)
                for t in _leaves(batch):
                    # Allocated on the side stream and used on this one:
                    # the allocator must not hand the memory back to the
                    # side stream before this stream is done with it.
                    t.record_stream(current)
            yield batch
    finally:
        stop.set()  # unblocks the producer; queued batches become garbage
        # close() must not return while the producer still runs inside
        # ``iterator``: the caller closes the underlying epoch generators
        # right after.  _put polls ``stop`` every 0.1 s and one next() or
        # staging is bounded work.
        thread.join()


def stage_into(static, batch) -> None:
    """Copy ``batch`` (a tensor, or a dict of them) into the same-shaped
    ``static`` buffers of a CUDA graph, on the current (compute) stream, one
    fused launch per dtype: the device-to-device step between a prefetched
    chunk and a replay, with no host copy.  ``prefetch_to_device`` made the
    current stream wait for the batch's copies and recorded its tensors on
    that stream, so their memory is not reused before these copies ran."""
    if torch.is_tensor(static):
        static.copy_(batch)
    else:
        torch._foreach_copy_([static[k] for k in batch], [batch[k] for k in batch])
