"""The server's fan-out over ranks: a front rank, follower ranks, one ordered stream.

The JAX server is one process that fans each bucket over the devices it
sees (``ServeEngine(plan=...)``).  The port runs one process per device
(``dwt_tpu_torch.parallel``), so serving across devices takes two kinds
of rank, launched like the trainers (``--distributed``, the DWT_* or
torchrun variables):

* the **front** (rank 0) owns HTTP, the batcher, the access log and the
  deploy plane (canary, reloader, adapter); its engine is a
  :class:`FanoutEngine`, which gives the server and the fleet the
  :class:`~dwt_tpu_torch.serve.engine.ServeEngine` surface over every rank;
* each **follower** has no HTTP port, only :func:`follow`: a loop that
  runs the front's operations in the order the front issued them.

**One ordered stream.**  Every operation the front issues goes through one
:class:`Channel`, under one lock, in one order: the dispatcher thread, the
reloader, the adapter, the canary and ``/fanout`` each reach the engine
from their own threads, and two threads issuing collectives on one group
in different orders would deadlock it.  An operation is a header (a
pickled dict broadcast from the front) and, for some, a collective of
host tensors on the group's gloo group (``parallel.mesh.host_group``):

* ``forward(gen, bucket)``: the front scatters the padded bucket's rows,
  one block per rank in the plan's order (``ShardingPlan.serve_split``:
  under the replica plan each rank its own block, under a gspmd plan the
  ranks of one model group the same block), each rank stages and forwards
  its block with generation ``gen`` — under gspmd the placed module's
  hooks gather its blocks over the model group inside this operation —
  and the front gathers the logits as host tensors
  (``ShardingPlan.serve_join``).  The bucket starts on the host and the
  logits end there, so the wire adds no device sync to the dispatcher's
  one;
* ``build(gen, spec)``: each follower builds generation ``gen`` on a build
  thread of its own — a checkpoint it restores itself (``{"path",
  "step", "digest"}``: to spec under gspmd) or an adapted generation from
  the front's folded stats over a base generation (``{"base", "stats"}``)
  — while its loop goes on serving; ``status(gen)`` gathers every rank's
  progress, and the front submits the generation only once every rank
  built it and agrees on its version;
* ``swap(gen)``, ``drop(gens)``: the live generation, and generations no
  rank will serve again (the front keeps the live one, the rollback
  buffer and the candidates in flight);
* ``gather(gen)`` (gspmd): the generation's whole parameters, for the
  front's adapter, whose collect forward runs unsharded as JAX's does;
* ``report``: every rank's live generation, forwards, kernel launches,
  resident bytes, and on request its generation digest and local shapes
  (``GET /fanout``);
* ``hello``, ``noop`` (the heartbeat that keeps an idle follower's wait
  inside ``DWT_DIST_TIMEOUT_S``) and ``stop``.

Followers hold their generations keyed by the front's id, and every
forward names its generation, so a swap lands on every rank at the batch
boundary the front's dispatcher chose: an access record's ``version`` is
the generation every rank computed with.

**Failure.**  A follower that dies breaks the group: the front's next
operation fails (at the latest after ``DWT_DIST_TIMEOUT_S``), that
batch's requests get error replies, the channel stays broken (every
later operation raises :class:`RankLost`), ``/healthz`` turns unhealthy
and the front drains and exits nonzero.  A follower whose front stops
answering fails its wait the same way and exits nonzero; a follower that
gets SIGTERM keeps serving until the front's ``stop``, so a signal to the
whole group (torchrun's) still drains cleanly.

Imports torch and numpy only.
"""

from __future__ import annotations

import contextlib
import logging
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from dwt_tpu_torch.ops import cuda_whitening
from dwt_tpu_torch.parallel.mesh import DEFAULT_TIMEOUT_S, RankGroup, process_index
from dwt_tpu_torch.serve.batcher import bucket_for, pad_to_bucket
from dwt_tpu_torch.serve.engine import EngineState, ServeEngine, Version
from dwt_tpu_torch.utils.checkpoint import params_digest

log = logging.getLogger(__name__)

# Seconds between status polls while the followers build a generation.
BUILD_POLL_S = 0.02


class RankLost(RuntimeError):
    """The fan-out's group broke: a rank died or stopped answering."""


def _timeout_s() -> float:
    import os

    return float(os.environ.get("DWT_DIST_TIMEOUT_S", DEFAULT_TIMEOUT_S))


class Channel:
    """The front's end of the stream over ``group`` (every rank, the gloo
    group).  :meth:`op` is the one way to issue an operation; the first
    failure is kept as :attr:`fault` and every later operation raises
    :class:`RankLost`.  A heartbeat thread issues ``noop`` when the stream
    has been quiet for a quarter of the collective timeout."""

    def __init__(self, group: RankGroup):
        self.group = group
        self.fault: Optional[BaseException] = None
        self._lock = threading.Lock()
        self._last = time.monotonic()
        self.heartbeat_s = max(0.25, min(30.0, _timeout_s() / 4))
        self._closed = threading.Event()
        self._beat = threading.Thread(target=self._heartbeat, name="dwt-fanout-heartbeat",
                                      daemon=True)
        self._beat.start()

    @contextlib.contextmanager
    def op(self, kind: str, **fields):
        """Issue one operation: broadcast its header, then run the body
        (the front's side of its collectives) under the stream's lock."""
        with self._lock:
            if self.fault is not None:
                raise RankLost(f"the serving fan-out lost a rank: {self.fault}")
            try:
                self.group.broadcast_object({"op": kind, **fields})
                yield self.group
            except BaseException as e:
                # The followers are out of step with this stream now.
                self.fault = e
                log.error("fanout: %s failed; the group is broken: %s", kind, e)
                raise
            finally:
                self._last = time.monotonic()

    def _heartbeat(self) -> None:
        while not self._closed.wait(self.heartbeat_s / 4):
            if self.fault is None and time.monotonic() - self._last > self.heartbeat_s:
                try:
                    with self.op("noop"):
                        pass
                except Exception:
                    return

    def close(self) -> None:
        """Stop the heartbeat and, unless the group broke, the followers."""
        self._closed.set()
        self._beat.join(timeout=10)
        if self.fault is None:
            with self.op("stop"):
                pass


def _rank_report(engine: ServeEngine, state: EngineState, forwards: int,
                 digest: bool, shapes: bool) -> dict:
    """One rank's ``report`` entry for its live generation ``state``."""
    plan = engine.plan
    nbytes = lambda t: t.numel() * t.element_size()
    resident = sum(nbytes(t) for t in state.params.values())
    layout = getattr(state.model, "_gspmd_layout", None)
    full = resident if layout is None else sum(
        int(np.prod(layout.leaves[n].full_shape)) * t.element_size()
        for n, t in state.params.items())
    out = {"rank": process_index(), "gen": state.gen, "version": state.version.label,
           "forwards": forwards, "resident_param_bytes": resident,
           "full_param_bytes": full,
           "kernel_launches": {"apply": cuda_whitening.apply_launches,
                               "moments": cuda_whitening.moments_launches}}
    if plan.mode == "gspmd":
        out["coords"] = list(plan.mesh.coords)
    if digest:
        out["digest"] = generation_digest(state)
    if shapes:
        out["shapes"] = {n: list(t.shape) for n, t in state.params.items()}
    return out


def _hello(engine: ServeEngine) -> dict:
    """What every rank must agree on before the front serves."""
    return {"buckets": list(engine.buckets), "version": engine.version.label,
            "mode": engine.plan.mode, "shape": list(engine.input_shape)}


def whole_params(state: EngineState) -> Dict[str, torch.Tensor]:
    """A generation's parameters as whole tensors: a gspmd rank's blocks
    gathered over the model group (a collective: every rank calls it for
    the same generation, inside one ``gather``, ``report`` or ``forward``
    operation)."""
    layout = getattr(state.model, "_gspmd_layout", None)
    if layout is None:
        return dict(state.params)
    return {n: layout.gather_block(layout.leaves[n], t) if layout.leaves[n].sharded else t
            for n, t in state.params.items()}


def generation_digest(state: EngineState) -> str:
    """SHA-256 of a generation's whole parameters, stats and eval
    matrices (equal on every rank that holds the same generation)."""
    named = list(whole_params(state).items()) + list(state.batch_stats.items()) + [
        (f"{k}.eval_matrix", w) for k, w in state.cache.items()]
    return params_digest(named)


class FanoutEngine:
    """The front rank's engine: the :class:`ServeEngine` surface the
    server, the batcher and the deploy plane read, over every rank of the
    plan.  ``local`` is the front's own rank engine (its ``plan`` the
    run's), ``group`` every rank over gloo (``parallel.mesh.host_group``);
    the followers must be in :func:`follow`.  Generations the front
    builds are numbered (``EngineState.gen``) and built on every rank
    before they are returned; forwards, swaps and drops go through the
    :class:`Channel`."""

    def __init__(self, local: ServeEngine, group: RankGroup):
        self.local = local
        self.plan = local.plan
        self.channel = Channel(group)
        self._next_gen = 1
        self._held = {0}                 # generations the ranks hold
        self._pending: set = set()       # built on every rank, not yet submitted
        self._forwards = 0
        with self.channel.op("hello") as g:
            ranks = g.gather_object(_hello(local))
        mine = ranks[0]
        odd = [r for r in ranks if r != mine]
        if odd:
            raise RuntimeError(f"serving ranks disagree at start: {mine} against {odd}")
        log.info("fanout: %d ranks under the %s plan, buckets %s, version %s",
                 len(ranks), self.plan.describe(), local.buckets, local.version.label)

    # ----------------------------------------------------- read-through

    @property
    def fault(self) -> Optional[BaseException]:
        return self.channel.fault

    @property
    def buckets(self):
        return self.local.buckets

    @property
    def input_shape(self):
        return self.local.input_shape

    @property
    def input_dtype(self):
        return self.local.input_dtype

    @property
    def device(self):
        return self.local.device

    @property
    def source(self):
        return self.local.source

    @property
    def quantize(self):
        return self.local.quantize

    @property
    def num_domains(self):
        return self.local.num_domains

    @property
    def warmup_s(self):
        return self.local.warmup_s

    @property
    def swap_count(self):
        return self.local.swap_count

    @property
    def state(self) -> EngineState:
        return self.local.state

    @property
    def version(self) -> Version:
        return self.local.version

    @property
    def step(self):
        return self.local.step

    @property
    def model(self):
        return self.local.model

    def fresh_model(self):
        return self.local.fresh_model()

    def stage_rows(self, x: np.ndarray) -> torch.Tensor:
        """Host rows onto the front's device (the adapter's collect)."""
        return self.local.stage_rows(x)

    # ------------------------------------------------------- inference

    def stage(self, x: np.ndarray) -> np.ndarray:
        """The bucket stays on the host: :meth:`forward` scatters it."""
        return np.ascontiguousarray(x, np.float32)

    def forward(self, x: np.ndarray, bucket: int,
                state: Optional[EngineState] = None) -> torch.Tensor:
        """One bucket's logits (a host tensor) over every rank, with
        generation ``state`` (default the live one)."""
        st = self.local.state if state is None else state
        bucket = int(bucket)
        if bucket not in self.local.buckets:
            raise ValueError(f"no warmed forward for bucket {bucket} "
                             f"(buckets: {self.local.buckets})")
        x = np.ascontiguousarray(x, np.float32)
        if tuple(x.shape) != (bucket,) + self.local.input_shape:
            raise ValueError(f"batch {tuple(x.shape)} is not bucket {bucket}'s")
        blocks = [torch.from_numpy(np.ascontiguousarray(b)) for b in self.plan.serve_split(x)]
        with self.channel.op("forward", gen=st.gen, bucket=bucket) as g:
            mine = g.scatter_host(blocks, blocks[0].shape)
            logits = self.local.forward(self.local.stage(mine.numpy()), bucket,
                                        state=st).cpu()
            parts = g.gather_host(logits)
            self._forwards += 1
        return self.plan.serve_join(parts)

    def infer(self, x: np.ndarray, bucket: Optional[int] = None,
              state: Optional[EngineState] = None) -> np.ndarray:
        """Pad → fan-out forward → the real rows' logits (the canary's
        fixture eval of a candidate runs here)."""
        x = np.asarray(x, np.float32)
        n = x.shape[0]
        if bucket is None:
            bucket = bucket_for(n, self.buckets)
        elif n < 1 or n > bucket:
            raise ValueError(f"got {n} samples for bucket {bucket}")
        return self.forward(pad_to_bucket(x, bucket), bucket, state).numpy()[:n]

    # ----------------------------------------------------- generations

    def _build(self, spec: dict, build_local) -> EngineState:
        """Build one generation on every rank: the followers from
        ``spec`` on their build threads, the front by ``build_local()``;
        raise (and drop it everywhere) unless all built it with one
        version."""
        gen = self._next_gen
        self._next_gen += 1
        with self.channel.op("build", gen=gen, spec=spec):
            pass
        try:
            state = build_local()._replace(gen=gen)
            mine = {"state": "ok", "version": state.version.label}
            while True:
                with self.channel.op("status", gen=gen) as g:
                    ranks = g.gather_object(mine)
                if all(r["state"] != "pending" for r in ranks):
                    break
                time.sleep(BUILD_POLL_S)
            bad = {i: r for i, r in enumerate(ranks) if r != mine}
            if bad:
                raise ValueError(f"generation {gen} did not build alike on every rank: "
                                 f"{mine} on the front, {bad}")
        except Exception:
            if self.fault is None:
                self._drop([gen])
            raise
        self._held.add(gen)
        self._pending.add(gen)
        return state

    def build_state_from_checkpoint(self, path: str, *,
                                    version: Optional[Version] = None) -> EngineState:
        """A checkpoint candidate, restored by every rank itself."""
        spec = {"path": path, "step": None if version is None else version.step,
                "digest": None if version is None else version.digest}
        return self._build(spec, lambda: self.local.build_state_from_checkpoint(
            path, version=version))

    def build_state_from_stats(self, base: EngineState, batch_stats: Dict, *,
                               version: Version) -> EngineState:
        """An adapted generation: the folded stats (host arrays) travel,
        every rank reuses its own copy of ``base``'s parameters."""
        stats = {k: (v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v))
                 for k, v in batch_stats.items()}
        spec = {"base": base.gen, "stats": stats, "step": version.step,
                "digest": version.digest}
        return self._build(spec, lambda: self.local.build_state_from_stats(
            base, stats, version=version))

    def _drop(self, gens: List[int]) -> None:
        if gens:
            with self.channel.op("drop", gens=list(gens)):
                pass

    def swap(self, state: EngineState) -> EngineState:
        """Make ``state`` live on every rank; returns the previous one.
        Generations neither live nor the previous nor a candidate in flight
        are dropped everywhere."""
        with self.channel.op("swap", gen=state.gen):
            prev = self.local.swap(state)
        self._pending.discard(state.gen)
        self._release(keep={state.gen, prev.gen})
        return prev

    def discard(self, state: EngineState) -> None:
        """A candidate that will not go live (the canary refused it)."""
        self._pending.discard(state.gen)
        self._release(keep={self.local.state.gen})

    def _release(self, keep: set) -> None:
        gone = self._held - keep - self._pending
        self._held -= gone
        self._drop(sorted(gone))

    def full_params(self, state: EngineState):
        """``(whole parameters, int8 scales or None)`` of ``state`` for the
        adapter's collect; under gspmd a ``gather`` over every rank."""
        if self.plan.mode != "gspmd":
            return self.local.full_params(state)
        with self.channel.op("gather", gen=state.gen):
            return whole_params(state), state.scales

    # ---------------------------------------------------------- report

    def report(self, digest: bool = False, shapes: bool = False) -> dict:
        """``GET /fanout``: the plan and every rank's entry (live
        generation, forwards, kernel launches, resident parameter bytes;
        with ``digest`` its generation digest, with ``shapes`` its local
        parameter shapes)."""
        with self.channel.op("report", digest=digest, shapes=shapes) as g:
            ranks = g.gather_object(_rank_report(self.local, self.local.state,
                                                 self._forwards, digest, shapes))
        return {"plan": self.plan.describe(), "mode": self.plan.mode,
                "data_size": self.plan.data_size, "ranks": ranks}

    def close(self) -> None:
        """Stop the followers (after the front's drain)."""
        self.channel.close()


class _Builds:
    """A follower's builds, by generation id: in flight (no entry in
    ``done`` yet), built (the state) or failed (the exception).  A build
    dropped before it finished leaves nothing behind."""

    def __init__(self):
        self.done: Dict[int, object] = {}
        self._dropped: set = set()
        self._lock = threading.Lock()

    def start(self, gen: int, fn) -> None:
        def run():
            try:
                out = fn()._replace(gen=gen)
            except Exception as e:  # reported through the stream
                log.warning("fanout: build of generation %d failed: %s", gen, e)
                out = e
            with self._lock:
                if gen not in self._dropped:
                    self.done[gen] = out

        threading.Thread(target=run, name=f"dwt-fanout-build-{gen}", daemon=True).start()

    def drop(self, gen: int) -> None:
        with self._lock:
            self._dropped.add(gen)
            self.done.pop(gen, None)

    def status(self, gen: int) -> dict:
        if gen not in self.done:
            return {"state": "pending"}
        out = self.done[gen]
        if isinstance(out, Exception):
            return {"state": "error", "error": f"{type(out).__name__}: {out}"}
        return {"state": "ok", "version": out.version.label}


def follow(engine: ServeEngine, group: RankGroup) -> int:
    """A follower's loop: run the front's operations in order until
    ``stop`` (returns 0); a broken stream or a failed operation returns 1
    (the front sees the group break)."""
    gens: Dict[int, EngineState] = {0: engine.state}
    builds = _Builds()
    forwards = 0
    try:
        while True:
            hdr = group.broadcast_object(None)
            op = hdr["op"]
            if op == "forward":
                bucket = hdr["bucket"]
                x = group.scatter_host(None, (engine.block_rows(bucket),) + engine.input_shape)
                logits = engine.forward(engine.stage(x.numpy()), bucket,
                                        state=gens[hdr["gen"]]).cpu()
                group.gather_host(logits)
                forwards += 1
            elif op == "build":
                spec, gen = hdr["spec"], hdr["gen"]
                version = Version(spec["step"], spec["digest"])
                if "path" in spec:
                    builds.start(gen, lambda p=spec["path"], v=version:
                                 engine.build_state_from_checkpoint(p, version=v))
                else:
                    base = gens[spec["base"]]
                    builds.start(gen, lambda b=base, s=spec["stats"], v=version:
                                 engine.build_state_from_stats(b, s, version=v))
            elif op == "status":
                gen = hdr["gen"]
                status = builds.status(gen)
                if status["state"] == "ok":
                    gens[gen] = builds.done[gen]
                group.gather_object(status)
            elif op == "swap":
                engine.swap(gens[hdr["gen"]])
            elif op == "drop":
                for gen in hdr["gens"]:
                    gens.pop(gen, None)
                    builds.drop(gen)
            elif op == "gather":
                whole_params(gens[hdr["gen"]])
            elif op == "report":
                group.gather_object(_rank_report(engine, engine.state, forwards,
                                                 hdr["digest"], hdr["shapes"]))
            elif op == "hello":
                group.gather_object(_hello(engine))
            elif op == "stop":
                log.info("fanout: rank %d stopped by the front after %d forwards",
                         process_index(), forwards)
                return 0
            elif op != "noop":
                raise ValueError(f"unknown fan-out operation {op!r}")
    except Exception:
        log.exception("fanout: rank %d lost the stream", process_index())
        return 1
