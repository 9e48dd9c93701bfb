"""Train, stat-collection and eval steps of both recipes, and their k-per-dispatch forms — the single-device core of ``dwt_tpu.train.steps``.

Each factory closes over a model and returns a function that runs on
device tensors and returns device tensors: nothing in a step reads a value
back to the host, so the loop decides when to sync.  Each step sets the
model's mode itself, as the JAX steps pass ``train=`` to ``model.apply``.

**k steps per dispatch.**  The JAX package scans k steps inside one
compiled program (``lax.scan``); the port's counterpart of one compiled
program per dispatch is a captured CUDA graph.  :func:`make_scanned_step`,
:func:`make_scanned_collect` and :func:`make_accum_eval_step` take a chunk
of stacked inputs (a leading axis of up to k) and, on the card with
k ≥ 2, run each of its steps as one replay of ONE captured step on the
current (compute) stream: the step's inputs are copied into the graph's
static buffers, the lr written to its device tensor, the graph replayed,
its outputs copied into slot i of the chunk's ``[n]`` outputs, and
``state.step`` advanced on the host.  One graph of one step, and not one
graph of k bodies per chunk length as the JAX loop caches its programs:
a chunk cut short by an eval or save cadence (lengths 1..k) replays the
same graph, a capture costs one step's worth of graph memory whatever k
is, and the host's work per step is a few launches instead of the step's
hundreds.  The first step of the first chunk runs eagerly on the graph's
side stream, as a real step, before the capture: it builds the kernels'
libraries, the moments kernel's arrival counters, the cached launch grids,
cuDNN's plans and the optimizer's state, none of which may be created
inside a capture.  A graph holds the addresses of the tensors it reads, so
a runner captures again (after another eager step) when any parameter,
buffer, optimizer buffer or device lr was replaced rather than written in
place.  A capture that fails raises: nothing falls back to eager steps.
On the CPU, and at k = 1, the same functions run their steps eagerly, one
by one — the plain version of the graph runner.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from dwt_tpu_torch.data.loader import stage_into
from dwt_tpu_torch.ops import cuda_whitening
from dwt_tpu_torch.ops.losses import (
    at_least_f32,
    entropy_loss,
    mec_loss,
    nll_loss,
    softmax_cross_entropy,
)
from dwt_tpu_torch.train.optim import grads_in_param_dtype, set_learning_rates
from dwt_tpu_torch.train.state import TrainState

Batch = Dict[str, torch.Tensor]
Metrics = Dict[str, torch.Tensor]


def _finite_flag(metrics: Metrics) -> torch.Tensor:
    """Device-side all-finite verdict over loss and grad norm."""
    return torch.isfinite(metrics["loss"]) & torch.isfinite(metrics["grad_norm"])


def _finish_step(state: TrainState, loss: torch.Tensor,
                 metrics: Metrics) -> Metrics:
    """Backward of ``loss``, the global gradient norm and the finite flag
    into ``metrics``, then the optimizer step at the lrs already set."""
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    grads_in_param_dtype(state.model)
    grads = [p.grad for p in state.model.parameters() if p.grad is not None]
    metrics["grad_norm"] = torch.nn.utils.get_total_norm(grads)
    metrics["finite"] = _finite_flag(metrics)
    state.optimizer.step()
    return metrics


def _train_step(body: Callable[[TrainState, Batch], Metrics]
                ) -> Callable[[TrainState, Batch], Metrics]:
    """``body`` (forward, backward, optimizer step: what a graph captures)
    as one train step: the schedules' lrs for ``state.step`` set first,
    ``state.step`` advanced after.  The step keeps ``body`` as ``.body``."""

    def train_step(state: TrainState, batch: Batch) -> Metrics:
        set_learning_rates(state.optimizer, state.schedules, state.step,
                           state.lr_scale)
        metrics = body(state, batch)
        state.step += 1
        return metrics

    train_step.body = body
    return train_step


def make_digits_train_step(
    model: nn.Module, lambda_entropy: float = 0.1
) -> Callable[[TrainState, Batch], Metrics]:
    """Digits (USPS↔MNIST) step: cls on source + λ·entropy on target.

    The reference loop body (``usps_mnist.py:281-308``): the two streams
    stacked ``[2, N, 28, 28, 1]``, one train forward (every norm site's
    running stats advance), ``nll(log_softmax(src), y) + λ·H(tgt)``, the
    global gradient norm, then the Adam step at the schedule's lr for
    ``state.step``.  ``state.step`` advances by one.
    """

    def body(state: TrainState, batch: Batch) -> Metrics:
        model.train()
        logits = model(torch.stack([batch["source_x"], batch["target_x"]]))
        cls = softmax_cross_entropy(logits[0], batch["source_y"])
        ent = lambda_entropy * entropy_loss(logits[1])
        loss = cls + ent
        return _finish_step(state, loss, {
            "loss": loss.detach(), "cls_loss": cls.detach(),
            "entropy_loss": ent.detach()})

    return _train_step(body)


def make_officehome_train_step(
    model: nn.Module, lambda_mec: float = 0.1
) -> Callable[[TrainState, Batch], Metrics]:
    """OfficeHome step: cls on source + λ·MEC between the two target views.

    The reference loop body: the three streams (source, target, augmented
    target) stacked ``[3, N, H, W, C]``, one train forward (every norm
    site's running stats advance), ``nll + λ·MEC(tgt, tgt_aug)``, the
    global gradient norm, then the SGD step at the schedules' lrs for
    ``state.step``.  ``state.step`` advances by one.
    """

    def body(state: TrainState, batch: Batch) -> Metrics:
        model.train()
        x = torch.stack(
            [batch["source_x"], batch["target_x"], batch["target_aug_x"]]
        )
        logits = model(x)
        cls = softmax_cross_entropy(logits[0], batch["source_y"])
        mec = lambda_mec * mec_loss(logits[1], logits[2])
        loss = cls + mec
        return _finish_step(state, loss, {
            "loss": loss.detach(), "cls_loss": cls.detach(),
            "mec_loss": mec.detach()})

    return _train_step(body)


def make_stat_collection_step(
    model: nn.Module, num_domains: int
) -> Callable[[TrainState, torch.Tensor], TrainState]:
    """The post-training stat-collection pass (gradient-free train forward).

    The reference's ``eval_pass_collect_stats``: the model in train mode
    under no_grad, fed the same batch tiled into every domain slot, purely
    to advance the running stats toward the target distribution.  Only
    the stats change.
    """

    @torch.no_grad()
    def collect(state: TrainState, x: torch.Tensor) -> TrainState:
        model.train()
        model(x.unsqueeze(0).expand((num_domains,) + tuple(x.shape)))
        return state

    return collect


def eval_counters(device: torch.device) -> Metrics:
    """Zero device-resident eval accumulators: the reference ``test()``'s
    summed loss, correct count and sample count."""
    return {
        "loss_sum": torch.zeros((), dtype=torch.float32, device=device),
        "correct": torch.zeros((), dtype=torch.int32, device=device),
        "count": torch.zeros((), dtype=torch.int32, device=device),
    }


def make_eval_step(
    model: nn.Module,
) -> Callable[[torch.Tensor, torch.Tensor], Metrics]:
    """Eval step ``(x, y) -> {loss_sum, correct, count}`` of one batch, the
    reference ``test()``'s per-batch sums (``usps_mnist.py:310-327``):
    summed nll in at least f32, correct predictions and the batch size,
    the counts int32.  The callers sum them over a pass."""

    @torch.no_grad()
    def eval_step(x: torch.Tensor, y: torch.Tensor) -> Metrics:
        model.eval()
        logits = model(x)
        logp = F.log_softmax(at_least_f32(logits), dim=-1)
        return {
            "loss_sum": nll_loss(logp, y, reduction="sum"),
            "correct": (logits.argmax(dim=-1) == y).sum(dtype=torch.int32),
            "count": torch.tensor(y.shape[0], dtype=torch.int32,
                                  device=y.device),
        }

    return eval_step


def _eval_deltas(model: nn.Module, x: torch.Tensor, y: torch.Tensor,
                 mask: torch.Tensor) -> Metrics:
    """One eval-mode forward's masked counter deltas: padded rows (the
    loader pads a ragged final batch) add nothing to any counter."""
    model.eval()
    logits = model(x)
    per_sample = nll_loss(F.log_softmax(at_least_f32(logits), dim=-1), y,
                          reduction="none")
    hit = (logits.argmax(dim=-1) == y) & mask
    return {
        "loss_sum": torch.where(mask, per_sample, 0.0).sum(),
        "correct": hit.sum(dtype=torch.int32),
        "count": mask.sum(dtype=torch.int32),
    }


# --------------------------------------------------------- the graph runner


def _chunk_len(chunk) -> int:
    """The leading (steps) axis of a stacked chunk: a tensor, or a dict of
    them."""
    first = chunk if torch.is_tensor(chunk) else next(iter(chunk.values()))
    return int(first.shape[0])


def _row(chunk, i: int):
    return chunk[i] if torch.is_tensor(chunk) else {k: v[i] for k, v in chunk.items()}


def _state_tensors(model: nn.Module, optimizer=None) -> List[torch.Tensor]:
    """Every tensor a captured step reads or writes besides its inputs: the
    model's parameters and persistent buffers, and the optimizer's buffers
    and device lrs."""
    out = list(model.state_dict(keep_vars=True).values())
    if optimizer is not None:
        out += [v for st in optimizer.state.values() for v in st.values()
                if torch.is_tensor(v)]
        out += [g["lr"] for g in optimizer.param_groups if torch.is_tensor(g["lr"])]
    return out


class StepGraph:
    """One step captured as a CUDA graph and replayed, once per step, on
    the current stream (the module docstring).

    :meth:`step` runs one step on ``inputs`` (a tensor or a dict of them,
    on the card): a replay of the graph, with ``inputs`` copied into its
    static buffers first, when a graph exists and the tensors it reads
    (``reads()``) are the ones it captured; otherwise ``eager(inputs)`` on
    the side stream, a real step, then the capture of ``body(static)``
    for the next ones.  Returns the step's outputs — for a replay, the
    graph's own output tensors, which the next replay overwrites.

    ``recorded`` is the hand kernels' launches the capture recorded; each
    replay adds them to the wrappers' counts.  ``replays``,
    ``captures``, ``capture_ms`` and ``pool_bytes`` (the device memory the
    capture took from the allocator) describe the runner."""

    def __init__(self, what: str):
        self.what = what
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.static = None
        self.out = None
        self.recorded = {"apply": 0, "moments": 0}
        self.replays = 0
        self.captures = 0
        self.capture_ms = 0.0
        self.pool_bytes = 0
        self._reads: Sequence[torch.Tensor] = ()
        self._signature = None
        self._stream = None

    @staticmethod
    def _sign(reads: Sequence[torch.Tensor]):
        return tuple(t.data_ptr() for t in reads)

    def step(self, inputs, reads: Callable[[], Sequence[torch.Tensor]],
             eager: Callable, body: Callable,
             before_replay: Optional[Callable] = None):
        if self.graph is not None and self._sign(reads()) == self._signature:
            if before_replay is not None:
                before_replay()
            stage_into(self.static, inputs)
            self.graph.replay()
            cuda_whitening.count_replay(self.recorded)
            self.replays += 1
            return self.out
        return self._capture(inputs, reads, eager, body)

    def _capture(self, inputs, reads, eager: Callable, body: Callable):
        device = (inputs if torch.is_tensor(inputs) else next(iter(inputs.values()))).device
        current = torch.cuda.current_stream(device)
        if self._stream is None:
            self._stream = torch.cuda.Stream(device)
        side = self._stream
        self.graph = self.out = None
        side.wait_stream(current)
        with torch.cuda.stream(side):
            result = eager(inputs)
        static = (torch.empty_like(inputs) if torch.is_tensor(inputs)
                  else {k: torch.empty_like(v) for k, v in inputs.items()})
        stage_into(static, inputs)
        t0 = time.perf_counter()
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()  # as the capture does: the pool's bytes alone
        free0 = torch.cuda.mem_get_info(device)[0]
        graph = torch.cuda.CUDAGraph()
        try:
            # thread_local: the loader's prefetch thread and the checkpoint
            # writer keep staging and copying on their own streams while this
            # thread captures; only this thread's calls are held to it.
            with cuda_whitening.capture_launches() as recorded:
                with torch.cuda.graph(graph, stream=side,
                                      capture_error_mode="thread_local"):
                    out = body(static)
        except RuntimeError as e:
            raise RuntimeError(
                f"CUDA graph capture of the {self.what} failed (no eager "
                f"fallback): {e}") from e
        self.pool_bytes = max(free0 - torch.cuda.mem_get_info(device)[0], 0)
        self.capture_ms = (time.perf_counter() - t0) * 1e3
        current.wait_stream(side)
        self.graph, self.static, self.out = graph, static, out
        self.recorded = dict(recorded)
        # Read after the eager step (it may have created the optimizer's
        # state); kept alive, since the graph holds their addresses.
        self._reads = list(reads())
        self._signature = self._sign(self._reads)
        self.captures += 1
        return result


def stack_batches(batches: Sequence[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    """Stack host batches (dicts of numpy arrays) on a new leading axis,
    the chunk :func:`make_scanned_step` takes (one batch: views, no copy)."""
    if len(batches) == 1:
        return {k: v[None] for k, v in batches[0].items()}
    return {k: np.stack([b[k] for b in batches]) for k in batches[0]}


def make_scanned_step(
    train_step: Callable[[TrainState, Batch], Metrics], k: int,
) -> Callable[[TrainState, Batch], Metrics]:
    """Up to ``k`` train steps per dispatch: ``scanned(state, chunk)`` takes
    a batch dict whose tensors carry a leading axis of ``n ≤ k`` stacked
    batches and returns the steps' metrics stacked ``[n]``, so the loop
    logs every inner step as if it ran alone.  ``state.step`` advances by
    ``n``.

    On the card each step is a replay of one captured step
    (:class:`StepGraph`; the module docstring), whose lr the host writes
    before the replay, so a milestone or a backoff between two replays
    reaches the step it applies to.  On the CPU, and at ``k = 1``, the
    steps run eagerly, one by one.  The runner is ``scanned.graph``."""
    if k < 1:
        raise ValueError(f"steps_per_dispatch must be >= 1, got {k}")
    graph = StepGraph("train step")

    def scanned(state: TrainState, chunk: Batch) -> Metrics:
        n = _chunk_len(chunk)
        if n > k:
            raise ValueError(f"a chunk of {n} steps exceeds steps_per_dispatch={k}")
        if not next(iter(chunk.values())).is_cuda or k < 2:
            rows = [train_step(state, _row(chunk, i)) for i in range(n)]
            return {key: torch.stack([r[key] for r in rows]) for key in rows[0]}
        reads = lambda: _state_tensors(state.model, state.optimizer)
        out = None
        for i in range(n):

            def before_replay():
                set_learning_rates(state.optimizer, state.schedules, state.step,
                                   state.lr_scale)

            metrics = graph.step(_row(chunk, i), reads,
                                 eager=lambda b: train_step(state, b),
                                 body=lambda b: train_step.body(state, b),
                                 before_replay=before_replay)
            if graph.out is metrics:
                state.step += 1
            if out is None:
                out = {key: torch.empty((n,) + tuple(v.shape), dtype=v.dtype,
                                        device=v.device)
                       for key, v in metrics.items()}
            stage_into({key: v[i] for key, v in out.items()}, metrics)
        return out

    scanned.graph = graph
    return scanned


def make_scanned_collect(
    collect: Callable[[TrainState, torch.Tensor], TrainState], k: int,
) -> Callable[[TrainState, torch.Tensor], TrainState]:
    """Up to ``k`` stat-collection forwards per dispatch over ``xs [n, N,
    ...]``: only the running stats advance.  On the card with ``k ≥ 2``
    each forward is a replay of one captured forward; else they run
    eagerly, one by one.  The runner is ``scanned.graph``."""
    graph = StepGraph("stat-collection forward")

    def scanned(state: TrainState, xs: torch.Tensor) -> TrainState:
        n = _chunk_len(xs)
        if n > k:
            raise ValueError(f"a chunk of {n} batches exceeds eval_steps_per_dispatch={k}")
        if not xs.is_cuda or k < 2:
            for i in range(n):
                collect(state, xs[i])
            return state
        reads = lambda: _state_tensors(state.model)
        for i in range(n):
            graph.step(xs[i], reads, eager=lambda x: collect(state, x),
                       body=lambda x: collect(state, x))
        return state

    scanned.graph = graph
    return scanned


def make_accum_eval_step(
    model: nn.Module, k: int = 1,
) -> Callable[[Metrics, Dict[str, torch.Tensor]], Metrics]:
    """Accumulating eval dispatch: ``(counters, chunk) -> counters``.

    ``chunk`` stacks up to ``k`` batches — ``{"x": [n, N, ...], "y": [n,
    N], "mask": [n, N] bool}`` — and the result is ``counters`` plus the
    chunk's masked deltas, added batch by batch in order, so the counters
    are bitwise those of one batch per dispatch.  ``mask`` marks real
    samples: padded rows add nothing to any counter, so counts stay exact.

    On the card with ``k ≥ 2`` each batch is a replay of one captured
    forward that adds its deltas into the runner's device accumulators.
    The graph reads the sites' eval matrices from tensors of its own:
    each pass installs a new cache (``install_eval_matrix`` rebinds
    ``site.eval_matrix``), which a dispatch copies into them in place
    before it replays.  Else the batches run eagerly.  The runner is
    ``accum_eval.graph``."""
    from dwt_tpu_torch.nn.norms import install_eval_matrix, whitening_sites

    graph = StepGraph("eval forward")
    acc: Metrics = {}
    matrices: Dict[str, Optional[torch.Tensor]] = {}

    def add(deltas: Metrics) -> Metrics:
        for key, value in deltas.items():
            acc[key].add_(value)
        return acc

    def adopt_eval_matrices() -> List[torch.Tensor]:
        """Install the graph's own eval matrices, holding this pass's cache;
        returns the tensors the forward reads beside the model's."""
        reads = []
        for name, site in whitening_sites(model).items():
            w, mine = site.eval_matrix, matrices.get(name)
            if w is not None and w is not mine:
                if mine is not None and mine.shape == w.shape:
                    mine.copy_(w)
                else:
                    matrices[name] = mine = w
                install_eval_matrix(site, mine)
            # No cache installed: the forward factorizes from the stats.
            reads.append(torch.empty(0) if site.eval_matrix is None else mine)
        return reads

    @torch.no_grad()
    def accum_eval(counters: Metrics, chunk: Dict[str, torch.Tensor]) -> Metrics:
        n = _chunk_len(chunk)
        if n > k:
            raise ValueError(f"a chunk of {n} batches exceeds eval_steps_per_dispatch={k}")
        if not chunk["x"].is_cuda or k < 2:
            for i in range(n):
                deltas = _eval_deltas(model, chunk["x"][i], chunk["y"][i],
                                      chunk["mask"][i])
                counters = {key: counters[key] + deltas[key] for key in counters}
            return counters
        if not acc:
            acc.update({key: torch.empty_like(v) for key, v in counters.items()})
        stage_into(acc, counters)
        matrices_read = adopt_eval_matrices()
        reads = lambda: _state_tensors(model) + matrices_read
        for i in range(n):
            graph.step(_row(chunk, i), reads,
                       eager=lambda b: add(_eval_deltas(model, b["x"], b["y"], b["mask"])),
                       body=lambda b: add(_eval_deltas(model, b["x"], b["y"], b["mask"])))
        return {key: v.clone() for key, v in acc.items()}

    accum_eval.graph = graph
    return accum_eval
