"""Replica-mode data parallelism — the port of ``dwt_tpu.parallel.dp``.

The JAX package writes each step once, as a per-replica function with an
optional ``axis_name``, and ``shard_map``s it over a mesh.  The port has
no ``shard_map``: every rank is a process that runs the same per-replica
step on its own slice of the batch, with the three in-step collectives
explicit, as the JAX wrapper's are:

* the batch moments of every whitened and BN site, combined into the
  global batch's inside the ops (``ops.whitening``, ``ops.batch_norm``,
  ``ops.cuda_whitening.TrainWhiten``);
* gradient averaging inside the train step, after backward, in one flat
  buffer (``train.steps``), and the metrics averaged;
* the eval counters summed inside the eval step.

So each step is built with the mesh as its ``group`` (the port's
``axis_name``), and the wrappers here check that it was and pick the
dispatch: a step whose collectives run over NCCL can be captured as a
CUDA graph, one over gloo cannot and runs its chunk's steps eagerly.
Every rank's state is the same: :func:`replicate_state` broadcasts rank
0's at the start, and the collectives keep it so.

:func:`shard_batch` takes this rank's slice of a host batch — the rows
that ``NamedSharding(mesh, P(axes))`` places on the device at this rank's
grid position; the training loops never need it, since each process
loads only its own slice (``batch_iterator(shard=(rank, N))``).
:func:`make_sharded_serve_forward` is the serving fan-out's per-rank
forward over a bucket's block.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from dwt_tpu_torch.parallel.mesh import Mesh


def _slice(a, index: int, count: int, axis: int):
    n = a.shape[axis]
    if n % count:
        raise ValueError(
            f"a batch axis of {n} does not split over {count} mesh positions")
    size = n // count
    sl = [slice(None)] * a.ndim
    sl[axis] = slice(index * size, (index + 1) * size)
    return a[tuple(sl)]


def slice_batch(batch: Any, index: int, count: int, chunked: bool = False) -> Any:
    """Block ``index`` of ``count`` of every leaf of ``batch`` (numpy
    arrays or tensors; a dict, tuple or list of them) along the leading
    axis (``chunked=True``: the second axis, leaves ``[k, batch, ...]``)."""
    if isinstance(batch, dict):
        return {k: slice_batch(v, index, count, chunked) for k, v in batch.items()}
    if isinstance(batch, (tuple, list)):
        return type(batch)(slice_batch(v, index, count, chunked) for v in batch)
    return _slice(batch, index, count, int(chunked))


def shard_batch(batch: Any, mesh: Mesh, chunked: bool = False) -> Any:
    """This rank's slice of every leaf of ``batch``: the leading axis split
    into ``mesh.size`` equal blocks, block ``mesh.index`` kept
    (:func:`slice_batch`)."""
    return slice_batch(batch, mesh.index, mesh.size, chunked)


def replicate_state(state, mesh: Mesh):
    """Broadcast the model's parameters and buffers and the optimizer's
    tensors from the first rank of ``mesh`` (or of a ``RankGroup``), in
    place; returns ``state``.  The
    ranks build their models from one seed, so this changes nothing on a
    fresh run — it makes a start from diverging inputs impossible."""
    tensors = list(state.model.state_dict().values())
    if state.optimizer is not None:
        tensors += [v for st in state.optimizer.state.values() for v in st.values()
                    if torch.is_tensor(v)]
    with torch.no_grad():
        for t in tensors:
            mesh.broadcast_(t)
    return state


def _check_group(fn: Callable, mesh: Mesh, what: str) -> Callable:
    group = getattr(fn, "group", None)
    if group is not mesh:
        raise ValueError(
            f"the {what} was not built with this mesh as its group (got "
            f"{group!r}): build it with group=mesh so that its moments, "
            "gradients and counters are reduced over the mesh")
    return fn


def make_sharded_train_step(train_step: Callable, mesh: Mesh) -> Callable:
    """``train_step`` (``steps.make_*_train_step(model, ..., group=mesh)``)
    as the replica step: ``(state, local batch) -> metrics``, the metrics
    the global batch's on every rank."""
    return _check_group(train_step, mesh, "train step")


def make_sharded_scanned_step(train_step: Callable, mesh: Mesh, k: int) -> Callable:
    """The replica step over chunks of up to ``k`` local batches
    (``[k, batch, ...]``): replays of a captured step where the mesh's
    collectives can be captured (NCCL), else each chunk's steps eagerly
    (gloo) — a decision taken here, from the backend."""
    from dwt_tpu_torch.train.steps import make_scanned_step

    _check_group(train_step, mesh, "train step")
    scanned = make_scanned_step(train_step, k, capture=mesh.capturable)
    scanned.group = mesh
    return scanned


def make_sharded_eval_step(accum_eval: Callable, mesh: Mesh) -> Callable:
    """``steps.make_accum_eval_step(model, k, group=mesh)``: each rank
    forwards its slice of every eval batch and the counter deltas are
    summed over the mesh, so every rank holds the global counters."""
    return _check_group(accum_eval, mesh, "eval step")


def make_sharded_collect_step(scanned_collect: Callable, mesh: Mesh) -> Callable:
    """A stat-collection dispatch whose model's sites carry the mesh:
    each rank forwards its slice and the sites' moments are the global
    batch's, so every rank's running stats advance alike."""
    return _check_group(scanned_collect, mesh, "stat-collection step")


def make_sharded_serve_forward(forward: Callable, mesh: Mesh) -> Callable:
    """The replica fan-out's per-rank serving body: ``forward(model, x)``
    (the eval forward) on this rank's block of each bucket, the bucket's
    rows split into ``mesh.size`` equal blocks in the mesh's flattened
    order (``dwt_tpu.parallel.dp._batch_spec``; ``ShardingPlan.
    serve_split``).  Eval forwards are per-sample (running stats, no batch
    moments), so the body needs no collective and is ``forward`` itself;
    the serving front gathers the ranks' logits in the same order
    (``dwt_tpu_torch.serve.fanout``).  Bucket sizes must divide the mesh
    (``serve.engine`` rounds them up)."""
    return forward
