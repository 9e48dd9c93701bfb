"""Eval and stat-collection passes — the single-device core of ``dwt_tpu.train.evalpipe``.

* **once-per-pass factorization**: eval-mode whitening matrices are
  factorized from the frozen running stats, every site's groups stacked
  into one batched call (:func:`make_whiten_cache`, the counterpart of
  ``make_whiten_cache_fn``), and installed into the sites for the pass;
  the serving engine builds its cache with the same function;
* **device-resident counters**: the three eval counters stay on the device
  across the whole pass and are read back once at its end;
* **k batches per dispatch** (``eval_steps_per_dispatch``): batches are
  grouped into chunks of up to k (:func:`chunk_groups`), and on the card
  with k ≥ 2 each batch of a chunk is a replay of one captured forward
  (``steps.make_accum_eval_step``, ``steps.make_scanned_collect``); the
  graphs live as long as the pipeline, and each pass's eval matrices are
  copied into the ones the eval graph reads;
* **exact counts**: eval batches are padded and masked, so the ragged
  tail adds nothing it should not;
* **stat collection** (the OfficeHome protocol): un-padded batches —
  padding would perturb the batch moments the pass exists to estimate —
  so the ragged tail is a chunk of its own, an eager forward (JAX's
  ``_collect_tail``).

Batches come from ``batch_iterator`` with the JAX pipeline's seeds,
epochs and worker count (an item's random crop draws from its token
``(seed, epoch, index)``: ``(0, 0, i)`` in an eval pass, ``(seed, pass,
i)`` in a collection pass) and reach the device through
``prefetch_to_device``.  The passes open the JAX pipeline's spans
(``whiten_cache_build``, ``eval_batch_wait``, ``eval_dispatch``,
``eval_host_fetch``, ``collect_batch_wait``, ``collect_dispatch``).  Mesh
sharding is not ported yet.
"""

from __future__ import annotations

import time
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from dwt_tpu_torch import obs
from dwt_tpu_torch.data.loader import batch_iterator, prefetch_to_device
from dwt_tpu_torch.nn.norms import install_eval_matrix, whitening_sites
from dwt_tpu_torch.ops.whitening import WHITEN_CACHE_COL, build_whiten_cache
from dwt_tpu_torch.train.state import TrainState
from dwt_tpu_torch.utils.metrics import percentile_summary
from dwt_tpu_torch.train.steps import (
    eval_counters,
    make_accum_eval_step,
    make_scanned_collect,
    make_stat_collection_step,
)


def whitening_stats_tree(model: nn.Module) -> Dict:
    """The model's whitening stats in the JAX ``batch_stats`` layout
    (scope path → ``{"whitening": stats}``, domain-stacked, in the sites'
    backend's stats type)."""
    tree: Dict = {}
    for name, site in whitening_sites(model).items():
        node = tree
        for key in name.split("."):
            node = node.setdefault(key, {})
        node["whitening"] = site.branch(slice(None))
    return tree


@torch.no_grad()
def make_whiten_cache(model: nn.Module) -> Dict[str, torch.Tensor]:
    """Every whitening site's eval matrix from the model's frozen stats,
    in f32: factorized in one batched call (swbn: the tracked matrices);
    returns ``{site name: w}``.

    The whitener, the shrinkage eps and the eval branch are read off the
    sites, so the cache is what each site would compute for itself."""
    sites = whitening_sites(model).values()
    settings = {(site.whitener, site.eps, site.eval_domain) for site in sites}
    if len(settings) > 1:
        raise ValueError(
            "whitening sites disagree on (whitener, eps, eval_domain): "
            f"{sorted(settings)}"
        )
    if not settings:
        return {}
    ((whitener, eps, eval_domain),) = settings
    cache = build_whiten_cache(
        whitening_stats_tree(model), whitener, eps=eps, eval_domain=eval_domain
    )
    out: Dict[str, torch.Tensor] = {}

    def walk(node: Dict, path: Tuple[str, ...]) -> None:
        for key, value in node.items():
            if key == "w" and torch.is_tensor(value):
                out[".".join(path)] = value
            else:
                walk(value, path + (key,))

    walk(cache.get(WHITEN_CACHE_COL, {}), ())
    return out


def install_whiten_cache(
    model: nn.Module, cache: Optional[Dict[str, torch.Tensor]]
) -> None:
    """Install each site's eval matrix from ``cache``; ``None`` clears
    every site's."""
    for name, site in whitening_sites(model).items():
        install_eval_matrix(site, None if cache is None else cache[name])


def chunk_groups(batches: Iterable, k: int) -> Iterator[List]:
    """Group consecutive batches into lists of at most ``k`` of one batch
    size, cutting early where the size changes (the un-padded collection
    stream ends with a ragged tail, which becomes a chunk of its own)."""
    buf: List = []
    for b in batches:
        if buf and (len(buf) == k or b[0].shape[0] != buf[0][0].shape[0]):
            yield buf
            buf = []
        buf.append(b)
    if buf:
        yield buf


def stack_eval_chunk(group) -> Dict[str, np.ndarray]:
    """``[(x, y, mask), ...] -> {"x": [k, N, ...], "y": [k, N], "mask": [k,
    N]}``, the accumulating eval step's chunk."""
    xs, ys, ms = zip(*group)
    return {"x": np.stack([np.asarray(x, np.float32) for x in xs]),
            "y": np.stack([np.asarray(y, np.int64) for y in ys]),
            "mask": np.stack([np.asarray(m, bool) for m in ms])}


class EvalPipeline:
    """Eval and stat-collection passes over a dataset, on ``device``;
    ``num_domains`` is the model's domain branches, which a collection
    forward fills with the same batch, ``num_workers`` the loader's
    item-loading threads and ``eval_k`` the batches per dispatch
    (``eval_steps_per_dispatch``).  The dispatch functions, and their
    graphs on the card, are built at a pass of a model and kept for the
    next passes of the same model (``eval_graph``, ``collect_graph``)."""

    def __init__(self, test_batch_size: int, device: torch.device,
                 num_domains: int, num_workers: int = 0, eval_k: int = 1):
        if eval_k < 1:
            raise ValueError(f"eval_steps_per_dispatch must be >= 1, got {eval_k}")
        self.test_batch_size = int(test_batch_size)
        self.device = torch.device(device)
        self.num_domains = num_domains
        self.num_workers = int(num_workers)
        self.eval_k = int(eval_k)
        self._model = None
        self._eval_fn = self._collect_step = self._collect_fn = None

    def _dispatch(self, model: nn.Module) -> None:
        if model is not self._model:
            self._model = model
            self._eval_fn = make_accum_eval_step(model, self.eval_k)
            self._collect_step = make_stat_collection_step(model, self.num_domains)
            self._collect_fn = make_scanned_collect(self._collect_step, self.eval_k)

    @property
    def eval_graph(self):
        return None if self._eval_fn is None else self._eval_fn.graph

    @property
    def collect_graph(self):
        return None if self._collect_fn is None else self._collect_fn.graph

    def evaluate(self, state: TrainState, dataset) -> dict:
        """Accumulate eval counters over ``dataset``; one host fetch.

        Returns the reference ``test()`` quantities (loss, accuracy %,
        count), the number of forwards, the pass's wall time and
        throughput, and with two or more chunks the p50/p99 of the
        host-side intervals between chunk dispatches (``dispatch_ms_p*``),
        as the JAX pipeline's.
        """
        t0 = time.perf_counter()
        model = state.model
        self._dispatch(model)
        counters = eval_counters(self.device)
        forwards = 0
        stream = batch_iterator(
            dataset, self.test_batch_size, shuffle=False, drop_last=False,
            num_workers=self.num_workers, pad_and_mask=True,
        )
        chunks = prefetch_to_device(
            (stack_eval_chunk(g) for g in chunk_groups(stream, self.eval_k)),
            device=self.device)
        # The span times the factorization's enqueue (on the card its
        # device time lands in the first eval_dispatch).
        with obs.span("whiten_cache_build", "eval"):
            install_whiten_cache(model, make_whiten_cache(model))
        dispatch_intervals = []  # host-side gaps between chunk dispatches
        try:
            t_prev = None
            for chunk in obs.traced_iter(chunks, "eval_batch_wait", "eval"):
                with obs.span("eval_dispatch", "eval"):
                    counters = self._eval_fn(counters, chunk)
                forwards += int(chunk["x"].shape[0])
                t_now = time.perf_counter()
                if t_prev is not None:
                    # The first dispatch pays the pass's set-up (a graph
                    # capture on the card): not an interval.
                    dispatch_intervals.append(t_now - t_prev)
                t_prev = t_now
        finally:
            install_whiten_cache(model, None)
            chunks.close()
            stream.close()
        # The pass's ONE device→host fetch.
        with obs.span("eval_host_fetch", "eval"):
            loss_sum, correct, count = torch.stack(
                [v.double() for v in counters.values()]).tolist()
        count = int(count)
        seconds = time.perf_counter() - t0
        return {
            "loss": loss_sum / max(count, 1),
            "accuracy": 100.0 * correct / max(count, 1),
            "count": count,
            "forwards": forwards,
            "eval_s": round(seconds, 3),
            "eval_imgs_per_s": round(count / max(seconds, 1e-9), 1),
            # The host-side interval between consecutive chunk dispatches
            # (staging wait + dispatch, not device latency): a fat p99
            # means the prefetch pipeline stalled.
            **percentile_summary([v * 1e3 for v in dispatch_intervals], (50.0, 99.0),
                                 prefix="dispatch_ms_p"),
        }

    def collect_stats(self, state: TrainState, dataset, *, seed: int = 0,
                      epoch: int = 0) -> int:
        """One stat-collection pass (reference ``eval_pass_collect_stats``):
        gradient-free train-mode forwards over ``dataset`` that advance
        only the running stats; ``seed``/``epoch`` set the items' tokens.
        Full batches go ``eval_k`` per dispatch; the ragged tail is an
        eager forward of its own.  Returns the number of forwards."""
        self._dispatch(state.model)
        forwards = 0
        stream = batch_iterator(
            dataset, self.test_batch_size, shuffle=False, drop_last=False,
            seed=seed, epoch=epoch, num_workers=self.num_workers,
        )
        chunks = prefetch_to_device(
            (np.stack([np.asarray(b[0], np.float32) for b in g])
             for g in chunk_groups(stream, self.eval_k)), device=self.device)
        try:
            for xs in obs.traced_iter(chunks, "collect_batch_wait", "eval"):
                with obs.span("collect_dispatch", "eval"):
                    if xs.shape[1] == self.test_batch_size:
                        self._collect_fn(state, xs)
                    else:  # the ragged tail: eager forwards
                        for x in xs:
                            self._collect_step(state, x)
                forwards += int(xs.shape[0])
        finally:
            chunks.close()
            stream.close()
        return forwards
