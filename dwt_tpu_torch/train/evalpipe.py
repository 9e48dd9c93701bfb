"""Eval and stat-collection passes — the single-device core of ``dwt_tpu.train.evalpipe``.

* **once-per-pass factorization**: eval-mode whitening matrices are
  factorized from the frozen running stats, every site's groups stacked
  into one batched call (:func:`make_whiten_cache`, the counterpart of
  ``make_whiten_cache_fn``), and installed into the sites for the pass;
  the serving engine builds its cache with the same function;
* **device-resident counters**: the three eval counters stay on the device
  across the whole pass and are read back once at its end;
* **exact counts**: eval batches are padded and masked, so the ragged
  tail adds nothing it should not;
* **stat collection** (the OfficeHome protocol): un-padded batches —
  padding would perturb the batch moments the pass exists to estimate —
  so the ragged tail is a forward of its own.

Batches come from ``batch_iterator`` with the JAX pipeline's seeds,
epochs and worker count (an item's random crop draws from its token
``(seed, epoch, index)``: ``(0, 0, i)`` in an eval pass, ``(seed, pass,
i)`` in a collection pass) and reach the device through
``prefetch_to_device``.  Mesh sharding and scanned dispatch are not
ported yet.
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from dwt_tpu_torch.data.loader import batch_iterator, prefetch_to_device
from dwt_tpu_torch.nn.norms import install_eval_matrix, whitening_sites
from dwt_tpu_torch.ops.whitening import WHITEN_CACHE_COL, build_whiten_cache
from dwt_tpu_torch.train.state import TrainState
from dwt_tpu_torch.train.steps import (
    eval_counters,
    make_accum_eval_step,
    make_stat_collection_step,
)


def whitening_stats_tree(model: nn.Module) -> Dict:
    """The model's whitening stats in the JAX ``batch_stats`` layout
    (scope path → ``{"whitening": WhiteningStats}``, domain-stacked)."""
    tree: Dict = {}
    for name, site in whitening_sites(model).items():
        node = tree
        for key in name.split("."):
            node = node.setdefault(key, {})
        node["whitening"] = site.branch(slice(None))
    return tree


@torch.no_grad()
def make_whiten_cache(model: nn.Module) -> Dict[str, torch.Tensor]:
    """Factorize every whitening site's eval matrix from the model's
    frozen stats in one batched call; returns ``{site name: w}``.

    The shrinkage eps and the eval branch are read off the sites, so the
    cache is what each site would factorize for itself."""
    sites = whitening_sites(model).values()
    settings = {(site.eps, site.eval_domain) for site in sites}
    if len(settings) > 1:
        raise ValueError(
            f"whitening sites disagree on (eps, eval_domain): {sorted(settings)}"
        )
    if not settings:
        return {}
    ((eps, eval_domain),) = settings
    cache = build_whiten_cache(
        whitening_stats_tree(model), eps=eps, eval_domain=eval_domain
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


class EvalPipeline:
    """Eval and stat-collection passes over a dataset, on ``device``;
    ``num_domains`` is the model's domain branches, which a collection
    forward fills with the same batch, and ``num_workers`` the loader's
    item-loading threads."""

    def __init__(self, test_batch_size: int, device: torch.device,
                 num_domains: int, num_workers: int = 0):
        self.test_batch_size = int(test_batch_size)
        self.device = torch.device(device)
        self.num_domains = num_domains
        self.num_workers = int(num_workers)

    def evaluate(self, state: TrainState, dataset) -> dict:
        """Accumulate eval counters over ``dataset``; one host fetch.

        Returns the reference ``test()`` quantities (loss, accuracy %,
        count), the number of forwards and the pass's wall time.
        """
        t0 = time.perf_counter()
        model = state.model
        step = make_accum_eval_step(model)
        counters = eval_counters(self.device)
        forwards = 0
        stream = batch_iterator(
            dataset, self.test_batch_size, shuffle=False, drop_last=False,
            num_workers=self.num_workers, pad_and_mask=True,
        )
        batches = prefetch_to_device(
            ((np.asarray(x, np.float32), np.asarray(y, np.int64), mask)
             for x, y, mask in stream), device=self.device)
        install_whiten_cache(model, make_whiten_cache(model))
        try:
            for x, y, mask in batches:
                counters = step(counters, x, y, mask)
                forwards += 1
        finally:
            install_whiten_cache(model, None)
            batches.close()
            stream.close()
        # The pass's ONE device→host fetch.
        loss_sum, correct, count = torch.stack(
            [v.double() for v in counters.values()]).tolist()
        count = int(count)
        return {
            "loss": loss_sum / max(count, 1),
            "accuracy": 100.0 * correct / max(count, 1),
            "count": count,
            "forwards": forwards,
            "eval_s": round(time.perf_counter() - t0, 3),
        }

    def collect_stats(self, state: TrainState, dataset, *, seed: int = 0,
                      epoch: int = 0) -> int:
        """One stat-collection pass (reference ``eval_pass_collect_stats``):
        gradient-free train-mode forwards over ``dataset`` that advance
        only the running stats; ``seed``/``epoch`` set the items' tokens.
        Returns the number of forwards."""
        collect = make_stat_collection_step(state.model, self.num_domains)
        forwards = 0
        stream = batch_iterator(
            dataset, self.test_batch_size, shuffle=False, drop_last=False,
            seed=seed, epoch=epoch, num_workers=self.num_workers,
        )
        batches = prefetch_to_device(
            (np.asarray(b[0], np.float32) for b in stream), device=self.device)
        try:
            for x in batches:
                collect(state, x)
                forwards += 1
        finally:
            batches.close()
            stream.close()
        return forwards
