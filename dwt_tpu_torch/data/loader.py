"""Batching — a minimal ``batch_iterator`` in the contract of ``dwt_tpu.data.loader``.

Items load sequentially on the calling thread.  The JAX package's
seekable sampler, worker pool, quarantine, per-process sharding and
device prefetch are not ported yet.
"""

from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np


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
    pad_and_mask: bool = False,
) -> Iterator[Tuple[np.ndarray, ...]]:
    """Yield tuples of stacked numpy batches from an indexable dataset.

    * ``shuffle``: the epoch's order is a permutation drawn from
      ``(seed, epoch)``;
    * ``drop_last``: a ragged final batch is dropped (the train streams);
    * ``pad_and_mask`` (eval): every tuple gains a trailing boolean
      ``mask`` and the ragged final batch is padded to ``batch_size`` by
      repeating its last item with ``mask=False``, so masked counters stay
      exact.  Requires ``shuffle=False, drop_last=False``.
    """
    n = len(dataset)
    if pad_and_mask and (shuffle or drop_last):
        raise ValueError(
            "pad_and_mask is an eval-path contract: it requires "
            "shuffle=False and drop_last=False"
        )
    order = (np.random.default_rng((seed, epoch)).permutation(n) if shuffle
             else np.arange(n))
    mask = np.ones(n, bool)
    if pad_and_mask and n % batch_size:
        pad = batch_size - n % batch_size
        order = np.concatenate([order, np.repeat(order[-1:], pad)])
        mask = np.concatenate([mask, np.zeros(pad, bool)])
    stop = len(order) - (len(order) % batch_size if drop_last else 0)
    for start in range(0, stop, batch_size):
        items = [dataset[int(i)] for i in order[start: start + batch_size]]
        fields = tuple(_stack([item[f] for item in items])
                       for f in range(len(items[0])))
        if pad_and_mask:
            fields += (mask[start: start + batch_size],)
        yield fields
