"""Seekable deterministic epoch order — ``dwt_tpu.data.sampler``, copied.

Position ``k`` of epoch ``e`` is computable in O(1) from the seed lineage
alone, so a stream can open at any batch cursor without replaying the
prefix.  :class:`SeekableSampler` is a keyed Feistel bijection over
``range(n)``:

* the domain is padded up to a power of two ``2^(2h)`` and a balanced
  ``h``-bit × ``h``-bit Feistel network (splitmix-style round function,
  per-``(seed, epoch)`` round keys from ``np.random.SeedSequence``)
  permutes it; values landing outside ``range(n)`` are *cycle-walked*
  (re-permuted until they fall inside; expected < 4 hops since the
  padded domain is < 4n).  The composition is a permutation of
  ``range(n)``: bijective by construction, no collision checks, no state;
* everything is vectorized numpy over uint64, so an arbitrary slice
  (``take``) costs O(slice), not O(n);
* ``shuffle=False`` is the identity, keeping eval order stable.

The mapping depends only on ``(n, seed, epoch)`` and the fixed round
count, which with the key derivation is the on-disk ``DataState``
contract (``dwt_tpu_torch.data.pipeline``): both packages open the same
order for the same triple.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np

_MASK64 = np.uint64(0xFFFFFFFFFFFFFFFF)

# Feistel round count: 4 rounds of a strong mixing function are enough
# for statistical shuffling (this is a sampler, not a cipher); fixed —
# changing it would silently re-shuffle every seed lineage, so it is
# part of the on-disk DataState contract.
FEISTEL_ROUNDS = 4


def _round_keys(seed: int, epoch: int, rounds: int = FEISTEL_ROUNDS) -> np.ndarray:
    """Per-round uint64 keys derived from the (seed, epoch) lineage.

    ``SeedSequence`` spreads low-entropy/adjacent seeds; its
    ``generate_state`` output is documented stable across numpy
    versions, which this on-disk-adjacent contract needs.
    """
    ss = np.random.SeedSequence([np.uint64(seed).item(), np.uint64(epoch).item()])
    return ss.generate_state(rounds, dtype=np.uint64)


def _mix(x: np.ndarray, key: np.uint64) -> np.ndarray:
    """splitmix64-style avalanche of ``x`` under ``key`` (uint64 arrays)."""
    with np.errstate(over="ignore"):
        x = (x + key) * np.uint64(0x9E3779B97F4A7C15) & _MASK64
        x ^= x >> np.uint64(29)
        x = x * np.uint64(0xBF58476D1CE4E5B9) & _MASK64
        x ^= x >> np.uint64(32)
    return x


class SeekableSampler:
    """The seeded O(1)-seekable epoch permutation (module doc).

    ``sampler[k]`` / ``sampler.take(positions)`` map epoch *positions*
    (0-based, ``< n``) to dataset *indices*; ``positions()`` materializes
    a contiguous span.  All entry points are pure functions of
    ``(n, seed, epoch)``.
    """

    def __init__(self, n: int, seed: int = 0, epoch: int = 0,
                 shuffle: bool = True):
        if n < 0:
            raise ValueError(f"sampler domain must be >= 0; got {n}")
        self.n = int(n)
        self.seed = int(seed)
        self.epoch = int(epoch)
        self.shuffle = bool(shuffle)
        # Balanced half-width: the smallest h with 2^(2h) >= n (h >= 1 so
        # degenerate n in {0,1,2} still builds a well-formed network).
        h = 1
        while (1 << (2 * h)) < self.n:
            h += 1
        self._half_bits = np.uint64(h)
        self._half_mask = np.uint64((1 << h) - 1)
        self._domain = 1 << (2 * h)
        self._keys = _round_keys(self.seed, self.epoch)

    def __len__(self) -> int:
        return self.n

    # ------------------------------------------------------------ internals

    def _feistel(self, x: np.ndarray) -> np.ndarray:
        """One pass of the network over the padded domain (uint64 in/out)."""
        h, mask = self._half_bits, self._half_mask
        left = (x >> h) & mask
        right = x & mask
        for key in self._keys:
            left, right = right, left ^ (_mix(right, key) & mask)
        return (left << h) | right

    def _walk(self, x: np.ndarray) -> np.ndarray:
        """Cycle-walk padded-domain outputs back into ``range(n)``.

        The permutation of the padded domain maps each in-range value
        somewhere; repeatedly applying it to out-of-range values must
        land in range within the cycle (the domain is finite and the map
        bijective), and since the padded domain is < 4n the expected hop
        count is < 4.  The hard cap turns an (impossible) runaway into a
        loud error instead of a silent hang.
        """
        out = self._feistel(x)
        hops = 0
        bad = out >= self.n
        while bad.any():
            out[bad] = self._feistel(out[bad])
            bad = out >= self.n
            hops += 1
            if hops > self._domain + 1:  # pragma: no cover - bijection broken
                raise RuntimeError("Feistel cycle-walk failed to terminate")
        return out

    # ----------------------------------------------------------------- API

    def take(self, positions: Union[np.ndarray, Sequence[int]]) -> np.ndarray:
        """Dataset indices at the given epoch positions (any order/subset).

        O(len(positions)) — THE seek primitive: a resume at batch cursor
        ``c`` maps only the remaining positions, never the prefix.
        """
        pos = np.asarray(positions, dtype=np.uint64)
        if pos.size == 0:
            return pos.astype(np.int64)
        if int(pos.max()) >= max(self.n, 1):
            raise IndexError(
                f"position {int(pos.max())} out of range for n={self.n}"
            )
        if not self.shuffle or self.n <= 1:
            return pos.astype(np.int64)
        return self._walk(pos.copy()).astype(np.int64)

    def __getitem__(self, k: int) -> int:
        return int(self.take(np.asarray([k]))[0])

    def positions(self, start: int = 0, stop: Optional[int] = None) -> np.ndarray:
        """Indices for the contiguous position span ``[start, stop)``
        (``stop=None`` → ``n``) — ``positions(0)`` is the full epoch
        order, the drop-in replacement for the materialized permutation."""
        stop = self.n if stop is None else int(stop)
        start = int(start)
        if not 0 <= start <= stop <= self.n:
            raise IndexError(
                f"span [{start}, {stop}) out of range for n={self.n}"
            )
        return self.take(np.arange(start, stop, dtype=np.uint64))


def epoch_batch_count(n: int, batch_size: int, drop_last: bool = True,
                      shard_count: int = 1) -> int:
    """Batches per epoch of a train-path stream, as ``batch_iterator``
    counts them — per process under a ``shard_count``-way split, whose
    epoch is first cut to a multiple of ``shard_count * batch_size``.
    With quarantine substitution (the train loops) this count is fixed
    for the whole run, which makes stream positions pure functions of the
    step and mid-epoch seeks exact."""
    if batch_size <= 0:
        raise ValueError(f"batch_size must be > 0; got {batch_size}")
    span = batch_size * max(1, int(shard_count))
    if drop_last:
        return int(n) // span
    return (int(n) + span - 1) // span
