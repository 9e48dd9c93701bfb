"""Stat-injectable batch normalization — the port of ``dwt_tpu.ops.batch_norm``.

Running statistics are explicit inputs (``BatchNormStats``), so "stat
injection" is passing different stats, and train mode returns new stats
rather than mutating buffers.  Semantics, as the JAX op:

* train mode normalizes with the batch mean and the biased one-pass
  variance ``E[x²] − m²`` (both f32 under bf16 activations); eval with the
  running mean and variance; f32 activations in the centered form ``(x −
  m) · rsqrt(var + eps)``, bf16 ones with the f32 scale and shift folded
  into the activation dtype, ``x·s + (−m·s)`` (:func:`_normalize`);
* the running-variance EMA accumulates the UNBIASED batch variance;
* EMA convention ``running ← momentum·new + (1 − momentum)·running``;
  ``momentum=None`` selects the cumulative mode ``1/count``, with
  ``count`` advanced first;
* the new stats are detached and cast back to the stored dtype.

The shared affine lives in the module layer (``nn.norms``).  Works on any
channels-last ``[..., C]`` input; moments reduce over all leading axes.
:func:`domain_batch_norm` is train mode for a stack of domain branches at
once — what ``jax.vmap(batch_norm)`` over the domain axis computes.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch


class BatchNormStats(NamedTuple):
    mean: torch.Tensor   # [C] float32
    var: torch.Tensor    # [C] float32
    count: torch.Tensor  # [] int32 — num_batches_tracked (cumulative mode)


def init_batch_norm_stats(
    num_features: int,
    dtype: torch.dtype = torch.float32,
    device: Optional[torch.device] = None,
) -> BatchNormStats:
    return BatchNormStats(
        mean=torch.zeros(num_features, dtype=dtype, device=device),
        var=torch.ones(num_features, dtype=dtype, device=device),
        count=torch.zeros((), dtype=torch.int32, device=device),
    )


def _normalize(x: torch.Tensor, xf: torch.Tensor, m: torch.Tensor,
               var: torch.Tensor, eps: float) -> torch.Tensor:
    """``(x − m) · rsqrt(var + eps)`` with f32 statistics ``m``, ``var``
    (broadcastable to ``x``): the exact centred form when ``x`` is at least
    f32 (``xf`` is ``x``), else the per-channel f32 scale and shift cast to
    ``x``'s dtype and applied there — the JAX op's folding, which keeps the
    elementwise chain half-width."""
    scale = torch.rsqrt(var + eps)
    if x.dtype == xf.dtype:
        return (xf - m) * scale
    return x * scale.to(x.dtype) + (-(m * scale)).to(x.dtype)


def domain_batch_norm(
    x: torch.Tensor,
    stats: BatchNormStats,
    *,
    momentum: Optional[float] = 0.1,
    eps: float = 1e-5,
) -> Tuple[torch.Tensor, BatchNormStats]:
    """Train mode of ``D`` branches: ``x [D, ..., C]`` with stats of
    leading shape ``[D]``; branch ``d`` normalizes ``x[d]`` with its own
    batch moments and advances its own stats.  Returns ``(y, new_stats)``."""
    dtype = torch.promote_types(x.dtype, torch.float32)
    xf = x.to(dtype)
    reduce_axes = tuple(range(1, x.dim() - 1))
    n = 1
    for a in reduce_axes:
        n *= x.shape[a]
    bcast = (x.shape[0],) + (1,) * len(reduce_axes) + (x.shape[-1],)
    m = xf.mean(dim=reduce_axes)
    msq = torch.square(xf).mean(dim=reduce_axes)
    var = msq - torch.square(m)  # biased — used for normalization
    y = _normalize(x, xf, m.view(bcast), var.view(bcast), eps)

    count = stats.count + 1
    if momentum is None:
        factor = (1.0 / count.to(dtype)).view(-1, 1)
    else:
        factor = momentum
    unbiased = var.detach() * (n / max(n - 1, 1))
    new_stats = BatchNormStats(
        mean=(factor * m.detach() + (1.0 - factor) * stats.mean
              ).to(stats.mean.dtype),
        var=(factor * unbiased + (1.0 - factor) * stats.var
             ).to(stats.var.dtype),
        count=count,
    )
    return y.to(x.dtype), new_stats


def batch_norm(
    x: torch.Tensor,
    stats: BatchNormStats,
    *,
    train: bool,
    momentum: Optional[float] = 0.1,
    eps: float = 1e-5,
) -> Tuple[torch.Tensor, BatchNormStats]:
    """Normalize channels-last ``x``; returns ``(y, new_stats)``
    (``stats`` unchanged in eval mode)."""
    if train:
        y, new = domain_batch_norm(
            x.unsqueeze(0), BatchNormStats(*(s.unsqueeze(0) for s in stats)),
            momentum=momentum, eps=eps,
        )
        return y[0], BatchNormStats(*(s[0] for s in new))
    dtype = torch.promote_types(x.dtype, torch.float32)
    y = _normalize(x, x.to(dtype), stats.mean.to(dtype), stats.var.to(dtype), eps)
    return y.to(x.dtype), stats
