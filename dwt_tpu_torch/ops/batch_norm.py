"""Stat-injectable batch normalization — the eval subset of ``dwt_tpu.ops.batch_norm``.

Running statistics are explicit inputs (``BatchNormStats``), so "stat
injection" is passing different stats.  Eval normalizes with the running
mean and variance in float32, in the centered form of the JAX op's
``_normalize`` for f32 activations: ``(x − m) · rsqrt(var + eps)``.
The shared affine lives in the module layer (``nn.norms``).  Works on any
channels-last ``[..., C]`` input.

Train mode (batch moments, the unbiased-variance EMA, the cumulative
``momentum=None`` mode) is the next slice; ``train=True`` raises.
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


def batch_norm(
    x: torch.Tensor,
    stats: BatchNormStats,
    *,
    train: bool,
    eps: float = 1e-5,
) -> Tuple[torch.Tensor, BatchNormStats]:
    """Normalize channels-last ``x`` with the running stats; returns
    ``(y, stats)``."""
    if train:
        raise NotImplementedError(
            "train-mode batch_norm (batch moments and the EMA update) is "
            "the next slice of the port"
        )
    dtype = torch.promote_types(x.dtype, torch.float32)
    scale = torch.rsqrt(stats.var.to(dtype) + eps)
    y = (x.to(dtype) - stats.mean.to(dtype)) * scale
    return y.to(x.dtype), stats
