"""Multi-branch domain normalization modules — eval path of ``dwt_tpu.nn.norms``.

Each site carries ``num_domains`` stat branches stacked on a leading
domain axis (buffers ``mean [D, C]``, ``cov [D, G, g, g]`` for whitening;
``mean``/``var [D, C]``, ``count [D]`` for BN) and ONE shared affine
``gamma``/``beta``.  Eval routes the whole batch through branch
``eval_domain``, the reference's target-branch eval routing.

Inputs are ``[N, C, H, W]`` in ``torch.channels_last`` memory format (or
``[N, C]``): the sites hand the ops a channels-last ``[..., C]`` view
without a copy, as ``dwt_tpu``'s ops take.  Train mode is the next slice
of the port and raises ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from dwt_tpu_torch.ops.batch_norm import BatchNormStats, batch_norm, init_batch_norm_stats
from dwt_tpu_torch.ops.whitening import (
    WhiteningStats,
    group_whiten,
    init_whitening_stats,
)


def merge_domains(x: torch.Tensor) -> torch.Tensor:
    """``[D, N, ...] -> [D*N, ...]`` for the dense/conv compute path."""
    return x.reshape((x.shape[0] * x.shape[1],) + tuple(x.shape[2:]))


def split_domains(x: torch.Tensor, num_domains: int) -> torch.Tensor:
    """``[D*N, ...] -> [D, N, ...]`` for the norm sites."""
    return x.reshape((num_domains, x.shape[0] // num_domains) + tuple(x.shape[1:]))


def _to_channels_last(x: torch.Tensor) -> torch.Tensor:
    """``[N, C, H, W]`` → the ``[N, H, W, C]`` view (contiguous when ``x``
    is in channels_last memory format); ``[N, C]`` passes through."""
    return x.permute(0, 2, 3, 1) if x.dim() == 4 else x


def _from_channels_last(y: torch.Tensor) -> torch.Tensor:
    return y.permute(0, 3, 1, 2) if y.dim() == 4 else y


def _check_eval(module: nn.Module) -> None:
    if module.training:
        raise NotImplementedError(
            f"{type(module).__name__}: train mode is the next slice of the "
            "port; call .eval() first"
        )


class DomainWhiten(nn.Module):
    """``num_domains`` grouped-whitening branches sharing one affine.

    Eval input ``[N, C, H, W]`` (channels_last) → branch ``eval_domain``
    whitens everything.  ``eval_matrix`` is the site's precomputed
    ``[G, g, g]`` matrix (``build_whiten_cache``, installed by the serving
    engine); ``None`` → factorize from the running stats per call.
    """

    def __init__(
        self,
        features: int,
        group_size: int,
        num_domains: int = 2,
        eval_domain: int = 1,
        eps: float = 1e-3,
    ):
        super().__init__()
        self.features = features
        self.group_size = group_size
        self.num_domains = num_domains
        self.eval_domain = eval_domain
        self.eps = eps
        proto = init_whitening_stats(features, group_size)
        self.register_buffer("mean", proto.mean.repeat(num_domains, 1))
        self.register_buffer("cov", proto.cov.repeat(num_domains, 1, 1, 1))
        self.gamma = nn.Parameter(torch.ones(features))
        self.beta = nn.Parameter(torch.zeros(features))
        self.register_buffer("eval_matrix", None, persistent=False)

    def branch(self, domain: int) -> WhiteningStats:
        return WhiteningStats(self.mean[domain], self.cov[domain])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _check_eval(self)
        y, _ = group_whiten(
            _to_channels_last(x),
            self.branch(self.eval_domain),
            group_size=self.group_size,
            train=False,
            eps=self.eps,
            eval_matrix=self.eval_matrix,
        )
        y = torch.addcmul(self.beta.to(y.dtype), y, self.gamma.to(y.dtype))
        return _from_channels_last(y)


class DomainBatchNorm(nn.Module):
    """``num_domains`` stat-injectable BN branches sharing one affine."""

    def __init__(
        self,
        features: int,
        num_domains: int = 2,
        eval_domain: int = 1,
        eps: float = 1e-5,
    ):
        super().__init__()
        self.features = features
        self.num_domains = num_domains
        self.eval_domain = eval_domain
        self.eps = eps
        proto = init_batch_norm_stats(features)
        self.register_buffer("mean", proto.mean.repeat(num_domains, 1))
        self.register_buffer("var", proto.var.repeat(num_domains, 1))
        self.register_buffer("count", proto.count.repeat(num_domains))
        self.gamma = nn.Parameter(torch.ones(features))
        self.beta = nn.Parameter(torch.zeros(features))

    def branch(self, domain: int) -> BatchNormStats:
        return BatchNormStats(self.mean[domain], self.var[domain], self.count[domain])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _check_eval(self)
        y, _ = batch_norm(
            _to_channels_last(x), self.branch(self.eval_domain),
            train=False, eps=self.eps,
        )
        y = torch.addcmul(self.beta.to(y.dtype), y, self.gamma.to(y.dtype))
        return _from_channels_last(y)


def whitening_sites(model: nn.Module) -> "dict[str, DomainWhiten]":
    """Every :class:`DomainWhiten` of ``model`` by its dotted module name
    (``"dn1"``, ``"layer1_0.dn2"``, …) — the JAX scope path joined by
    dots."""
    return {
        name: mod for name, mod in model.named_modules()
        if isinstance(mod, DomainWhiten)
    }


def install_eval_matrix(site: DomainWhiten, w: Optional[torch.Tensor]) -> None:
    """Set (or with ``None`` clear) a site's precomputed eval matrix."""
    if w is not None:
        expect = (site.features // site.group_size, site.group_size, site.group_size)
        if tuple(w.shape) != expect:
            raise ValueError(f"eval matrix {tuple(w.shape)} != {expect}")
    site.eval_matrix = w
