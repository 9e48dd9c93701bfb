"""Multi-branch domain normalization modules — the port of ``dwt_tpu.nn.norms``.

Each site carries ``num_domains`` stat branches stacked on a leading
domain axis (buffers ``mean [D, C]``, ``cov [D, G, g, g]`` for whitening;
``mean``/``var [D, C]``, ``count [D]`` for BN) and ONE shared affine
``gamma``/``beta``, applied after the domain concat.  ``self.training``
picks the path:

* **train**: the input is the merged ``[D·N, C, H, W]`` batch in
  ``torch.channels_last`` memory format (or ``[D·N, C]``).  Its
  ``[D, N·H·W, C]`` view is contiguous (:func:`apply_domain_norm`), so
  each domain's ``[M_d, C]`` slice reaches the ops — and the CUDA kernels
  — without a copy.  Branch ``d`` normalizes slice ``d`` with its batch
  moments, and its running stats advance IN PLACE, under
  ``torch.no_grad()``: the buffers are the JAX package's returned
  ``batch_stats``.  Whitening goes through
  :func:`~dwt_tpu_torch.ops.cuda_whitening.cuda_group_whiten` (the moments
  and apply kernels on the card).
* **eval**: the whole ``[N, C, H, W]`` batch goes through branch
  ``eval_domain``, the reference's target-branch eval routing.

The whitening sites' buffers follow their whitener, as the JAX package's
stats tree does: ``swbn`` adds the tracked matrices ``w [D, G, g, g]``, so
checkpoints are per-backend artifacts.  Activations may be bf16; the stat
buffers stay f32 and the sites return the activation dtype.

**Rematerialization** (:func:`remat`, ResNet's ``--remat``): a block run
under ``torch.utils.checkpoint`` runs its forward again in the backward.
The statistics advance once per step and the recompute must see the
stats of the step's start, so in the recompute the sites write no buffer,
and an SWBN site reads the tracked matrix it read in the forward (a copy
the forward keeps for it).
"""

from __future__ import annotations

import contextlib
from typing import Callable, Iterator, Optional

import torch
import torch.utils.checkpoint
from torch import nn

from dwt_tpu_torch.ops import cuda_whitening
from dwt_tpu_torch.ops.batch_norm import (
    BatchNormStats,
    batch_norm,
    domain_batch_norm,
    init_batch_norm_stats,
)
from dwt_tpu_torch.ops.whitening import get_whitener, group_whiten

# The phase of the checkpointed block running now: None (no remat),
# "forward" (its first run) or "recompute" (its rerun in the backward).
_remat_phase: Optional[str] = None


@contextlib.contextmanager
def _phase(name: str) -> Iterator[None]:
    global _remat_phase
    outer, _remat_phase = _remat_phase, name
    try:
        yield
    finally:
        _remat_phase = outer


def remat(fn: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """``fn(x)`` with its activations recomputed in the backward instead of
    kept (``torch.utils.checkpoint``, non-reentrant; the counterpart of
    ``flax.linen.remat``), the norm sites inside told which run is which
    (module docstring)."""
    return torch.utils.checkpoint.checkpoint(
        fn, x, use_reentrant=False,
        context_fn=lambda: (_phase("forward"), _phase("recompute")))


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


def apply_domain_norm(
    x: torch.Tensor,
    num_domains: int,
    norm: Callable[[torch.Tensor], torch.Tensor],
) -> torch.Tensor:
    """Train-mode plumbing of a domain norm site: the merged batch ``x``
    (``[D·N, C, H, W]``, or ``[D·N, C]``) → its ``[D, N·H·W, C]`` form →
    ``norm`` → the result, channels-last ``[D·N, H, W, C]`` (or
    ``[D·N, C]``).  ``x`` must be in channels_last memory format — what
    the model's convs give — so that form is a view and each domain's
    slice reaches the kernels without a copy; any other layout fails
    here rather than being copied.  The counterpart of the JAX package's
    split → normalize → merge."""
    xc = _to_channels_last(x)
    if xc.shape[0] % num_domains:
        raise ValueError(
            f"train batch of {xc.shape[0]} does not split into "
            f"num_domains={num_domains} domains"
        )
    return norm(xc.view(num_domains, -1, xc.shape[-1])).view(xc.shape)


class DomainWhiten(nn.Module):
    """``num_domains`` grouped-whitening branches sharing one affine.

    Train input: the merged batch (module docstring) → branch ``d``
    whitens domain slice ``d`` with its batch moments through
    :func:`~dwt_tpu_torch.ops.cuda_whitening.cuda_group_whiten`, and every
    branch's EMA advances in place.  Eval input ``[N, C, H, W]``
    (channels_last) → branch ``eval_domain`` whitens everything.
    ``eval_matrix`` is the site's precomputed ``[G, g, g]`` eval matrix
    (``build_whiten_cache``, installed by the eval pipeline and the
    serving engine); ``None`` → factorize from the running stats per call.
    ``whitener`` names the numerics backend (``--whitener``), whose stats
    the buffers hold: ``mean``, ``cov`` and, for ``swbn``, ``w``.
    """

    def __init__(
        self,
        features: int,
        group_size: int,
        num_domains: int = 2,
        eval_domain: int = 1,
        momentum: float = 0.1,
        eps: float = 1e-3,
        whitener: str = "cholesky",
    ):
        super().__init__()
        self.features = features
        self.group_size = group_size
        self.num_domains = num_domains
        self.eval_domain = eval_domain
        self.momentum = momentum
        self.eps = eps
        self.whitener = get_whitener(whitener).name
        proto = get_whitener(whitener).init_stats(features, group_size)
        self._stats_type, self._stat_names = type(proto), proto._fields
        for name, value in zip(proto._fields, proto):
            self.register_buffer(
                name, value.repeat((num_domains,) + (1,) * value.dim()))
        self.gamma = nn.Parameter(torch.ones(features))
        self.beta = nn.Parameter(torch.zeros(features))
        self.register_buffer("eval_matrix", None, persistent=False)
        self._remat_w: Optional[torch.Tensor] = None

    def branch(self, domain):
        """The stats of branch ``domain`` (an index, or ``slice(None)``
        for the stacked ones): views of the buffers, in the backend's
        stats type."""
        return self._stats_type(*(getattr(self, n)[domain] for n in self._stat_names))

    def _train(self, x3: torch.Tensor) -> torch.Tensor:
        stats = self.branch(slice(None))
        if hasattr(stats, "w"):
            if _remat_phase == "forward":
                self._remat_w = self.w.clone()
            elif _remat_phase == "recompute":
                stats = stats._replace(w=self._remat_w)
        y3, new = cuda_whitening.cuda_group_whiten(
            x3, stats, group_size=self.group_size, train=True,
            momentum=self.momentum, eps=self.eps, whitener=self.whitener)
        if _remat_phase != "recompute":
            with torch.no_grad():
                for name, value in zip(self._stat_names, new):
                    getattr(self, name).copy_(value)
        return y3

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            y = apply_domain_norm(x, self.num_domains, self._train)
        else:
            y, _ = group_whiten(
                _to_channels_last(x),
                self.branch(self.eval_domain),
                group_size=self.group_size,
                train=False,
                eps=self.eps,
                whitener=self.whitener,
                eval_matrix=self.eval_matrix,
            )
        y = torch.addcmul(self.beta.to(y.dtype), y, self.gamma.to(y.dtype))
        return _from_channels_last(y)


class DomainBatchNorm(nn.Module):
    """``num_domains`` stat-injectable BN branches sharing one affine;
    train mode as :class:`DomainWhiten`'s, through
    :func:`~dwt_tpu_torch.ops.batch_norm.domain_batch_norm`.
    ``momentum=None`` is the cumulative ``1/count`` mode."""

    def __init__(
        self,
        features: int,
        num_domains: int = 2,
        eval_domain: int = 1,
        momentum: Optional[float] = 0.1,
        eps: float = 1e-5,
    ):
        super().__init__()
        self.features = features
        self.num_domains = num_domains
        self.eval_domain = eval_domain
        self.momentum = momentum
        self.eps = eps
        proto = init_batch_norm_stats(features)
        self.register_buffer("mean", proto.mean.repeat(num_domains, 1))
        self.register_buffer("var", proto.var.repeat(num_domains, 1))
        self.register_buffer("count", proto.count.repeat(num_domains))
        self.gamma = nn.Parameter(torch.ones(features))
        self.beta = nn.Parameter(torch.zeros(features))

    def branch(self, domain) -> BatchNormStats:
        return BatchNormStats(self.mean[domain], self.var[domain], self.count[domain])

    def _train(self, x3: torch.Tensor) -> torch.Tensor:
        y3, new = domain_batch_norm(
            x3, self.branch(slice(None)), momentum=self.momentum, eps=self.eps)
        if _remat_phase != "recompute":
            with torch.no_grad():
                self.mean.copy_(new.mean)
                self.var.copy_(new.var)
                self.count.copy_(new.count)
        return y3

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            y = apply_domain_norm(x, self.num_domains, self._train)
        else:
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
