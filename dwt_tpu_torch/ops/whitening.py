"""Grouped domain-specific whitening — the eval subset of ``dwt_tpu.ops.whitening``.

Same contract as the JAX op: channels-LAST ``[..., C]`` activations,
per-group ``[G, g, g]`` statistics in float32, Cholesky whitening
``L⁻¹`` of the *shrunk* running covariance ``(1-eps)·cov + eps·I``, and
the all-ones covariance init of the reference.

Eval-mode whitening is ``y = (x − m) · W_bdᵀ`` with ``W_bd`` the
block-diagonal expansion of ``w [G, g, g]``.  :func:`group_whiten` routes
it through :func:`dwt_tpu_torch.ops.cuda_whitening.whiten_apply`: the
hand-written CUDA kernel for a CUDA tensor, its plain PyTorch version
for a CPU tensor.  The factorization (:func:`whitening_matrix`) runs
once per engine generation in :func:`build_whiten_cache`, outside any
kernel — as the JAX package leaves it outside Pallas.

Train mode (batch moments, EMA update, the moments kernel) is the next
slice of the port; ``train=True`` raises ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch

from dwt_tpu_torch.ops import cuda_whitening

# The cache collection name the JAX package threads to its eval sites;
# kept so a cache tree built here has the JAX tree's shape.
WHITEN_CACHE_COL = "whiten_cache"


class WhiteningStats(NamedTuple):
    """Running statistics for one whitening site (one domain branch).

    mean: ``[C]`` float32 running channel means.
    cov:  ``[G, g, g]`` float32 running *unshrunk* per-group covariance.
    """

    mean: torch.Tensor
    cov: torch.Tensor


def _resolve_groups(num_features: int, group_size: int) -> Tuple[int, int]:
    group_size = min(num_features, group_size)
    if num_features % group_size != 0:
        raise ValueError(
            f"num_features={num_features} must be divisible by "
            f"group_size={group_size}"
        )
    return num_features // group_size, group_size


def init_whitening_stats(
    num_features: int,
    group_size: int,
    dtype: torch.dtype = torch.float32,
    device: Optional[torch.device] = None,
) -> WhiteningStats:
    """Fresh stats: zero means; all-ones (rank-1, PSD) covariance — the
    reference's ``torch.ones([G, g, g])`` buffer init; the eval-time
    shrinkage makes it PD."""
    num_groups, group_size = _resolve_groups(num_features, group_size)
    return WhiteningStats(
        mean=torch.zeros(num_features, dtype=dtype, device=device),
        cov=torch.ones(num_groups, group_size, group_size, dtype=dtype,
                       device=device),
    )


def _shrink(cov: torch.Tensor, eps: float) -> torch.Tensor:
    g = cov.shape[-1]
    eye = torch.eye(g, dtype=cov.dtype, device=cov.device)
    return (1.0 - eps) * cov + eps * eye


def whitening_matrix(cov_shrunk: torch.Tensor) -> torch.Tensor:
    """``L⁻¹`` for ``cov = L Lᵀ`` — the (triangular) whitening matrix,
    batched over any leading shape.

    ``torch.linalg.cholesky`` + a triangular solve against ``I`` stand in
    for the JAX package's statically unrolled g≤8 versions (same math;
    the results agree to float32 rounding)."""
    chol = torch.linalg.cholesky(cov_shrunk)
    eye = torch.eye(
        cov_shrunk.shape[-1], dtype=cov_shrunk.dtype, device=cov_shrunk.device
    ).expand_as(cov_shrunk)
    # Row-major, as the apply kernel reads it (the solve may return a
    # column-major result).
    return torch.linalg.solve_triangular(chol, eye, upper=False).contiguous()


def group_whiten(
    x: torch.Tensor,
    stats: WhiteningStats,
    *,
    group_size: int,
    train: bool,
    eps: float = 1e-3,
    eval_matrix: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, WhiteningStats]:
    """Whiten channels-last ``x [..., C]`` per group of channels (eval).

    ``eval_matrix`` is the precomputed ``[G, g, g]`` matrix from
    :func:`build_whiten_cache`; absent, the matrix is factorized from the
    running stats here.  ``x`` must be viewable as ``[M, C]`` (a
    channels-last activation is): the apply reads it without a copy.

    Returns ``(whitened, stats)`` — whitened has the dtype/shape of ``x``.
    """
    if train:
        raise NotImplementedError(
            "train-mode group_whiten (batch moments, EMA update, the "
            "moments kernel) is the next slice of the port"
        )
    num_features = x.shape[-1]
    _resolve_groups(num_features, group_size)
    # f32 statistics under lower-precision activations; f64 passes
    # through untruncated (the parity tests' x64 mode).
    dtype = torch.promote_types(x.dtype, torch.float32)
    if eval_matrix is None:
        eval_matrix = whitening_matrix(_shrink(stats.cov.to(dtype), eps))
    y2d = cuda_whitening.whiten_apply(
        x.to(dtype).view(-1, num_features),
        stats.mean.to(dtype),
        eval_matrix.to(dtype),
    )
    return y2d.view(x.shape).to(x.dtype), stats


# ------------------------------------------------- eval-matrix precompute


def _is_whitening_stats(value: Any) -> bool:
    return hasattr(value, "mean") and hasattr(value, "cov")


def build_whiten_cache(
    batch_stats: Dict[str, Any],
    *,
    eps: float = 1e-3,
    eval_domain: int = 1,
    dtype: torch.dtype = torch.float32,
) -> Dict[str, Any]:
    """Precompute every whitening site's eval matrix from frozen stats.

    ``batch_stats`` is the JAX package's nested layout: a ``"whitening"``
    key holding domain-stacked stats (mean ``[D, C]``, cov
    ``[D, G, g, g]``) at each site's scope path.  The ``eval_domain``
    branch of every site is shrunk, and all sites with equal ``g`` are
    factorized in ONE batched call.  Returns ``{"whiten_cache": tree}``
    (site scope → ``{"w": [G, g, g]}``), or ``{}`` with no whitening
    sites — the tree :func:`dwt_tpu.ops.whitening.build_whiten_cache`
    returns.
    """
    sites: List[Tuple[Tuple[str, ...], torch.Tensor]] = []

    def walk(node: Dict[str, Any], path: Tuple[str, ...]) -> None:
        for key, value in node.items():
            if key == "whitening" and _is_whitening_stats(value):
                sites.append((path, value.cov[eval_domain].to(dtype)))
            elif hasattr(value, "items"):
                walk(value, path + (key,))

    walk(batch_stats, ())
    if not sites:
        return {}

    matrices: Dict[Tuple[str, ...], torch.Tensor] = {}
    by_g: Dict[int, List[Tuple[Tuple[str, ...], torch.Tensor]]] = {}
    for path, cov in sites:
        by_g.setdefault(cov.shape[-1], []).append((path, cov))
    for group in by_g.values():
        stacked = torch.cat([_shrink(cov, eps) for _, cov in group])
        ws = whitening_matrix(stacked)
        offset = 0
        for path, cov in group:
            n = cov.shape[0]
            matrices[path] = ws[offset: offset + n]
            offset += n

    cache: Dict[str, Any] = {}
    for path, w in matrices.items():
        node = cache
        for key in path:
            node = node.setdefault(key, {})
        node["w"] = w
    return {WHITEN_CACHE_COL: cache}
