"""Grouped domain-specific whitening — the Cholesky subset of ``dwt_tpu.ops.whitening``.

Same contract as the JAX op: channels-LAST ``[..., C]`` activations,
per-group ``[G, g, g]`` statistics in float32, Cholesky whitening
``L⁻¹`` of the *shrunk* covariance ``(1-eps)·cov + eps·I``, and the
all-ones covariance init of the reference.

* **Train mode** (:func:`group_whiten` with ``train=True``): batch mean,
  the biased per-group covariance of the centred input
  (:func:`group_cov`), ``L⁻¹`` of its shrunk form, and the EMA update of
  the running stats — the new value weighted by ``momentum``, the
  *unshrunk* covariance stored, detached.  This is the plain op, the
  counterpart of the JAX package's XLA op: gradients flow through the
  moments and the factorization by autograd.  The kernel path of train
  mode is :func:`dwt_tpu_torch.ops.cuda_whitening.cuda_group_whiten`,
  whose backward recomputes this op.
* **Eval mode**: ``y = (x − m) · W_bdᵀ`` with ``W_bd`` the block-diagonal
  expansion of ``w [G, g, g]``, through
  :func:`dwt_tpu_torch.ops.cuda_whitening.whiten_apply` (the CUDA kernel
  for a CUDA tensor, its plain version for a CPU one).  The
  factorization (:func:`whitening_matrix`) runs once per pass in
  :func:`build_whiten_cache`, outside any kernel — as the JAX package
  leaves it outside Pallas.

Only the ``cholesky`` whitener is ported; the others raise
``NotImplementedError`` (ROADMAP queue 1, item 6).
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


def group_cov(xn: torch.Tensor, num_groups: int, group_size: int) -> torch.Tensor:
    """Biased per-group covariance ``[G, g, g]`` of centred, channels-last
    ``xn [..., C]`` (reduced over all leading axes), accumulated in at
    least float32 — the JAX op's einsum at ``Precision.HIGHEST``."""
    acc_dtype = torch.promote_types(xn.dtype, torch.float32)
    t = xn.reshape(-1, num_groups, group_size).to(acc_dtype)
    # The per-group outer products summed over rows: an elementwise
    # product and a reduction.  The einsum "mgc,mgd->gcd" would be a
    # batched product with a g×g output per group and M-long sums, which
    # cuBLAS runs as one serial loop over M on a few SMs (milliseconds
    # per call at the train shapes).
    return (t.unsqueeze(-1) * t.unsqueeze(-2)).sum(dim=0) / t.shape[0]


def whitening_matrix(cov_shrunk: torch.Tensor) -> torch.Tensor:
    """``L⁻¹`` for ``cov = L Lᵀ`` — the (triangular) whitening matrix,
    batched over any leading shape, differentiable.

    ``torch.linalg.cholesky_ex`` + a triangular solve against ``I`` stand
    in for the JAX package's statically unrolled g≤8 versions (same math;
    the results agree to float32 rounding).  ``cholesky_ex`` leaves its
    ``info`` unread: ``torch.linalg.cholesky`` would check it with a
    device→host sync on every call, and training factorizes at every
    whitened site of every domain.  A matrix that is not positive
    definite gives NaNs, as the JAX op's unrolled Cholesky does."""
    chol, _ = torch.linalg.cholesky_ex(cov_shrunk)
    eye = torch.eye(
        cov_shrunk.shape[-1], dtype=cov_shrunk.dtype, device=cov_shrunk.device
    ).expand_as(cov_shrunk)
    # Row-major, as the apply kernel reads it (the solve may return a
    # column-major result).
    return torch.linalg.solve_triangular(chol, eye, upper=False).contiguous()


def apply_whitening(xn: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Apply ``w [G, g, g]`` to centred ``xn [..., C]``:
    ``y[m, G, d] = Σ_c w[G, d, c] · xn[m, G, c]``, as elementwise products
    and a sum over the group's channels.  Not a matrix product: the weight
    gradient of the grouped einsum (or of the block-diagonal matmul) is a
    small output with M-long sums, which cuBLAS runs as one serial loop
    over M on a few SMs; here it is a reduction."""
    num_groups, g = w.shape[0], w.shape[1]
    t = xn.reshape(-1, num_groups, 1, g)
    return (t * w.to(xn.dtype)).sum(dim=-1).reshape(xn.shape)


# --------------------------------------------------------------- whiteners


class Whitener:
    """Numerics backend behind :func:`group_whiten`: how a whitening matrix
    is produced from (batch or running) statistics, and how the running
    state advances.  ``matrix_from_cov`` maps batched shrunk covariances
    ``[..., g, g]`` to whitening matrices."""

    @staticmethod
    def matrix_from_cov(cov_shrunk: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def train_matrix(self, cov: torch.Tensor, eps: float) -> torch.Tensor:
        """The apply matrix from the batch covariance."""
        return self.matrix_from_cov(_shrink(cov, eps))

    def update_stats(
        self, stats: WhiteningStats, m: torch.Tensor, cov: torch.Tensor,
        momentum: float,
    ) -> WhiteningStats:
        """EMA update — the reference's convention: the NEW value weighted
        by ``momentum``, the unshrunk covariance, detached."""
        return WhiteningStats(
            mean=momentum * m.detach() + (1.0 - momentum) * stats.mean,
            cov=momentum * cov.detach() + (1.0 - momentum) * stats.cov,
        )

    def eval_matrix(
        self, stats: WhiteningStats, eps: float,
        dtype: torch.dtype = torch.float32,
    ) -> torch.Tensor:
        return self.matrix_from_cov(_shrink(stats.cov.to(dtype), eps))


class CholeskyWhitener(Whitener):
    """The reference numerics: Cholesky factor and triangular inverse."""

    @staticmethod
    def matrix_from_cov(cov_shrunk: torch.Tensor) -> torch.Tensor:
        return whitening_matrix(cov_shrunk)


_CHOLESKY = CholeskyWhitener()
# The JAX package's other backends, not ported yet.
_UNPORTED_WHITENERS = ("newton_schulz", "swbn")


def get_whitener(name: "str | Whitener | None") -> Whitener:
    """Resolve a whitener name (or pass a :class:`Whitener` through)."""
    if name is None or name == "cholesky":
        return _CHOLESKY
    if isinstance(name, Whitener):
        return name
    if name in _UNPORTED_WHITENERS:
        raise NotImplementedError(
            f"whitener {name!r} is not ported yet (ROADMAP queue 1, item 6: "
            "numerics breadth); only 'cholesky' is"
        )
    raise ValueError(
        f"unknown whitener {name!r}; choose from "
        f"{('cholesky',) + _UNPORTED_WHITENERS}"
    )


def group_whiten(
    x: torch.Tensor,
    stats: WhiteningStats,
    *,
    group_size: int,
    train: bool,
    momentum: float = 0.1,
    eps: float = 1e-3,
    whitener: "str | Whitener | None" = None,
    eval_matrix: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, WhiteningStats]:
    """Whiten channels-last ``x [..., C]`` per group of channels.

    ``train=True``: batch moments over all leading axes, the factorization
    of the shrunk batch covariance and the EMA update (see the module
    docstring); differentiable in ``x`` by autograd.  ``train=False``:
    the running stats, no state change.  ``eval_matrix`` is the
    precomputed ``[G, g, g]`` eval matrix from :func:`build_whiten_cache`;
    absent, it is factorized from the running stats here.  In eval mode
    ``x`` must be viewable as ``[M, C]`` (a channels-last activation is):
    the apply reads it without a copy.

    Returns ``(whitened, new_stats)`` — whitened has the dtype/shape of ``x``.
    """
    whitener = get_whitener(whitener)
    num_features = x.shape[-1]
    num_groups, group_size = _resolve_groups(num_features, group_size)
    # f32 statistics under lower-precision activations; f64 passes
    # through untruncated (the parity tests' x64 mode).
    dtype = torch.promote_types(x.dtype, torch.float32)
    xf = x.to(dtype)
    if train:
        m = xf.mean(dim=tuple(range(x.dim() - 1)))
        xn = xf - m
        cov = group_cov(xn, num_groups, group_size)
        w = whitener.train_matrix(cov, eps)
        y = apply_whitening(xn, w).to(x.dtype)
        return y, whitener.update_stats(stats, m, cov, momentum)
    if eval_matrix is None:
        eval_matrix = whitener.eval_matrix(stats, eps, dtype)
    y2d = cuda_whitening.whiten_apply(
        xf.view(-1, num_features),
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
