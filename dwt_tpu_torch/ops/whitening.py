"""Grouped domain-specific whitening — the port of ``dwt_tpu.ops.whitening``.

Same contract as the JAX op: channels-LAST ``[..., C]`` activations,
per-group ``[G, g, g]`` statistics in float32 (also under bf16
activations), the whitening matrix of the *shrunk* covariance ``(1-eps)·cov
+ eps·I``, and the all-ones covariance init of the reference.

* **Train mode** (:func:`group_whiten` with ``train=True``): batch mean,
  the biased per-group covariance of the centred input
  (:func:`group_cov`), the backend's train matrix and the EMA update of
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
  factorization runs once per pass in :func:`build_whiten_cache`, outside
  any kernel — as the JAX package leaves it outside Pallas.

The numerics are pluggable, as ``--whitener`` makes them in the JAX
package: ``cholesky`` (the reference: Cholesky factor and triangular
inverse), ``newton_schulz`` (fixed-K coupled Newton–Schulz ``Σ^{-1/2}`` of
batched matmuls) and ``swbn`` (an online whitening matrix tracked in the
running state, no factorization).  Under bf16 activations the moments and
the EMA stay f32, each backend factorizes in its ``precision_policy``
dtype (f32 for Cholesky and SWBN, bf16 for Newton–Schulz), and the apply
rounds the centred input and the matrix to bf16 and accumulates in f32 —
the JAX op's rounding points.  ``DWT_NS_ITERS`` and ``DWT_SWBN_ALPHA`` set
the iteration count and the tracker's step, as in the JAX package.
"""

from __future__ import annotations

import os
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


class SWBNStats(NamedTuple):
    """Running state of one ``swbn`` site: the shared EMA plumbing and
    ``w [G, g, g]``, the tracked whitening matrix of the trace-normalized
    covariance ``Σ/tr_g`` (the apply matrix is ``w / sqrt(tr_g)``)."""

    mean: torch.Tensor
    cov: torch.Tensor
    w: torch.Tensor


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


# Fixed Newton–Schulz iteration count (Decorrelated BN, arXiv:1804.08450,
# uses T=5); the JAX package's environment name overrides it.
_NS_ITERS_ENV = "DWT_NS_ITERS"
_NS_DEFAULT_ITERS = 5


def ns_default_iters() -> int:
    value = os.environ.get(_NS_ITERS_ENV, "")
    try:
        return int(value) if value else _NS_DEFAULT_ITERS
    except ValueError:
        raise ValueError(f"{_NS_ITERS_ENV}={value!r} is not an integer") from None


def _small_matmul(dtype: torch.dtype):
    """Batched ``[..., g, g] @ [..., g, g]`` with operands in ``dtype`` and
    the accumulation in at least float32, rounded back to ``dtype`` — the
    JAX package's ``preferred_element_type`` matmul.  For f32 and f64 it is
    a plain matmul."""
    acc = torch.promote_types(dtype, torch.float32)
    if acc == dtype:
        return torch.matmul
    return lambda p, q: torch.matmul(p.to(acc), q.to(acc)).to(dtype)


def newton_schulz_inverse_sqrt(
    a: torch.Tensor, num_iters: Optional[int] = None
) -> torch.Tensor:
    """``Σ^{-1/2}`` of batched SPD ``[..., g, g]`` by coupled Newton–Schulz.

    The iterate runs in ``a.dtype`` (bf16 under the Newton–Schulz
    precision policy), each matmul accumulating in f32; the trace
    normalization ``A/tr(A)`` (spectrum in (0, 1], the iteration's basin,
    also for the all-ones init) and its undoing are computed in at least
    f32.  For f32 input every cast is an identity."""
    if num_iters is None:
        num_iters = ns_default_iters()
    g = a.shape[-1]
    acc_dtype = torch.promote_types(a.dtype, torch.float32)
    eye = torch.eye(g, dtype=a.dtype, device=a.device)
    tr = torch.diagonal(a.to(acc_dtype), dim1=-2, dim2=-1).sum(-1)[..., None, None]
    y = (a.to(acc_dtype) / tr).to(a.dtype)
    z = eye.expand_as(a)
    mm = _small_matmul(a.dtype)
    for _ in range(num_iters):
        t = 1.5 * eye - 0.5 * mm(z, y)
        y = mm(y, t)
        z = mm(t, z)
    # Row-major, as the apply kernel reads it.
    return (z.to(acc_dtype) / torch.sqrt(tr)).to(a.dtype).contiguous()


def apply_whitening(
    xn: torch.Tensor, w: torch.Tensor,
    compute_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Apply ``w [G, g, g]`` to centred ``xn [..., C]``:
    ``y[m, G, d] = Σ_c w[G, d, c] · xn[m, G, c]``, as elementwise products
    and a sum over the group's channels.  Not a matrix product: the weight
    gradient of the grouped einsum (or of the block-diagonal matmul) is a
    small output with M-long sums, which cuBLAS runs as one serial loop
    over M on a few SMs; here it is a reduction.

    ``compute_dtype`` (default ``w``'s) is the dtype both operands are
    rounded to before the product, which accumulates in at least f32 — the
    JAX op's ``preferred_element_type`` apply.  The result has ``xn``'s
    dtype."""
    compute_dtype = compute_dtype or w.dtype
    acc_dtype = torch.promote_types(compute_dtype, torch.float32)
    num_groups, g = w.shape[0], w.shape[1]
    t = xn.reshape(-1, num_groups, 1, g).to(compute_dtype).to(acc_dtype)
    y = (t * w.to(compute_dtype).to(acc_dtype)).sum(dim=-1)
    return y.reshape(xn.shape).to(xn.dtype)


# --------------------------------------------------------------- whiteners


class Whitener:
    """Numerics backend behind :func:`group_whiten` (``--whitener``).

    ``matrix_from_cov`` (when not None) maps batched shrunk covariances
    ``[..., g, g]`` to whitening matrices, which lets
    :func:`build_whiten_cache` stack every site's groups into one call.
    Backends with online state (swbn) override ``train_matrix``,
    ``update_stats`` and ``eval_matrix`` instead."""

    name: str = "base"
    # False: eval runs off the running estimates alone, and the OfficeHome
    # stat re-estimation passes buy nothing.
    needs_stat_collection: bool = True
    matrix_from_cov = None

    def init_stats(self, num_features: int, group_size: int,
                   dtype: torch.dtype = torch.float32,
                   device: Optional[torch.device] = None):
        return init_whitening_stats(num_features, group_size, dtype, device)

    def precision_policy(self, compute_dtype: torch.dtype) -> torch.dtype:
        """The dtype this backend factorizes in when the net computes in
        ``compute_dtype``: by default promoted to f32 (Cholesky's and
        SWBN's chains amplify bf16 rounding).  f32 under f32 compute."""
        return torch.promote_types(compute_dtype, torch.float32)

    def train_matrix(self, cov: torch.Tensor, stats, eps: float
                     ) -> Tuple[torch.Tensor, Any]:
        """``(apply matrix, aux state)`` from the batch covariance."""
        return self.matrix_from_cov(_shrink(cov, eps)), None

    def update_stats(self, stats, m: torch.Tensor, cov: torch.Tensor,
                     momentum: float, aux: Any = None):
        """EMA update — the reference's convention: the NEW value weighted
        by ``momentum``, the unshrunk covariance, detached."""
        return WhiteningStats(
            mean=momentum * m.detach() + (1.0 - momentum) * stats.mean,
            cov=momentum * cov.detach() + (1.0 - momentum) * stats.cov,
        )

    def eval_matrix(self, stats, eps: float,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
        return self.matrix_from_cov(_shrink(stats.cov.to(dtype), eps))


class CholeskyWhitener(Whitener):
    """The reference numerics: Cholesky factor and triangular inverse."""

    name = "cholesky"

    @staticmethod
    def matrix_from_cov(cov_shrunk: torch.Tensor) -> torch.Tensor:
        return whitening_matrix(cov_shrunk)


class NewtonSchulzWhitener(Whitener):
    """Fixed-K coupled Newton–Schulz ``Σ^{-1/2}`` (arXiv:1804.08450): ZCA
    whitening out of batched matmuls, factorizing natively in bf16 under
    bf16 compute."""

    name = "newton_schulz"

    def __init__(self, num_iters: Optional[int] = None):
        self.num_iters = num_iters

    def precision_policy(self, compute_dtype: torch.dtype) -> torch.dtype:
        return compute_dtype

    def matrix_from_cov(self, cov_shrunk: torch.Tensor) -> torch.Tensor:
        return newton_schulz_inverse_sqrt(cov_shrunk, self.num_iters)


# SWBN whitening-matrix step size (arXiv:2106.04413); the JAX package's
# environment name overrides it.
_SWBN_ALPHA_ENV = "DWT_SWBN_ALPHA"
_SWBN_DEFAULT_ALPHA = 0.3


class SWBNWhitener(Whitener):
    """Stochastic whitening with online statistics (arXiv:2106.04413).

    Each train step takes one multiplicative step ``w += α (I − w Σ̂ wᵀ) w``
    toward the whitening manifold (``Σ̂`` the trace-normalized shrunk batch
    covariance), and the apply uses the new ``w`` detached: no
    factorization, forward or backward.  Eval reads the tracked matrix from
    the running state, so the stat re-estimation passes are unnecessary."""

    name = "swbn"
    needs_stat_collection = False
    matrix_from_cov = None

    def __init__(self, alpha: Optional[float] = None):
        # None: read the environment at each use, as the JAX package does.
        self.alpha = alpha

    def _alpha(self) -> float:
        if self.alpha is not None:
            return self.alpha
        value = os.environ.get(_SWBN_ALPHA_ENV, "")
        return float(value) if value else _SWBN_DEFAULT_ALPHA

    def init_stats(self, num_features: int, group_size: int,
                   dtype: torch.dtype = torch.float32,
                   device: Optional[torch.device] = None) -> SWBNStats:
        base = init_whitening_stats(num_features, group_size, dtype, device)
        num_groups, group_size = _resolve_groups(num_features, group_size)
        eye = torch.eye(group_size, dtype=dtype, device=device)
        return SWBNStats(base.mean, base.cov,
                         eye.repeat(num_groups, 1, 1))

    @staticmethod
    def _normalized(cov_shrunk: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(Σ/tr_g, sqrt(tr_g))`` with ``tr_g`` the mean eigenvalue."""
        g = cov_shrunk.shape[-1]
        tr_g = torch.diagonal(cov_shrunk, dim1=-2, dim2=-1).sum(-1)[..., None, None] / g
        return cov_shrunk / tr_g, torch.sqrt(tr_g)

    def train_matrix(self, cov, stats, eps):
        sigma_n, scale = self._normalized(_shrink(cov, eps))
        # The whole update is detached: w is a buffer, and gradients flow
        # through the centred activations only.
        sigma_n, scale, w = sigma_n.detach(), scale.detach(), stats.w.detach()
        eye = torch.eye(w.shape[-1], dtype=w.dtype, device=w.device)
        mm = _small_matmul(w.dtype)
        residual = eye - mm(mm(w, sigma_n), w.transpose(-1, -2))
        w_next = w + self._alpha() * mm(residual, w)
        # Row-major, as the apply kernel reads it (a model moved to
        # channels_last memory format holds its 4-d w buffers so).
        return (w_next / scale).contiguous(), w_next

    def update_stats(self, stats, m, cov, momentum, aux=None) -> SWBNStats:
        base = super().update_stats(stats, m, cov, momentum, aux)
        return SWBNStats(base.mean, base.cov, aux)

    def eval_matrix(self, stats, eps, dtype=torch.float32):
        _, scale = self._normalized(_shrink(stats.cov.to(dtype), eps))
        return (stats.w.to(dtype) / scale).contiguous()


_WHITENERS = {
    "cholesky": CholeskyWhitener(),
    "newton_schulz": NewtonSchulzWhitener(),
    "swbn": SWBNWhitener(),
}
WHITENER_NAMES = tuple(_WHITENERS)


def get_whitener(name: "str | Whitener | None") -> Whitener:
    """Resolve a ``--whitener`` name (or pass a :class:`Whitener` through)."""
    if name is None:
        return _WHITENERS["cholesky"]
    if isinstance(name, Whitener):
        return name
    try:
        return _WHITENERS[name]
    except KeyError:
        raise ValueError(
            f"unknown whitener {name!r}; choose from {WHITENER_NAMES}"
        ) from None


def group_whiten(
    x: torch.Tensor,
    stats,
    *,
    group_size: int,
    train: bool,
    momentum: float = 0.1,
    eps: float = 1e-3,
    whitener: "str | Whitener | None" = None,
    eval_matrix: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Any]:
    """Whiten channels-last ``x [..., C]`` per group of channels.

    ``train=True``: batch moments over all leading axes (f32 under bf16
    ``x``), the backend's train matrix from the batch covariance in its
    ``precision_policy(x.dtype)`` and the EMA update (see the module
    docstring); differentiable in ``x`` by autograd.  ``train=False``: the
    running stats, no state change.  ``eval_matrix`` is the precomputed
    ``[G, g, g]`` eval matrix from :func:`build_whiten_cache`; absent, it
    is computed from the running stats here, in f32.  In eval mode ``x``
    must be viewable as ``[M, C]`` (a channels-last activation is): the
    apply reads it without a copy, a bf16 ``x`` as bf16.

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
        w, aux = whitener.train_matrix(
            cov.to(whitener.precision_policy(x.dtype)), stats, eps)
        y = apply_whitening(xn, w, compute_dtype=x.dtype).to(x.dtype)
        return y, whitener.update_stats(stats, m, cov, momentum, aux)
    if eval_matrix is None:
        eval_matrix = whitener.eval_matrix(stats, eps, dtype)
    # The apply takes x in its own dtype: f32 (or f64) as is, bf16 through
    # the bf16 apply, which centres in f32 and rounds.
    y2d = cuda_whitening.whiten_apply(
        (x if x.dtype.itemsize < 4 else xf).view(-1, num_features),
        stats.mean.to(dtype),
        eval_matrix.to(dtype),
    )
    return y2d.view(x.shape).to(x.dtype), stats


# ------------------------------------------------- eval-matrix precompute


def _is_whitening_stats(value: Any) -> bool:
    return hasattr(value, "mean") and hasattr(value, "cov")


def build_whiten_cache(
    batch_stats: Dict[str, Any],
    whitener: "str | Whitener | None" = None,
    *,
    eps: float = 1e-3,
    eval_domain: int = 1,
    dtype: torch.dtype = torch.float32,
) -> Dict[str, Any]:
    """Precompute every whitening site's eval matrix from frozen stats.

    ``batch_stats`` is the JAX package's nested layout: a ``"whitening"``
    key holding domain-stacked stats (mean ``[D, C]``, cov
    ``[D, G, g, g]``, and for swbn ``w [D, G, g, g]``) at each site's
    scope path.  The ``eval_domain`` branch of every site is taken; for a
    factorizing backend all sites with equal ``g`` are factorized in ONE
    batched call, for swbn each site's matrix is its tracked ``w``.
    Returns ``{"whiten_cache": tree}`` (site scope → ``{"w": [G, g, g]}``),
    or ``{}`` with no whitening sites — the tree
    :func:`dwt_tpu.ops.whitening.build_whiten_cache` returns.
    """
    whitener = get_whitener(whitener)
    sites: List[Tuple[Tuple[str, ...], Any]] = []

    def walk(node: Dict[str, Any], path: Tuple[str, ...]) -> None:
        for key, value in node.items():
            if key == "whitening" and _is_whitening_stats(value):
                sites.append((path, type(value)(*(a[eval_domain] for a in value))))
            elif hasattr(value, "items"):
                walk(value, path + (key,))

    walk(batch_stats, ())
    if not sites:
        return {}

    matrices: Dict[Tuple[str, ...], torch.Tensor] = {}
    if whitener.matrix_from_cov is not None:
        by_g: Dict[int, List[Tuple[Tuple[str, ...], Any]]] = {}
        for path, branch in sites:
            by_g.setdefault(branch.cov.shape[-1], []).append((path, branch))
        for group in by_g.values():
            stacked = torch.cat([_shrink(b.cov.to(dtype), eps) for _, b in group])
            ws = whitener.matrix_from_cov(stacked)
            offset = 0
            for path, branch in group:
                n = branch.cov.shape[0]
                matrices[path] = ws[offset: offset + n]
                offset += n
    else:  # online backends (swbn): the matrix IS the running state
        for path, branch in sites:
            matrices[path] = whitener.eval_matrix(branch, eps, dtype)

    cache: Dict[str, Any] = {}
    for path, w in matrices.items():
        node = cache
        for key in path:
            node = node.setdefault(key, {})
        node["w"] = w
    return {WHITEN_CACHE_COL: cache}
