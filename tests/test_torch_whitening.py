"""Port parity: the whitening apply and eval factorization of ``dwt_tpu_torch``
against the live JAX package on the same numpy inputs.

``cuda_whitening.whiten_apply`` on CPU tensors takes its plain version;
the CUDA kernel itself is held to that plain version on the card by
``chip_smoke.py`` and by ``tests/test_torch_cuda.py``.  References on the JAX side: the Pallas ``_apply_call`` in
interpret mode, ``pallas_group_whiten(train=False)`` in interpret mode,
and the XLA op ``group_whiten(train=False, eval_matrix=...)``.

Tolerance: f32 ``rtol=atol=1e-5`` — the ops sum 4 products per output in
different orders (block-diagonal matmul vs grouped einsum) and the
factorizations differ (unrolled Cholesky vs LAPACK); f64 under
``jax.enable_x64`` is held to ``1e-12``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dwt_tpu.ops import whitening as jw
from dwt_tpu.ops.pallas_whitening import _apply_call, pallas_group_whiten
from dwt_tpu_torch.ops import cuda_whitening, whitening as tw

F32_TOL = dict(rtol=1e-5, atol=1e-5)
F64_TOL = dict(rtol=1e-12, atol=1e-12)
RAGGED_M = 1000  # not a multiple of the Pallas kernel's 512-row tile


def _spd_covs(rng, groups, g=4, dtype=np.float32):
    a = rng.normal(size=(groups, g, g))
    return (a @ np.swapaxes(a, -1, -2) / g + 0.5 * np.eye(g)).astype(dtype)


def _inputs(c, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    x = rng.normal(1.0, 2.0, size=(RAGGED_M, c)).astype(dtype)
    mean = rng.normal(0.0, 0.5, size=(c,)).astype(dtype)
    cov = _spd_covs(rng, c // 4, dtype=dtype)
    return x, mean, cov


def _jax_matrix(cov):
    return np.array(jw.whitening_matrix(jw._shrink(jnp.asarray(cov), 1e-3)))


@pytest.mark.parametrize("c", [64, 256])
def test_whitening_matrix_matches_jax(c):
    _, _, cov = _inputs(c)
    ours = tw.whitening_matrix(tw._shrink(torch.from_numpy(cov), 1e-3))
    np.testing.assert_allclose(ours.numpy(), _jax_matrix(cov), **F32_TOL)


@pytest.mark.parametrize("c", [64, 256])
def test_whiten_apply_matches_pallas_apply_call(c):
    x, mean, cov = _inputs(c)
    w = _jax_matrix(cov)
    ref = _apply_call(jnp.asarray(x), jnp.asarray(mean), jnp.asarray(w),
                      interpret=True)
    ours = cuda_whitening.whiten_apply(
        torch.from_numpy(x), torch.from_numpy(mean), torch.from_numpy(w))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **F32_TOL)


@pytest.mark.parametrize("c", [64, 256])
def test_group_whiten_matches_pallas_and_xla(c):
    x, mean, cov = _inputs(c, seed=1)
    jstats = jw.WhiteningStats(jnp.asarray(mean), jnp.asarray(cov))
    pallas_y, _ = pallas_group_whiten(
        jnp.asarray(x), jstats, group_size=4, train=False, interpret=True)
    xla_y, _ = jw.group_whiten(
        jnp.asarray(x), jstats, group_size=4, train=False,
        eval_matrix=jnp.asarray(_jax_matrix(cov)))
    tstats = tw.WhiteningStats(torch.from_numpy(mean), torch.from_numpy(cov))
    ours, _ = tw.group_whiten(torch.from_numpy(x), tstats, group_size=4,
                              train=False)
    np.testing.assert_allclose(ours.numpy(), np.asarray(pallas_y), **F32_TOL)
    np.testing.assert_allclose(ours.numpy(), np.asarray(xla_y), **F32_TOL)
    # The kernel path's drop-in (pallas_group_whiten's counterpart).
    kernel_path, same = cuda_whitening.cuda_group_whiten(
        torch.from_numpy(x), tstats, group_size=4, train=False)
    np.testing.assert_allclose(kernel_path.numpy(), np.asarray(pallas_y),
                               **F32_TOL)
    assert same is tstats


def test_group_whiten_matches_jax_in_f64():
    x, mean, cov = _inputs(64, seed=2, dtype=np.float64)
    with jax.enable_x64(True):
        w = np.asarray(jw.whitening_matrix(jw._shrink(jnp.asarray(cov), 1e-3)))
        ref, _ = jw.group_whiten(
            jnp.asarray(x), jw.WhiteningStats(jnp.asarray(mean), jnp.asarray(cov)),
            group_size=4, train=False, eval_matrix=jnp.asarray(w))
        ref = np.asarray(ref)
    assert ref.dtype == np.float64
    ours, _ = tw.group_whiten(
        torch.from_numpy(x),
        tw.WhiteningStats(torch.from_numpy(mean), torch.from_numpy(cov)),
        group_size=4, train=False)
    assert ours.dtype == torch.float64
    np.testing.assert_allclose(ours.numpy(), ref, **F64_TOL)


def test_group_whiten_train_mode_is_next_slice():
    """Train mode landed with the port's second slice (its parity tests are
    in ``test_torch_moments.py``); the whiteners other than Cholesky came
    later (``test_torch_whiteners.py``), each with its own stats: SWBN's
    carry the tracked matrix, which plain whitening stats lack."""
    stats = tw.init_whitening_stats(8, 4)
    y, new = tw.group_whiten(torch.randn(3, 8), stats, group_size=4, train=True)
    assert y.shape == (3, 8) and not torch.equal(new.cov, stats.cov)
    swbn = tw.get_whitener("swbn").init_stats(8, 4)
    y, new = tw.group_whiten(torch.randn(3, 8), swbn, group_size=4, train=True,
                             whitener="swbn")
    assert y.shape == (3, 8) and isinstance(new, tw.SWBNStats)
    assert not torch.equal(new.w, swbn.w)
    with pytest.raises(AttributeError):
        tw.group_whiten(torch.zeros(3, 8), stats, group_size=4, train=True,
                        whitener="swbn")


def test_init_stats_all_ones_cov_and_group_divisibility():
    stats = tw.init_whitening_stats(64, 4)
    ref = jw.init_whitening_stats(64, 4)
    np.testing.assert_array_equal(stats.cov.numpy(), np.asarray(ref.cov))
    np.testing.assert_array_equal(stats.mean.numpy(), np.asarray(ref.mean))
    with pytest.raises(ValueError):
        tw.init_whitening_stats(6, 4)


def _stats_tree(rng, lib):
    """Two nested sites with domain-stacked stats, plus a BN site the
    cache builder must skip."""
    def site(c):
        mean = rng.normal(size=(3, c)).astype(np.float32)
        cov = np.stack([_spd_covs(rng, c // 4) for _ in range(3)])
        return mean, cov

    (m1, c1), (m2, c2) = site(64), site(256)
    return {
        "dn1": {"whitening": lib.WhiteningStats(m1, c1)},
        "layer1_0": {
            "dn3": {"whitening": lib.WhiteningStats(m2, c2)},
            "dn9": {"bn": {"mean": m1[0], "var": np.abs(m1[0]) + 1}},
        },
    }


def test_build_whiten_cache_matches_jax():
    rng = np.random.default_rng(3)
    tree = _stats_tree(rng, jw)
    ref = jw.build_whiten_cache(
        jax.tree.map(jnp.asarray, tree), "cholesky", eval_domain=1)
    ttree = jax.tree.map(
        torch.from_numpy, _stats_tree(np.random.default_rng(3), tw),
        is_leaf=lambda v: isinstance(v, np.ndarray))
    ours = tw.build_whiten_cache(ttree, eval_domain=1)
    ref_c, ours_c = ref[jw.WHITEN_CACHE_COL], ours[tw.WHITEN_CACHE_COL]
    assert set(ours_c) == {"dn1", "layer1_0"}
    assert set(ours_c["layer1_0"]) == {"dn3"}
    np.testing.assert_allclose(ours_c["dn1"]["w"].numpy(),
                               np.asarray(ref_c["dn1"]["w"]), **F32_TOL)
    np.testing.assert_allclose(ours_c["layer1_0"]["dn3"]["w"].numpy(),
                               np.asarray(ref_c["layer1_0"]["dn3"]["w"]),
                               **F32_TOL)
    assert tw.build_whiten_cache({"x": {"bn": {"mean": torch.zeros(2)}}}) == {}
