"""Port parity: the domain-batched whitening apply of ``dwt_tpu_torch``
against the live JAX package on the same numpy inputs.

``cuda_whitening.whiten_apply`` takes ``x [D, M, C]`` with ``mean [D, C]``
and ``w [D, G, 4, 4]`` — a train site's D domain branches, each with its
own moments and matrix — in one call (one launch on the card).  On CPU
tensors it takes its plain version, which these tests hold, domain by
domain, to the Pallas ``_apply_call`` in interpret mode and to the JAX op;
the CUDA kernel itself is held to the plain version on the card by
``chip_smoke.py`` and by ``tests/test_torch_cuda.py``.

Tolerances, with their reasons:

* f32 ``rtol=atol=1e-5``: 4 products summed per output in another order
  (block-diagonal matmul vs grouped einsum);
* float64 under ``jax.enable_x64``: ``1e-12`` against the JAX op's eval
  apply (``group_whiten(train=False, eval_matrix=w)``).  The Pallas
  ``_apply_kernel`` subtracts and accumulates in f32 whatever the input
  dtype, so against it the f64 run is held at the f32 tolerance;
* train-mode outputs and stats as in ``test_torch_moments.py`` (the
  batch covariance goes through another Cholesky).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dwt_tpu.ops import whitening as jw
from dwt_tpu.ops.pallas_whitening import _apply_call, pallas_group_whiten
from dwt_tpu_torch.nn import build_lenet, norms
from dwt_tpu_torch.ops import cuda_whitening as cw
from dwt_tpu_torch.ops import whitening as tw

F32_TOL = dict(rtol=1e-5, atol=1e-5)
F64_TOL = dict(rtol=1e-12, atol=1e-12)
Y_TOL = dict(rtol=2e-4, atol=2e-5)
STAT_MEAN_TOL = dict(rtol=1e-4, atol=1e-5)
STAT_COV_TOL = dict(rtol=1e-3, atol=1e-4)
# (D, M, C): one domain at a ragged M and C = 32 (G = 8); two at C = 48
# (G = 12, LeNet-DWT's dn2); three at ResNet-DWT's C = 64 and 256.
SHAPES = [(1, 37, 32), (2, 200, 48), (3, 96, 64), (3, 50, 256)]


def _inputs(d, m, c, seed, dtype=np.float32):
    """``x [D, M, C]``, ``mean [D, C]`` and the whitening matrices ``w [D,
    G, 4, 4]`` of SPD group covariances, each domain its own draw.  The
    means are float32 values, so that the Pallas kernel's f32 cast of the
    mean is exact in the float64 run."""
    rng = np.random.default_rng(seed)
    x = rng.normal(1.0, 2.0, size=(d, m, c)).astype(dtype)
    mean = rng.normal(0.0, 0.5, size=(d, c)).astype(np.float32).astype(dtype)
    a = rng.normal(size=(d, c // 4, 4, 4))
    cov = (a @ np.swapaxes(a, -1, -2) / 4 + 0.5 * np.eye(4)).astype(dtype)
    with jax.enable_x64(dtype == np.float64):
        w = np.asarray(jw.whitening_matrix(jw._shrink(jnp.asarray(cov), 1e-3)))
    return x, mean, w.astype(dtype)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("d,m,c", SHAPES)
def test_batched_apply_matches_jax_per_domain(d, m, c, dtype):
    """One call on ``[D, M, C]`` against the Pallas ``_apply_call`` (and,
    in float64, the JAX op) on each domain on its own."""
    x, mean, w = _inputs(d, m, c, seed=d * m + c, dtype=dtype)
    before = cw.apply_launches
    ours = cw.whiten_apply(*map(torch.from_numpy, (x, mean, w))).numpy()
    assert cw.apply_launches == before  # CPU tensors: the plain version
    assert ours.shape == (d, m, c) and ours.dtype == dtype
    with jax.enable_x64(dtype == np.float64):
        for i in range(d):
            ref = _apply_call(jnp.asarray(x[i]), jnp.asarray(mean[i]),
                              jnp.asarray(w[i]), interpret=True)
            np.testing.assert_allclose(ours[i], np.asarray(ref), **F32_TOL)
            if dtype == np.float64:
                op, _ = jw.group_whiten(
                    jnp.asarray(x[i]),
                    jw.WhiteningStats(jnp.asarray(mean[i]),
                                      jnp.ones((c // 4, 4, 4), jnp.float64)),
                    group_size=4, train=False, eval_matrix=jnp.asarray(w[i]))
                assert op.dtype == jnp.float64
                np.testing.assert_allclose(ours[i], np.asarray(op), **F64_TOL)


@pytest.mark.parametrize("d,m,c", SHAPES)
def test_batched_apply_equals_one_call_per_domain(d, m, c):
    """The ``[D, M, C]`` form and the ``[M, C]`` form per domain give the
    same numbers, and ``out`` receives them."""
    x, mean, w = map(torch.from_numpy, _inputs(d, m, c, seed=7))
    out = torch.full((d, m, c), float("nan"))
    y = cw.whiten_apply(x, mean, w, out=out)
    assert y.data_ptr() == out.data_ptr()
    for i in range(d):
        torch.testing.assert_close(out[i], cw.whiten_apply(x[i], mean[i], w[i]),
                                   rtol=0, atol=0)


def _count_apply_calls(monkeypatch):
    calls = []
    apply = cw.whiten_apply

    def counted(x, mean, w, out=None):
        calls.append(tuple(x.shape))
        return apply(x, mean, w, out=out)

    monkeypatch.setattr(cw, "whiten_apply", counted)
    return calls


def test_a_site_takes_one_apply_call_for_all_domains(monkeypatch):
    """A ``DomainWhiten`` site in train mode calls ``whiten_apply`` once, on
    its whole ``[D, M, C]`` (one launch on the card)."""
    calls = _count_apply_calls(monkeypatch)
    site = norms.DomainWhiten(8, 4, num_domains=3).train()
    x = torch.randn(6, 8, 3, 2).contiguous(memory_format=torch.channels_last)
    site(x)
    assert calls == [(3, 2 * 3 * 2, 8)]


def test_a_lenet_train_forward_takes_one_apply_call_per_site(monkeypatch):
    """LeNet-DWT's train forward: one ``whiten_apply`` call per whitened
    site (dn1 at C = 32, dn2 at C = 48), each on both domains; its eval
    forward: one call per site on ``[M, C]``."""
    calls = _count_apply_calls(monkeypatch)
    model = build_lenet(seed=0).to(memory_format=torch.channels_last)
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(2, 3, 28, 28, 1)).astype(np.float32))
    with torch.no_grad():
        model.train()(x)
        assert calls == [(2, 3 * 28 * 28, 32), (2, 3 * 14 * 14, 48)]
        calls.clear()
        model.eval()(x[1])
    assert calls == [(3 * 28 * 28, 32), (3 * 14 * 14, 48)]


def _spd_stats(d, c, seed, lib, to):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(d, c // 4, 4, 4))
    cov = (a @ np.swapaxes(a, -1, -2) / 4 + 0.5 * np.eye(4)).astype(np.float32)
    mean = rng.normal(0, 0.3, size=(d, c)).astype(np.float32)
    return lib.WhiteningStats(to(mean), to(cov))


@pytest.mark.parametrize("d,m,c", SHAPES)
def test_train_mode_matches_pallas_group_whiten_per_domain(d, m, c):
    """``cuda_group_whiten`` in train mode on ``[D, M, C]`` with stacked
    stats (what a ``DomainWhiten`` site calls: one moments and one apply
    call) against ``pallas_group_whiten(train=True)`` in interpret mode on
    each domain: outputs and each branch's EMA."""
    rng = np.random.default_rng(m + c)
    x = rng.normal(size=(d, m, c))
    x = (x + 0.5 * np.roll(x, 1, axis=2) + 1.0).astype(np.float32)
    tstats = _spd_stats(d, c, 3, tw, torch.from_numpy)
    jstats = _spd_stats(d, c, 3, jw, jnp.asarray)
    y, new = cw.cuda_group_whiten(torch.from_numpy(x), tstats, group_size=4,
                                  train=True, momentum=0.1)
    assert y.shape == (d, m, c)
    step = jax.jit(lambda xx, st: pallas_group_whiten(
        xx, st, group_size=4, train=True, momentum=0.1, interpret=True))
    for i in range(d):
        ref_y, ref_stats = step(jnp.asarray(x[i]), jw.WhiteningStats(
            jstats.mean[i], jstats.cov[i]))
        np.testing.assert_allclose(y[i].numpy(), np.asarray(ref_y), **Y_TOL)
        np.testing.assert_allclose(new.mean[i].numpy(), np.asarray(ref_stats.mean),
                                   **STAT_MEAN_TOL)
        np.testing.assert_allclose(new.cov[i].numpy(), np.asarray(ref_stats.cov),
                                   **STAT_COV_TOL)
