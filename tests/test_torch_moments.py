"""Port parity: the whitening moments and train-mode whitening of
``dwt_tpu_torch`` against the live JAX package on the same numpy inputs.

``cuda_whitening.whiten_moments`` and ``cuda_group_whiten`` on CPU tensors
take the plain versions of the kernels; the CUDA kernels themselves are
held to those plain versions on the card by ``chip_smoke.py`` and by
``tests/test_torch_cuda.py``.  References on the JAX side: the Pallas
``_moments_call`` and ``pallas_group_whiten(train=True)`` in interpret
mode, the XLA op ``group_whiten(train=True)``, and a numpy float64
two-pass moment computation.

Tolerances, with their reasons:

* moments: mean ``rtol=atol=1e-6``, cov ``rtol=1e-4, atol=1e-5`` — the
  JAX package's own ``test_moments_match_two_pass`` tolerance: f32 sums in
  other orders, and ``E[xxᵀ] − m mᵀ`` in the Pallas kernel cancels
  leading bits;
* train-mode outputs ``rtol=2e-4, atol=2e-5``; new stats mean
  ``1e-4/1e-5``, cov ``1e-3/1e-4`` (the cov goes through the same sums;
  the EMA scales errors by momentum);
* input gradients of ``sum(y·r)`` ``rtol=2e-3, atol=5e-5`` in f32 — the
  gradient runs back through the Cholesky factor of a batch covariance
  (LAPACK in torch, unrolled in JAX); ``1e-8`` in f64.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dwt_tpu.ops import whitening as jw
from dwt_tpu.ops.pallas_whitening import _moments_call, pallas_group_whiten
from dwt_tpu_torch.nn import norms
from dwt_tpu_torch.ops import cuda_whitening as cw
from dwt_tpu_torch.ops import whitening as tw

MEAN_TOL = dict(rtol=1e-6, atol=1e-6)
COV_TOL = dict(rtol=1e-4, atol=1e-5)
Y_TOL = dict(rtol=2e-4, atol=2e-5)
STAT_MEAN_TOL = dict(rtol=1e-4, atol=1e-5)
STAT_COV_TOL = dict(rtol=1e-3, atol=1e-4)
GRAD_TOL = dict(rtol=2e-3, atol=5e-5)
GRAD_F64_TOL = dict(rtol=1e-8, atol=1e-10)


def _x(m, c, seed=0, offset=0.0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    # Correlated channels within a group, so the covariances are not
    # diagonal.
    x = rng.normal(size=(m, c))
    x = x + 0.5 * np.roll(x, 1, axis=1)
    return (x + offset).astype(dtype)


def _two_pass_f64(x, g=4):
    x = x.astype(np.float64)
    mean = x.mean(axis=0)
    t = (x - mean).reshape(x.shape[0], -1, g)
    return mean, np.einsum("mgc,mgd->gcd", t, t) / x.shape[0]


@pytest.mark.parametrize("m,c,offset", [
    (7, 64, 0.0),        # ragged, far under one 512-row tile
    (1000, 64, 0.0),     # under two tiles, ragged
    (1000, 256, 0.0),
    (1536, 64, 0.0),     # several whole tiles
    (1536, 256, 3.0),    # a channel-mean offset: the cancellation case
])
def test_moments_match_pallas_and_two_pass(m, c, offset):
    x = _x(m, c, seed=m + c, offset=offset)
    mean, cov = cw.whiten_moments(torch.from_numpy(x), 4)
    ref_mean, ref_cov = _two_pass_f64(x)
    np.testing.assert_allclose(mean.numpy(), ref_mean, **MEAN_TOL)
    np.testing.assert_allclose(cov.numpy(), ref_cov, **COV_TOL)
    p_mean, p_cov = _moments_call(jnp.asarray(x), c // 4, 4, interpret=True)
    np.testing.assert_allclose(mean.numpy(), np.asarray(p_mean), **MEAN_TOL)
    np.testing.assert_allclose(cov.numpy(), np.asarray(p_cov), **COV_TOL)


def _domains(d, m, c, seed, offset, dtype=np.float32):
    """``[D, M, C]``: each domain its own draw, domain ``i`` shifted by
    ``offset − i``, so the domains' moments differ.  (Above an offset of 4
    the Pallas reference's ``E[xxᵀ] − m mᵀ`` in f32 leaves the cov
    tolerance.)"""
    return np.stack([_x(m, c, seed=seed + i, offset=offset - i, dtype=dtype)
                     for i in range(d)])


@pytest.mark.parametrize("d", [1, 2, 3])
@pytest.mark.parametrize("m,c,offset", [(1000, 64, 0.0), (1000, 256, 4.0),
                                        (777, 64, 4.0)])
def test_batched_moments_match_pallas_per_domain(d, m, c, offset):
    """One call on ``[D, M, C]`` (ragged M, a channel-mean offset of 4)
    against the Pallas ``_moments_call`` and a float64 two-pass run on
    each domain on its own."""
    x = _domains(d, m, c, seed=m + c, offset=offset)
    mean, cov = cw.whiten_moments(torch.from_numpy(x), 4)
    assert mean.shape == (d, c) and cov.shape == (d, c // 4, 4, 4)
    for i in range(d):
        p_mean, p_cov = _moments_call(jnp.asarray(x[i]), c // 4, 4,
                                      interpret=True)
        np.testing.assert_allclose(mean[i].numpy(), np.asarray(p_mean), **MEAN_TOL)
        np.testing.assert_allclose(cov[i].numpy(), np.asarray(p_cov), **COV_TOL)
        ref_mean, ref_cov = _two_pass_f64(x[i])
        np.testing.assert_allclose(mean[i].numpy(), ref_mean, **MEAN_TOL)
        np.testing.assert_allclose(cov[i].numpy(), ref_cov, **COV_TOL)


@pytest.mark.parametrize("d", [1, 2, 3])
def test_batched_moments_match_jax_in_f64(d):
    """The same in float64 under ``jax.enable_x64``: against the Pallas
    kernel (which accumulates in f32 by design, so at the f32 tolerances)
    and against the JAX op's own moments, the mean and ``group_cov`` of
    the centred input in float64, at 1e-12."""
    m, c = 1000, 64
    x = _domains(d, m, c, seed=41, offset=4.0, dtype=np.float64)
    mean, cov = cw.whiten_moments(torch.from_numpy(x), 4)
    assert mean.dtype == cov.dtype == torch.float64
    with jax.enable_x64(True):
        for i in range(d):
            xi = jnp.asarray(x[i])
            p_mean, p_cov = _moments_call(xi, c // 4, 4, interpret=True)
            np.testing.assert_allclose(mean[i].numpy(), np.asarray(p_mean),
                                       **MEAN_TOL)
            np.testing.assert_allclose(cov[i].numpy(), np.asarray(p_cov),
                                       **COV_TOL)
            j_mean = xi.mean(axis=0)
            j_cov = jw.group_cov(xi - j_mean, c // 4, 4)
            assert j_cov.dtype == jnp.float64
            np.testing.assert_allclose(mean[i].numpy(), np.asarray(j_mean),
                                       rtol=1e-12, atol=1e-12)
            np.testing.assert_allclose(cov[i].numpy(), np.asarray(j_cov),
                                       rtol=1e-12, atol=1e-12)


def test_two_and_three_dimensional_inputs_agree():
    """``[M, C]`` and ``[1, M, C]`` give the same numbers, in their own
    shapes."""
    x = torch.from_numpy(_x(333, 64, seed=3, offset=4.0))
    mean2, cov2 = cw.whiten_moments(x, 4)
    mean3, cov3 = cw.whiten_moments(x[None], 4)
    assert mean2.shape == (64,) and cov2.shape == (16, 4, 4)
    assert mean3.shape == (1, 64) and cov3.shape == (1, 16, 4, 4)
    torch.testing.assert_close(mean3[0], mean2, rtol=0, atol=0)
    torch.testing.assert_close(cov3[0], cov2, rtol=0, atol=0)


def test_a_site_takes_one_moments_call_for_all_domains(monkeypatch):
    """A ``DomainWhiten`` site in train mode calls ``whiten_moments`` once,
    on its whole ``[D, M, C]``, and factorizes all domains at once."""
    calls, factorized = [], []
    moments, matrix = cw.whiten_moments, tw.whitening_matrix

    def counted(x, group_size):
        calls.append(tuple(x.shape))
        return moments(x, group_size)

    def counted_matrix(cov):
        factorized.append(tuple(cov.shape))
        return matrix(cov)

    monkeypatch.setattr(cw, "whiten_moments", counted)
    monkeypatch.setattr(tw, "whitening_matrix", counted_matrix)
    site = norms.DomainWhiten(8, 4, num_domains=3).train()
    x = torch.randn(6, 8, 3, 2).contiguous(memory_format=torch.channels_last)
    site(x)
    assert calls == [(3, 2 * 3 * 2, 8)]
    assert factorized == [(3, 2, 4, 4)]


def test_cpu_moments_take_the_plain_version_without_launch():
    x = torch.from_numpy(_x(100, 64))
    before = cw.moments_launches
    mean, cov = cw.whiten_moments(x, 4)
    assert cw.moments_launches == before
    p_mean, p_cov = cw.whiten_moments_plain(x, 4)
    torch.testing.assert_close(mean, p_mean, rtol=0, atol=0)
    torch.testing.assert_close(cov, p_cov, rtol=0, atol=0)
    assert cov.shape == (16, 4, 4)
    with pytest.raises(ValueError, match="unsupported device"):
        cw.whiten_moments(x.to("meta"), 4)


def test_group_cov_matches_jax():
    x = _x(300, 64, seed=5)
    xn = x - x.mean(axis=0)
    ours = tw.group_cov(torch.from_numpy(xn), 16, 4)
    ref = jw.group_cov(jnp.asarray(xn), 16, 4)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **COV_TOL)


def _spd_stats(c, seed, lib, to):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(c // 4, 4, 4))
    cov = (a @ np.swapaxes(a, -1, -2) / 4 + 0.5 * np.eye(4)).astype(np.float32)
    mean = rng.normal(0, 0.3, size=(c,)).astype(np.float32)
    return lib.WhiteningStats(to(mean), to(cov))


@pytest.mark.parametrize("c,init", [(64, "ones"), (256, "spd")])
def test_train_whiten_matches_pallas_and_xla(c, init):
    x = _x(1000, c, seed=11, offset=1.0)
    if init == "ones":
        jstats = jw.init_whitening_stats(c, 4)
        tstats = tw.init_whitening_stats(c, 4)
    else:
        jstats = _spd_stats(c, 3, jw, jnp.asarray)
        tstats = _spd_stats(c, 3, tw, torch.from_numpy)
    ours, ours_stats = cw.cuda_group_whiten(
        torch.from_numpy(x), tstats, group_size=4, train=True, momentum=0.1)
    refs = [
        jax.jit(lambda xx, st, fn=fn: fn(xx, st, group_size=4, train=True,
                                          momentum=0.1, **kw))(
            jnp.asarray(x), jstats)
        for fn, kw in [(pallas_group_whiten, dict(interpret=True)),
                       (jw.group_whiten, {})]
    ]
    plain, plain_stats = tw.group_whiten(
        torch.from_numpy(x), tstats, group_size=4, train=True, momentum=0.1)
    for y, stats in [(ours, ours_stats), (plain, plain_stats)]:
        for ref_y, ref_stats in refs:
            np.testing.assert_allclose(y.numpy(), np.asarray(ref_y), **Y_TOL)
            np.testing.assert_allclose(stats.mean.numpy(),
                                       np.asarray(ref_stats.mean), **STAT_MEAN_TOL)
            np.testing.assert_allclose(stats.cov.numpy(),
                                       np.asarray(ref_stats.cov), **STAT_COV_TOL)


def _jax_grad(x, r, pallas):
    stats = jw.init_whitening_stats(x.shape[-1], 4, x.dtype)

    def f(xx):
        if pallas:
            y, _ = pallas_group_whiten(xx, stats, group_size=4, train=True,
                                       interpret=True)
        else:
            y, _ = jw.group_whiten(xx, stats, group_size=4, train=True)
        return jnp.sum(y * r)

    return np.asarray(jax.jit(jax.grad(f))(jnp.asarray(x)))


def _torch_grad(x, r):
    xt = torch.from_numpy(x).requires_grad_(True)
    stats = tw.init_whitening_stats(x.shape[-1], 4, dtype=xt.dtype)
    y, _ = cw.cuda_group_whiten(xt, stats, group_size=4, train=True)
    (y * torch.from_numpy(r)).sum().backward()
    return xt.grad.numpy()


@pytest.mark.parametrize("c", [64, 256])
def test_train_whiten_input_gradients_match_jax(c):
    x = _x(600, c, seed=21, offset=0.5)
    r = np.random.default_rng(22).normal(size=x.shape).astype(np.float32)
    ours = _torch_grad(x, r)
    np.testing.assert_allclose(ours, _jax_grad(x, r, pallas=True), **GRAD_TOL)
    np.testing.assert_allclose(ours, _jax_grad(x, r, pallas=False), **GRAD_TOL)


def test_train_whiten_input_gradients_match_jax_in_f64():
    x = _x(400, 64, seed=23, offset=0.5, dtype=np.float64)
    r = np.random.default_rng(24).normal(size=x.shape)
    with jax.enable_x64(True):
        ref = _jax_grad(x, r, pallas=False)
    assert ref.dtype == np.float64
    ours = _torch_grad(x, r)
    assert ours.dtype == np.float64
    np.testing.assert_allclose(ours, ref, **GRAD_F64_TOL)


def test_train_whiten_updates_stats_once_and_backward_leaves_them():
    """The EMA runs in forward; the backward's recompute never reaches
    the running stats, and the moments get no gradient."""
    site = norms.DomainWhiten(8, 4, num_domains=3).train()
    x = torch.randn(6, 8, 3, 2).contiguous(memory_format=torch.channels_last)
    x.requires_grad_(True)
    y = site(x)
    after_forward = site.cov.clone()
    assert not torch.equal(after_forward, torch.ones_like(after_forward))
    y.square().sum().backward()
    torch.testing.assert_close(site.cov, after_forward, rtol=0, atol=0)
    assert x.grad is not None and torch.isfinite(x.grad).all()


def test_domain_split_is_a_view_of_the_channels_last_activation():
    """Each domain's [M_d, C] slice starts at the activation's own storage
    at offset d · M_d · C: no copy on the way to the kernels."""
    d, n, c, h, w = 3, 2, 8, 5, 3
    act = torch.randn(d * n, c, h, w).contiguous(memory_format=torch.channels_last)
    seen = []

    def record(x3):
        seen.extend(x3[i].data_ptr() for i in range(d))
        assert all(x3[i].is_contiguous() for i in range(d))
        return x3

    y = norms.apply_domain_norm(act, d, record)
    m_d = n * h * w
    assert seen == [act.data_ptr() + i * m_d * c * act.element_size()
                    for i in range(d)]
    assert y.data_ptr() == act.data_ptr() and y.shape == (d * n, h, w, c)
    # An NCHW-contiguous activation cannot be viewed that way: the layout
    # slip raises rather than being copied.
    seen.clear()
    with pytest.raises(RuntimeError, match="view"):
        norms.apply_domain_norm(act.contiguous(), d, record)
    assert not seen


def test_stacked_branches_match_one_call_per_domain():
    """``cuda_group_whiten`` with stats stacked on a domain axis (what a
    ``DomainWhiten`` site calls) equals one single-branch call per
    domain: outputs and each branch's EMA."""
    d, m, c = 3, 200, 16
    x = torch.from_numpy(_x(d * m, c, seed=31, offset=0.5)).view(d, m, c)
    stacked = tw.WhiteningStats(*(torch.stack([getattr(
        _spd_stats(c, 40 + i, tw, torch.from_numpy), f) for i in range(d)])
        for f in ("mean", "cov")))
    y, new = cw.cuda_group_whiten(x, stacked, group_size=4, train=True,
                                  momentum=0.3)
    for i in range(d):
        y_i, new_i = cw.cuda_group_whiten(
            x[i], tw.WhiteningStats(stacked.mean[i], stacked.cov[i]),
            group_size=4, train=True, momentum=0.3)
        torch.testing.assert_close(y[i], y_i, rtol=0, atol=0)
        torch.testing.assert_close(new.mean[i], new_i.mean, rtol=0, atol=0)
        torch.testing.assert_close(new.cov[i], new_i.cov, rtol=0, atol=0)


def test_unported_whiteners_raise():
    """Every JAX whitener is ported now; an unknown name raises."""
    assert tw.get_whitener("newton_schulz").name == "newton_schulz"
    assert tw.WHITENER_NAMES == ("cholesky", "newton_schulz", "swbn")
    with pytest.raises(ValueError, match="unknown whitener"):
        tw.get_whitener("zca")
    assert tw.get_whitener(None) is tw.get_whitener("cholesky")
