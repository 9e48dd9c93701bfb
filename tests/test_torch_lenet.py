"""Port parity: LeNet-DWT of ``dwt_tpu_torch`` against the live JAX package.

The model is the full LeNet-DWT (conv 1→32→48, whitened sites ``dn1`` at
C = 32 and ``dn2`` at C = 48 in groups of 4, dense 2352→100→100→10 with
BN sites ``dn3``–``dn5``, 2 domain branches, eval branch 1) at 28×28, 8
images per domain.  Params come from the JAX ``model.init`` with perturbed
affines and biases; the running stats are randomized with numpy (means,
SPD covariances, positive variances) so that no site runs on its init
values.  The port runs on the CPU (the kernels' plain versions) and is
held to the JAX model through the XLA path and through the Pallas
kernels in interpret mode (``use_pallas=True``).

Tolerances: f32 logits, outputs and running stats ``rtol = atol = 1e-4``
(convolutions and the Cholesky factors sum in other orders in XLA and in
PyTorch's CPU kernels; the largest difference reads ~1.5e-5 on logits of
magnitude ~2); float64 under ``jax.enable_x64(True)`` (XLA path; the
Pallas kernels accumulate in f32 by design) ``rtol = atol = 1e-10``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dwt_tpu.nn import LeNetDWT as JaxLeNetDWT
from dwt_tpu.train.evalpipe import make_whiten_cache_fn
from dwt_tpu.train.steps import make_serve_forward
from dwt_tpu_torch.convert import load_jax_variables
from dwt_tpu_torch.nn import LeNetDWT, build_lenet
from dwt_tpu_torch.train.evalpipe import install_whiten_cache, make_whiten_cache

N = 8
TOL = dict(rtol=1e-4, atol=1e-4)
F64_TOL = dict(rtol=1e-10, atol=1e-10)


def _randomize(params, stats, rng, dtype=np.float32):
    """Perturbed affines and biases; SPD covariances, positive variances,
    small means and nonzero counts."""
    params = jax.tree.map(
        lambda a: (a + rng.normal(0, 0.1, a.shape) if a.ndim == 1 else a)
        .astype(dtype), params)

    def leaf(path, a):
        name = getattr(path[-1], "name", str(path[-1]))
        if name == "cov":
            m = rng.normal(size=a.shape)
            return (m @ np.swapaxes(m, -1, -2) / 4 + 0.5 * np.eye(4)).astype(dtype)
        if name == "var":
            return rng.uniform(0.5, 2.0, size=a.shape).astype(dtype)
        if name == "mean":
            return rng.normal(0.0, 0.2, size=a.shape).astype(dtype)
        return np.full(a.shape, 3, a.dtype)  # count

    return params, jax.tree_util.tree_map_with_path(leaf, stats)


def _init(dtype=np.float32):
    """``(params, batch_stats)`` as numpy trees: JAX's init, randomized."""
    model = JaxLeNetDWT(group_size=4)
    variables = jax.jit(lambda k: model.init(
        k, jnp.zeros((2, N, 28, 28, 1)), train=True))(jax.random.key(0))
    return _randomize(jax.tree.map(np.asarray, variables["params"]),
                      jax.tree.map(np.asarray, variables["batch_stats"]),
                      np.random.default_rng(0), dtype)


@pytest.fixture(scope="module")
def tied():
    """``(params, batch_stats, train images [2, N, 28, 28, 1], eval
    images [5, 28, 28, 1])``."""
    params, stats = _init()
    rng = np.random.default_rng(1)
    x_train = rng.normal(size=(2, N, 28, 28, 1)).astype(np.float32)
    x_eval = rng.normal(size=(5, 28, 28, 1)).astype(np.float32)
    return params, stats, x_train, x_eval


def _port(params, stats, dtype=torch.float32) -> LeNetDWT:
    port = LeNetDWT(group_size=4).to(dtype)
    load_jax_variables(port, params, stats)
    return port.to(memory_format=torch.channels_last)


def _stats_of(port) -> dict:
    return {k: v.detach().numpy() for k, v in port.state_dict().items()
            if not k.endswith(("weight", "bias", "gamma", "beta"))}


def test_bridge_ties_every_flax_leaf(tied):
    """Every Flax leaf has a port counterpart of the same scope name, and
    the layouts follow the bridge's rules (HWIO→OIHW, [in, out]→[out,
    in]); the conv biases are tied too."""
    params, stats, _, _ = tied
    port = _port(params, stats)
    assert [n for n, _ in port.named_children()] == [
        "conv1", "dn1", "conv2", "dn2", "fc3", "dn3", "fc4", "dn4", "fc5", "dn5"]
    np.testing.assert_array_equal(port.conv2.weight.detach().numpy(),
                                  params["conv2"]["kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(port.conv1.bias.detach().numpy(),
                                  params["conv1"]["bias"])
    np.testing.assert_array_equal(port.fc3.weight.detach().numpy(),
                                  params["fc3"]["kernel"].T)
    np.testing.assert_array_equal(port.dn2.cov.numpy(),
                                  stats["dn2"]["whitening"].cov)
    assert port.dn1.cov.shape == (2, 8, 4, 4) and port.dn2.cov.shape == (2, 12, 4, 4)


def test_bridge_fails_loudly_on_lenet(tied):
    params, stats, _, _ = tied
    missing = {k: v for k, v in params.items()}
    missing["conv1"] = {"kernel": params["conv1"]["kernel"]}
    with pytest.raises(KeyError, match="conv1/bias"):
        load_jax_variables(LeNetDWT(), missing, stats)
    extra = {**params, "fc6": {"kernel": np.zeros((10, 10), np.float32)}}
    with pytest.raises(ValueError, match="fc6"):
        load_jax_variables(LeNetDWT(), extra, stats)
    bad = {**params, "fc3": {**params["fc3"], "kernel": params["fc3"]["kernel"][:-1]}}
    with pytest.raises(ValueError, match="fc3/kernel"):
        load_jax_variables(LeNetDWT(), bad, stats)
    bad_stats = {**stats, "dn2": {"whitening": stats["dn1"]["whitening"]}}
    with pytest.raises(ValueError, match="dn2/whitening/mean"):
        load_jax_variables(LeNetDWT(), params, bad_stats)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_eval_logits_match_jax(tied, use_pallas):
    """Eval mode through branch 1, each site factorizing its own stats."""
    params, stats, _, x = tied
    model = JaxLeNetDWT(group_size=4, use_pallas=use_pallas)
    ref = jax.jit(lambda x: model.apply(
        {"params": params, "batch_stats": stats}, x, train=False))(x)
    port = _port(params, stats).eval()
    with torch.no_grad():
        ours = port(torch.from_numpy(x)).numpy()
    assert ours.shape == (5, 10)
    np.testing.assert_allclose(ours, np.asarray(ref), **TOL)


def test_eval_logits_with_whiten_cache_match_serve_forward(tied):
    """The deployment forward: both sites read the eval matrices of one
    batched factorization (the port's cache against JAX's)."""
    params, stats, _, x = tied
    model = JaxLeNetDWT(group_size=4)
    cache = make_whiten_cache_fn("cholesky")(stats)
    ref = jax.jit(make_serve_forward(model))(params, stats, cache, x)
    port = _port(params, stats).eval()
    port_cache = make_whiten_cache(port)
    assert sorted(port_cache) == ["dn1", "dn2"]
    np.testing.assert_allclose(
        port_cache["dn2"].numpy(),
        np.asarray(cache["whiten_cache"]["dn2"]["w"]), **TOL)
    install_whiten_cache(port, port_cache)
    with torch.no_grad():
        ours = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(ours, np.asarray(ref), **TOL)


def _jax_train(params, stats, x, use_pallas=False, dtype=jnp.float32):
    model = JaxLeNetDWT(group_size=4, use_pallas=use_pallas, dtype=dtype)
    return jax.jit(lambda p, s, x: model.apply(
        {"params": p, "batch_stats": s}, x, train=True,
        mutable=["batch_stats"]))(params, stats, x)


def _assert_stats_match(port, params, new_stats, dtype, tol):
    """Every running stat of ``port`` against JAX's updated
    ``batch_stats``, read into a second port model through the bridge."""
    ref = _stats_of(_port(params, jax.tree.map(np.asarray, new_stats["batch_stats"]),
                          dtype))
    for name, value in _stats_of(port).items():
        np.testing.assert_allclose(value, ref[name], err_msg=name, **tol)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_train_outputs_and_stats_match_jax(tied, use_pallas):
    """One train-mode forward: logits ``[2, N, 10]`` and every site's
    advanced running stats (both domains, whitening and BN)."""
    params, stats, x, _ = tied
    ref, new_stats = _jax_train(params, stats, x, use_pallas)
    port = _port(params, stats).train()
    with torch.no_grad():
        ours = port(torch.from_numpy(x)).numpy()
    assert ours.shape == (2, N, 10)
    np.testing.assert_allclose(ours, np.asarray(ref), **TOL)
    _assert_stats_match(port, params, new_stats, torch.float32, TOL)


def test_train_and_eval_match_jax_in_f64():
    params, stats = _init(np.float64)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, N, 28, 28, 1))
    x_eval = rng.normal(size=(3, 28, 28, 1))
    with jax.enable_x64(True):
        ref, new_stats = _jax_train(params, stats, x, dtype=jnp.float64)
        model = JaxLeNetDWT(group_size=4, dtype=jnp.float64)
        ref_eval = model.apply({"params": params, "batch_stats": stats},
                               x_eval, train=False)
        ref, ref_eval = np.asarray(ref), np.asarray(ref_eval)
        new_stats = jax.tree.map(np.asarray, new_stats)
    assert ref.dtype == ref_eval.dtype == np.float64
    port = _port(params, stats, torch.float64)
    with torch.no_grad():
        ours_eval = port.eval()(torch.from_numpy(x_eval)).numpy()
        ours = port.train()(torch.from_numpy(x)).numpy()
    assert ours.dtype == np.float64
    np.testing.assert_allclose(ours_eval, ref_eval, **F64_TOL)
    np.testing.assert_allclose(ours, ref, **F64_TOL)
    _assert_stats_match(port, params, new_stats, torch.float64, F64_TOL)


def test_train_input_must_carry_the_domain_axis():
    port = build_lenet(seed=0).train()
    with pytest.raises(ValueError, match="domains=2"):
        port(torch.zeros(8, 28, 28, 1))
    with pytest.raises(ValueError, match="domains=2"):
        port(torch.zeros(3, 2, 28, 28, 1))


def test_fresh_init_is_seeded_lecun_normal():
    """Flax's default kernels: lecun-normal (truncated, std sqrt(1/fan_in))
    and zero biases; the same seed gives the same weights."""
    a, b = build_lenet(seed=7), build_lenet(seed=7)
    c = build_lenet(seed=8)
    assert all(torch.equal(v, b.state_dict()[k]) for k, v in a.state_dict().items())
    assert not torch.equal(a.fc3.weight, c.fc3.weight)
    assert float(a.fc3.weight.detach().std()) == pytest.approx((1 / 2352) ** 0.5, rel=0.05)
    assert float(a.conv2.weight.detach().std()) == pytest.approx((1 / 800) ** 0.5, rel=0.05)
    assert not a.conv1.bias.any() and not a.fc5.bias.any()
    with pytest.raises(ValueError, match="divisible"):
        build_lenet(group_size=32)  # conv2's 48 channels
