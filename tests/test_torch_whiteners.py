"""Port parity: the Newton–Schulz and SWBN whiteners of ``dwt_tpu_torch`` against the live JAX package.

The same seeded numpy inputs go through ``dwt_tpu.ops.whitening`` and its
port: each backend's ``precision_policy``, ``newton_schulz_inverse_sqrt``,
train- and eval-mode ``group_whiten`` (outputs and every updated stat),
SWBN's tracker over 3 steps, the site-stacked eval cache against per-site
matrices, ``get_whitener``'s errors and the environment names both
packages read (``DWT_NS_ITERS``, ``DWT_SWBN_ALPHA``).  Then SWBN's extra
stat leaf through the port's full and delta checkpoints, a JAX SWBN
host-shard checkpoint served by the port, and the refusal of stats of
another whitener.

Tolerances: f32 ``rtol = atol = 1e-5`` (the port's iterations are batched
matmuls, the JAX package's CPU path unrolls them elementwise: the same
sums in other orders); float64 under ``jax.enable_x64(True)`` ``1e-12``;
bf16 (Newton–Schulz's native iterate) ``2e-2``, JAX's own bf16 tolerance
(``tests/test_pallas_whitening.py:65``).
"""

from __future__ import annotations

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dwt_tpu.nn import LeNetDWT as JaxLeNetDWT
from dwt_tpu.serve.engine import ServeEngine as JaxServeEngine
from dwt_tpu.train import create_train_state
from dwt_tpu.train import optim as jax_optim
from dwt_tpu.ops import whitening as jw
from dwt_tpu.utils import checkpoint as jax_ckpt
from dwt_tpu_torch.ckpt import store
from dwt_tpu_torch.config import DigitsConfig
from dwt_tpu_torch.nn.lenet import LeNetDWT, build_lenet
from dwt_tpu_torch.ops import whitening as tw
from dwt_tpu_torch.serve.engine import ServeEngine
from dwt_tpu_torch.train.optim import digits_tx
from dwt_tpu_torch.train.state import TrainState
from dwt_tpu_torch.train.steps import make_digits_train_step
from dwt_tpu_torch.utils import checkpoint as ckpt

BACKENDS = ("cholesky", "newton_schulz", "swbn")
TOL = {"f32": dict(rtol=1e-5, atol=1e-5), "f64": dict(rtol=1e-12, atol=1e-12),
       "bf16": dict(rtol=2e-2, atol=2e-2)}
JAX_DTYPES = {"f32": jnp.float32, "f64": jnp.float64, "bf16": jnp.bfloat16}
TORCH_DTYPES = {"f32": torch.float32, "f64": torch.float64, "bf16": torch.bfloat16}
NUMPY_DTYPES = {"f32": np.float32, "f64": np.float64, "bf16": np.float32}
M, C = 300, 16


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _spd(rng, n, g=4):
    a = rng.normal(size=(n, g, g))
    return a @ np.swapaxes(a, -1, -2) / g + 0.5 * np.eye(g)


def _x64(dtype):
    return jax.enable_x64(dtype == "f64")


def _jnp(a, dtype):
    return jnp.asarray(np.asarray(a, NUMPY_DTYPES[dtype]), JAX_DTYPES[dtype])


def _torch(a, dtype):
    return torch.from_numpy(np.asarray(a, NUMPY_DTYPES[dtype])).to(TORCH_DTYPES[dtype])


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().to(torch.float64).numpy()
    return np.asarray(t).astype(np.float64)


def _stats_type(name, lib):
    return lib.SWBNStats if name == "swbn" else lib.WhiteningStats


def _stats(name, rng, c=C):
    """Plausible running stats of one site for backend ``name`` (SWBN's
    tracked matrix near the identity), as float64 numpy arrays."""
    mean = rng.normal(0, 0.3, size=(c,))
    cov = _spd(rng, c // 4)
    if name != "swbn":
        return (mean, cov)
    return (mean, cov, np.eye(4) + 0.05 * rng.normal(size=(c // 4, 4, 4)))


@pytest.mark.parametrize("name", BACKENDS)
def test_precision_policy_matches_jax(name):
    """Cholesky and SWBN promote bf16 to f32; Newton–Schulz keeps bf16;
    every policy keeps f32 and float64."""
    for dtype in ("f32", "bf16", "f64"):
        ours = tw.get_whitener(name).precision_policy(TORCH_DTYPES[dtype])
        ref = jw.get_whitener(name).precision_policy(JAX_DTYPES[dtype])
        assert str(ours).split(".")[1] == jnp.dtype(ref).name, (name, dtype)


@pytest.mark.parametrize("dtype", ["f32", "f64", "bf16"])
def test_newton_schulz_matches_jax(dtype):
    a = tw._shrink(torch.from_numpy(_spd(np.random.default_rng(0), 24)), 1e-3).numpy()
    with _x64(dtype):
        ref = _np(jw.newton_schulz_inverse_sqrt(_jnp(a, dtype), 5))
    ours = tw.newton_schulz_inverse_sqrt(_torch(a, dtype), 5)
    assert ours.dtype == TORCH_DTYPES[dtype]
    np.testing.assert_allclose(_np(ours), ref, **TOL[dtype])
    if dtype == "f64":  # and it converges to Σ^{-1/2}: w Σ w = I
        w = _np(tw.newton_schulz_inverse_sqrt(_torch(a, dtype), 30))
        np.testing.assert_allclose(w @ a @ w, np.broadcast_to(np.eye(4), a.shape),
                                   atol=1e-9)


@pytest.mark.parametrize("dtype", ["f32", "f64"])
@pytest.mark.parametrize("name", ["newton_schulz", "swbn"])
def test_group_whiten_train_and_eval_match_jax(name, dtype):
    """One train-mode call (output and every updated stat) and one
    eval-mode call (output) per backend; gradients of the train output
    through the port's autograd and ``jax.grad``."""
    rng = np.random.default_rng(1)
    x = rng.normal(0.5, 2.0, size=(M, C))
    r = rng.normal(size=(M, C))
    stats = _stats(name, rng)
    with _x64(dtype):
        jstats = _stats_type(name, jw)(*(_jnp(a, dtype) for a in stats))
        y_ref, new_ref = jw.group_whiten(_jnp(x, dtype), jstats, group_size=4,
                                         train=True, momentum=0.3, whitener=name)
        g_ref = jax.grad(lambda v: jnp.sum(jw.group_whiten(
            v, jstats, group_size=4, train=True, whitener=name)[0] * _jnp(r, dtype)))(
            _jnp(x, dtype))
        e_ref, _ = jw.group_whiten(_jnp(x, dtype), jstats, group_size=4,
                                   train=False, whitener=name)
        y_ref, g_ref, e_ref = _np(y_ref), _np(g_ref), _np(e_ref)
        new_ref = [_np(a) for a in new_ref]
    tstats = _stats_type(name, tw)(*(_torch(a, dtype) for a in stats))
    xt = _torch(x, dtype).requires_grad_(True)
    y, new = tw.group_whiten(xt, tstats, group_size=4, train=True, momentum=0.3,
                             whitener=name)
    (y * _torch(r, dtype)).sum().backward()
    e, _ = tw.group_whiten(_torch(x, dtype), tstats, group_size=4, train=False,
                           whitener=name)
    assert type(new) is type(tstats)
    np.testing.assert_allclose(_np(y), y_ref, **TOL[dtype])
    np.testing.assert_allclose(_np(xt.grad), g_ref, **TOL[dtype])
    np.testing.assert_allclose(_np(e), e_ref, **TOL[dtype])
    for field, ours, ref in zip(new._fields, new, new_ref):
        np.testing.assert_allclose(_np(ours), ref, err_msg=field, **TOL[dtype])


def test_swbn_tracker_over_three_steps_matches_jax():
    """Three chained train steps of one SWBN site from the identity init:
    each output and the final state (the tracked matrix detached: no
    factorization, forward or backward)."""
    rng = np.random.default_rng(2)
    xs = [rng.normal(0.2 * i, 1.0 + i, size=(M, C)).astype(np.float32) for i in range(3)]
    jstats = jw.get_whitener("swbn").init_stats(C, 4)
    tstats = tw.get_whitener("swbn").init_stats(C, 4)
    assert torch.equal(tstats.w, torch.eye(4).repeat(C // 4, 1, 1))
    for x in xs:
        y_ref, jstats = jw.group_whiten(jnp.asarray(x), jstats, group_size=4,
                                        train=True, whitener="swbn")
        y, tstats = tw.group_whiten(torch.from_numpy(x), tstats, group_size=4,
                                    train=True, whitener="swbn")
        np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), **TOL["f32"])
    for field in ("mean", "cov", "w"):
        np.testing.assert_allclose(getattr(tstats, field).numpy(),
                                   np.asarray(getattr(jstats, field)),
                                   err_msg=field, **TOL["f32"])
    # The tracked matrix moved toward whitening the last batch's covariance.
    assert not torch.allclose(tstats.w, torch.eye(4).expand_as(tstats.w))


def _stats_tree(name, rng, lib):
    """Two nested sites (C = 16 and 32) with domain-stacked stats of
    backend ``name``, and a BN site the cache builder must skip."""
    def site(c):
        branches = [_stats(name, rng, c=c) for _ in range(3)]
        return _stats_type(name, lib)(*(np.stack(f).astype(np.float32)
                                        for f in zip(*branches)))

    return {"dn1": {"whitening": site(16)},
            "layer1_0": {"dn3": {"whitening": site(32)},
                         "dn9": {"bn": {"mean": np.zeros(4, np.float32)}}}}


@pytest.mark.parametrize("name", BACKENDS)
def test_stacked_cache_matches_per_site_and_jax(name):
    """One stacked factorization per ``g`` (swbn: the tracked matrices)
    against each site's own eval matrix and against JAX's cache."""
    ref = jw.build_whiten_cache(
        jax.tree.map(jnp.asarray, _stats_tree(name, np.random.default_rng(3), jw)),
        name, eval_domain=1)[jw.WHITEN_CACHE_COL]
    tree = jax.tree.map(torch.from_numpy,
                        _stats_tree(name, np.random.default_rng(3), tw),
                        is_leaf=lambda v: isinstance(v, np.ndarray))
    ours = tw.build_whiten_cache(tree, name, eval_domain=1)[tw.WHITEN_CACHE_COL]
    wh = tw.get_whitener(name)
    for path in (("dn1",), ("layer1_0", "dn3")):
        node, ref_node, stats = ours, ref, tree
        for key in path:
            node, ref_node, stats = node[key], ref_node[key], stats[key]
        branch = type(stats["whitening"])(*(a[1] for a in stats["whitening"]))
        own = wh.eval_matrix(branch, 1e-3)
        np.testing.assert_allclose(node["w"].numpy(), own.numpy(), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(node["w"].numpy(), np.asarray(ref_node["w"]),
                                   **TOL["f32"])
    assert "dn9" not in ours["layer1_0"]


def test_get_whitener_resolves_and_refuses_as_jax():
    assert tw.WHITENER_NAMES == jw.WHITENER_NAMES
    for name in tw.WHITENER_NAMES:
        assert tw.get_whitener(name).name == jw.get_whitener(name).name == name
        assert (tw.get_whitener(name).needs_stat_collection
                == jw.get_whitener(name).needs_stat_collection)
    assert tw.get_whitener(None) is tw.get_whitener("cholesky")
    custom = tw.NewtonSchulzWhitener(num_iters=2)
    assert tw.get_whitener(custom) is custom
    for lib in (tw, jw):
        with pytest.raises(ValueError, match="unknown whitener 'zca'; choose from"):
            lib.get_whitener("zca")


def test_environment_sets_both_packages_numerics(monkeypatch):
    """``DWT_NS_ITERS`` and ``DWT_SWBN_ALPHA``, read at each use in both
    packages: one environment, one numerics."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(M, C)).astype(np.float32)
    monkeypatch.setenv("DWT_NS_ITERS", "2")
    monkeypatch.setenv("DWT_SWBN_ALPHA", "0.05")
    assert tw.ns_default_iters() == jw.ns_default_iters() == 2
    for name in ("newton_schulz", "swbn"):
        y_ref, new_ref = jw.group_whiten(jnp.asarray(x), jw.get_whitener(name).init_stats(C, 4),
                                         group_size=4, train=True, whitener=name)
        y, new = tw.group_whiten(torch.from_numpy(x), tw.get_whitener(name).init_stats(C, 4),
                                 group_size=4, train=True, whitener=name)
        np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), **TOL["f32"])
        np.testing.assert_allclose(new[-1].numpy(), np.asarray(new_ref[-1]), **TOL["f32"])
    fresh = tw.init_whitening_stats(C, 4)
    y_env, _ = tw.group_whiten(torch.from_numpy(x), fresh, group_size=4, train=True,
                               whitener="newton_schulz")
    y_two, _ = tw.group_whiten(torch.from_numpy(x), fresh, group_size=4, train=True,
                               whitener=tw.NewtonSchulzWhitener(num_iters=2))
    assert torch.equal(y_env, y_two)
    monkeypatch.setenv("DWT_NS_ITERS", "five")
    for lib in (tw, jw):
        with pytest.raises(ValueError, match="DWT_NS_ITERS='five'"):
            lib.ns_default_iters()


# ------------------------------------------------------------ checkpoints


def _swbn_state(seed=0):
    """A LeNet-DWT of the swbn backend on the CPU after one train step (its
    tracked matrices moved off the identity), with the digits optimizer."""
    model = build_lenet(group_size=4, seed=seed, whitener="swbn")
    model.to(memory_format=torch.channels_last)
    optimizer, schedules = digits_tx(model, DigitsConfig(), 8)
    state = TrainState(model, optimizer, schedules)
    g = torch.Generator().manual_seed(seed)
    img = lambda: torch.randn(4, 28, 28, 1, generator=g)
    make_digits_train_step(model)(state, {"source_x": img(), "target_x": img(),
                                          "source_y": torch.tensor([0, 1, 2, 3])})
    return state


def test_swbn_checkpoints_round_trip_full_and_delta(tmp_path):
    """SWBN's tracked ``w`` leaf through the full and the delta format,
    bitwise; a model of another whitener refuses the checkpoint with a
    one-line reason, and an SWBN model refuses a Cholesky one."""
    state = _swbn_state()
    w = state.model.dn1.w.clone()
    assert w.shape == (2, 8, 4, 4) and not torch.equal(w, torch.eye(4).expand_as(w))
    ckpt.save_state(str(tmp_path / "full"), state.step, state)
    store.save_delta(str(tmp_path / "delta"), state.step, state)
    make_digits_train_step(state.model)(state, {
        "source_x": torch.ones(4, 28, 28, 1), "target_x": torch.zeros(4, 28, 28, 1),
        "source_y": torch.tensor([1, 1, 2, 2])})
    store.save_delta(str(tmp_path / "delta"), state.step, state)
    manifest = json.load(open(tmp_path / "delta" / "2" / "manifest.json"))
    assert manifest["mode"] == "delta"
    assert "['model']['dn1.w']" in json.dumps(manifest["leaves"])
    for root, step, want in (("full", 1, w), ("delta", 2, state.model.dn1.w)):
        fresh = _swbn_state(seed=3)
        assert ckpt.restore_state(str(tmp_path / root), fresh).step == step
        assert torch.equal(fresh.model.dn1.w, want)
        sa, sb = fresh.model.state_dict(), state.model.state_dict()
        if root == "delta":
            assert all(torch.equal(sa[k], sb[k]) for k in sa)
    cholesky = build_lenet(group_size=4, seed=0)
    optimizer, schedules = digits_tx(cholesky, DigitsConfig(), 8)
    with pytest.raises(FileNotFoundError,
                       match="whitening stats of the swbn whitener, not those "
                             "of this run's --whitener cholesky"):
        ckpt.restore_state(str(tmp_path / "full"), TrainState(cholesky, optimizer, schedules))
    ckpt.save_state(str(tmp_path / "chol"), 0, TrainState(cholesky, optimizer, schedules))
    with pytest.raises(FileNotFoundError, match="a factorizing whitener, not those "
                                                "of this run's --whitener swbn"):
        ckpt.restore_state(str(tmp_path / "chol"), _swbn_state())


def test_a_jax_swbn_checkpoint_serves_in_the_port(tmp_path):
    """A JAX LeNet-DWT of the swbn backend saved in the host-shard format:
    the port's server restores its tracked matrices and answers as the JAX
    engine does; a Cholesky model of the port refuses it, naming why."""
    rng = np.random.default_rng(5)
    model = JaxLeNetDWT(group_size=4, whitener="swbn")
    state = create_train_state(model, jax.random.key(0),
                               jnp.zeros((2, 1, 28, 28, 1)),
                               jax_optim.adam_l2(1e-3, 5e-4))

    def stat(path, a):
        name = path[-1].name if hasattr(path[-1], "name") else str(path[-1])
        a = np.asarray(a)
        if name == "cov":
            return _spd(rng, int(np.prod(a.shape[:-2]))).reshape(a.shape).astype(np.float32)
        if name == "w":
            return (a + 0.05 * rng.normal(size=a.shape)).astype(np.float32)
        if name in ("mean", "var"):
            return (rng.uniform(0.5, 1.5, size=a.shape) if name == "var"
                    else rng.normal(0, 0.2, size=a.shape)).astype(np.float32)
        return a

    state = state.replace(step=jnp.asarray(4), batch_stats=jax.tree_util.tree_map_with_path(
        stat, state.batch_stats))
    root = str(tmp_path / "host_shards")
    assert jax_ckpt.save_host_shard(root, 4, jax_ckpt.host_fetch(state), 0, data_state=None)
    jax_ckpt.promote_host_shards(root, 4, 1)
    images = rng.normal(size=(3, 28, 28, 1)).astype(np.float32)
    ref = JaxServeEngine.from_checkpoint(root, model, (28, 28, 1), buckets=(4,)).infer(images)
    port = LeNetDWT(group_size=4, whitener="swbn")
    engine = ServeEngine.from_checkpoint(root, port, (28, 28, 1), buckets=(4,), device="cpu")
    assert engine.step == 4
    np.testing.assert_array_equal(port.dn2.w.numpy(),
                                  np.asarray(state.batch_stats["dn2"]["whitening"].w))
    np.testing.assert_allclose(engine.infer(images), ref, rtol=1e-4, atol=1e-4)
    with pytest.raises(FileNotFoundError, match="dn1 holds the whitening stats of the "
                                                "swbn whitener, not those of the model's "
                                                "whitener 'cholesky'"):
        ServeEngine.from_checkpoint(root, LeNetDWT(group_size=4), (28, 28, 1),
                                    buckets=(1,), device="cpu")
