"""Port parity at group sizes other than 4: both kernels' plain versions,
the train-mode seam, LeNet-DWT and the tiny ResNet-DWT against the live
JAX package, on the same numpy inputs.

The CUDA kernels take every group size ``g`` that divides C; on the card
``chip_smoke.py`` (phase ``group_kernels``) and ``tests/test_torch_cuda.py``
hold them to the plain versions tested here.  References on the JAX side:
the Pallas ``_moments_call``/``_apply_call`` and ``pallas_group_whiten``
in interpret mode, the XLA op ``group_whiten``, ``jax.grad`` of it, the
models' train step and the eval forward through
``make_whiten_cache_fn``.  The grid of ``(C, g)``: one group spanning the
site (32, 32), (48, 48), (64, 64), (256, 256); g not a multiple of 4
(48, 3); and (48, 16), (64, 8), (256, 16).

Tolerances, with their reasons:

* moments: mean ``rtol = atol = 1e-6``, cov ``rtol = 1e-4, atol = 1e-5``
  (the JAX package's own moments tolerance: f32 sums in other orders);
* the f32 apply ``rtol = atol = 1e-5``; the bf16 apply at most one bf16
  rounding step from ``_apply_call`` per element (both round ``xn`` and
  ``w`` to bf16 and sum exact products in f32, in other orders);
* train-mode outputs ``rtol = 2e-4, atol = 2e-5``, new stats mean
  ``1e-4/1e-5`` and cov ``1e-3/1e-4``, input gradients ``rtol = 2e-3,
  atol = 5e-5`` (as ``tests/test_torch_moments.py``: the gradient runs
  back through the Cholesky factor, LAPACK in torch, XLA's in JAX);
* models: eval logits ``rtol = atol = 1e-4``; after a tiny ResNet-DWT
  step every parameter and stat ``rtol = 1e-4, atol = 1e-5``, after a
  LeNet-DWT step every stat ``rtol = atol = 1e-4`` (the limits of
  ``tests/test_torch_train.py`` and ``tests/test_torch_digits.py``);
  metrics ``rtol = 1e-4``; each parameter's update within 2e-3 of JAX's
  relative to its norm (Adam's first step moves a parameter by about the
  learning rate whatever its gradient, so LeNet's parameters are held by
  their updates, and the biases that feed a normalization, whose
  gradient is rounding noise, not at all).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dwt_tpu.config import OfficeHomeConfig as JaxOfficeHomeConfig
from dwt_tpu.nn import LeNetDWT as JaxLeNetDWT
from dwt_tpu.nn import ResNetDWT as JaxResNetDWT
from dwt_tpu.ops import whitening as jw
from dwt_tpu.ops.pallas_whitening import _apply_call, _moments_call, pallas_group_whiten
from dwt_tpu.train import steps as jsteps
from dwt_tpu.train.evalpipe import make_whiten_cache_fn
from dwt_tpu.train.optim import officehome_tx as jax_officehome_tx
from dwt_tpu.train.state import TrainState as JaxTrainState
from dwt_tpu.train.steps import make_serve_forward
from dwt_tpu_torch.config import OfficeHomeConfig
from dwt_tpu_torch.convert import load_jax_variables
from dwt_tpu_torch.nn import LeNetDWT
from dwt_tpu_torch.nn.norms import install_eval_matrix
from dwt_tpu_torch.nn.resnet import ResNetDWT
from dwt_tpu_torch.ops import cuda_whitening as cw
from dwt_tpu_torch.ops import whitening as tw
from dwt_tpu_torch.train import loop, steps
from dwt_tpu_torch.train.evalpipe import install_whiten_cache, make_whiten_cache
from dwt_tpu_torch.train.optim import officehome_tx
from dwt_tpu_torch.train.state import TrainState

torch.set_num_threads(2)

# The Pallas calls in interpret mode, compiled once per shape.
_moments_pallas = jax.jit(_moments_call, static_argnums=(1, 2, 3))
_apply_pallas = jax.jit(_apply_call, static_argnums=(3,))

GRID = [(32, 32), (48, 3), (48, 16), (48, 48), (64, 8), (64, 64), (256, 16),
        (256, 256)]
ROWS = 600  # over one 512-row Pallas tile, ragged
MEAN_TOL = dict(rtol=1e-6, atol=1e-6)
COV_TOL = dict(rtol=1e-4, atol=1e-5)
APPLY_TOL = dict(rtol=1e-5, atol=1e-5)
# One bf16 rounding step: |a − b| ≤ 2⁻⁷·max(|a|, |b|) + 1e-6 (a bf16 value
# v has a spacing of at most 2⁻⁷·|v|; the 1e-6 covers f32 sums in other
# orders on outputs near 0).  Both sides sit within half a spacing of the
# exact sum of their bf16 products; over g terms a rounding boundary falls
# between them now and then.
BF16_STEP = (2.0 ** -7, 1e-6)
Y_TOL = dict(rtol=2e-4, atol=2e-5)
STAT_MEAN_TOL = dict(rtol=1e-4, atol=1e-5)
STAT_COV_TOL = dict(rtol=1e-3, atol=1e-4)
GRAD_TOL = dict(rtol=2e-3, atol=5e-5)
MODEL_TOL = dict(rtol=1e-4, atol=1e-5)
DIGITS_STATS_TOL = dict(rtol=1e-4, atol=1e-4)
METRIC_TOL = dict(rtol=1e-4)
UPDATE_TOL = 2e-3
N = 8  # images per domain in the model tests


def _domains(d, m, c, seed):
    """``[d, m, c]`` f32: channels correlated with their neighbour, each
    domain its own draw and mean."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(d, m, c))
    x = x + 0.5 * np.roll(x, 1, axis=2) + np.arange(d)[:, None, None] * 0.5 + 0.5
    return x.astype(np.float32)


def _spd(rng, groups, g):
    a = rng.normal(size=(groups, g, g))
    return (a @ np.swapaxes(a, -1, -2) / g + 0.5 * np.eye(g)).astype(np.float32)


def _bf16_pair(x):
    """The same bf16 values as a JAX and a torch array."""
    t = torch.from_numpy(x).to(torch.bfloat16)
    return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16), t


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("c,g", GRID)
def test_moments_plain_matches_moments_call(c, g, dtype):
    """``whiten_moments`` on a CPU ``[D, M, C]`` (the plain version) against
    ``_moments_call`` on each domain, D = 1 and 3, f32 and bf16 ``x``."""
    for d in (1, 3):
        x = _domains(d, ROWS, c, seed=c * g + d)
        if dtype == "bf16":
            jx, tx = _bf16_pair(x)
        else:
            jx, tx = jnp.asarray(x), torch.from_numpy(x)
        mean, cov = cw.whiten_moments(tx, g)
        assert mean.shape == (d, c) and cov.shape == (d, c // g, g, g)
        assert mean.dtype == cov.dtype == torch.float32
        for i in range(d):
            p_mean, p_cov = _moments_pallas(jx[i], c // g, g, True)
            np.testing.assert_allclose(mean[i].numpy(), np.asarray(p_mean), **MEAN_TOL)
            np.testing.assert_allclose(cov[i].numpy(), np.asarray(p_cov), **COV_TOL)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("c,g", GRID)
def test_apply_plain_matches_apply_call(c, g, dtype):
    """``whiten_apply`` on a CPU ``[D, M, C]`` with each domain's ``mean``
    and ``w [G, g, g]`` (the plain version) against ``_apply_call`` on
    each domain, D = 1 and 3: f32 to the tolerance, bf16 (the kernel's
    rounding points) within one bf16 step."""
    rng = np.random.default_rng(c + g)
    for d in (1, 3):
        x = _domains(d, ROWS, c, seed=c * g + d + 7)
        mean = rng.normal(0.5, 0.5, size=(d, c)).astype(np.float32)
        w = np.stack([np.asarray(jw.whitening_matrix(jw._shrink(
            jnp.asarray(_spd(rng, c // g, g)), 1e-3))) for _ in range(d)])
        if dtype == "bf16":
            jx, tx = _bf16_pair(x)
        else:
            jx, tx = jnp.asarray(x), torch.from_numpy(x)
        y = cw.whiten_apply(tx, torch.from_numpy(mean), torch.from_numpy(w))
        assert y.dtype == tx.dtype and y.shape == tx.shape
        for i in range(d):
            ref = np.asarray(_apply_pallas(jx[i], jnp.asarray(mean[i]), jnp.asarray(w[i]),
                                           True).astype(jnp.float32))
            ours = y[i].double().numpy()
            if dtype == "bf16":
                step = BF16_STEP[0] * np.maximum(np.abs(ours), np.abs(ref)) + BF16_STEP[1]
                assert (np.abs(ours - ref) <= step).all(), float(np.abs(ours - ref).max())
            else:
                np.testing.assert_allclose(ours, ref, **APPLY_TOL)


# (g, C, rows) of the train seam: one ROW_CHUNK's tail at C = 256, and at
# C = 64 two whole chunks of the batched products and a ragged tail.
SEAM = [pytest.param(16, 256, 1000, id="16"), pytest.param(64, 256, 1000, id="64"),
        pytest.param(16, 64, 9000, id="16-rows9000"),
        pytest.param(64, 64, 9000, id="64-rows9000")]


@pytest.mark.parametrize("g,c,rows", SEAM)
def test_train_whiten_matches_pallas_and_xla(g, c, rows):
    """``cuda_group_whiten(train=True)`` against ``pallas_group_whiten``
    (interpret mode) and ``group_whiten``: output and the EMA-updated
    stats, from SPD running stats."""
    assert rows < tw.ROW_CHUNK or rows > 2 * tw.ROW_CHUNK and rows % tw.ROW_CHUNK
    x = _domains(1, rows, c, seed=g)[0]
    rng = np.random.default_rng(g + 1)
    cov = _spd(rng, c // g, g)
    mean = rng.normal(0, 0.3, size=(c,)).astype(np.float32)
    jstats = jw.WhiteningStats(jnp.asarray(mean), jnp.asarray(cov))
    tstats = tw.WhiteningStats(torch.from_numpy(mean), torch.from_numpy(cov))
    ours, ours_stats = cw.cuda_group_whiten(
        torch.from_numpy(x), tstats, group_size=g, train=True, momentum=0.1)
    assert ours_stats.cov.shape == (c // g, g, g)
    for fn, kw in [(pallas_group_whiten, dict(interpret=True)), (jw.group_whiten, {})]:
        ref_y, ref_stats = jax.jit(lambda xx, st, fn=fn, kw=kw: fn(
            xx, st, group_size=g, train=True, momentum=0.1, **kw))(jnp.asarray(x), jstats)
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref_y), **Y_TOL)
        np.testing.assert_allclose(ours_stats.mean.numpy(), np.asarray(ref_stats.mean),
                                   **STAT_MEAN_TOL)
        np.testing.assert_allclose(ours_stats.cov.numpy(), np.asarray(ref_stats.cov),
                                   **STAT_COV_TOL)


@pytest.mark.parametrize("g,shapes", [
    pytest.param(16, [(64, 600), (256, 600)], id="16"),
    pytest.param(64, [(64, 600), (256, 600)], id="64"),
    pytest.param(16, [(64, 9000)], id="16-rows9000"),
    pytest.param(64, [(64, 9000)], id="64-rows9000")])
def test_train_whiten_input_gradients_match_jax(g, shapes):
    """The gradient through ``TrainWhiten`` (its backward recomputes the
    plain op, whose ``group_cov`` and apply take batched products over
    ``ROW_CHUNK`` rows above g = 4) against ``jax.grad`` of
    ``group_whiten``, at each ``(C, rows)``: below one chunk, and over
    two whole chunks with a ragged tail."""
    for c, rows in shapes:
        x = _domains(1, rows, c, seed=g + c)[0]
        r = np.random.default_rng(g + c + 1).normal(size=x.shape).astype(np.float32)
        jstats = jw.init_whitening_stats(c, g)

        def f(xx):
            y, _ = jw.group_whiten(xx, jstats, group_size=g, train=True)
            return jnp.sum(y * r)

        ref = np.asarray(jax.jit(jax.grad(f))(jnp.asarray(x)))
        xt = torch.from_numpy(x).requires_grad_(True)
        y, _ = cw.cuda_group_whiten(xt, tw.init_whitening_stats(c, g),
                                    group_size=g, train=True)
        (y * torch.from_numpy(r)).sum().backward()
        np.testing.assert_allclose(xt.grad.numpy(), ref, **GRAD_TOL)


def test_group_cov_batched_form_matches_jax():
    """``group_cov`` above g = 4 (chunked batched products, a ragged tail)
    against the JAX op's einsum, f32 and float64."""
    xn = _domains(1, 5000, 256, seed=3)[0]
    xn = xn - xn.mean(axis=0)
    for g in (8, 64, 256):
        ours = tw.group_cov(torch.from_numpy(xn), 256 // g, g)
        ref = jw.group_cov(jnp.asarray(xn), 256 // g, g)
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **COV_TOL)
    with jax.enable_x64(True):
        x64 = xn.astype(np.float64)
        ours = tw.group_cov(torch.from_numpy(x64), 4, 64)
        ref = jw.group_cov(jnp.asarray(x64), 4, 64)
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-12, atol=1e-12)


# ------------------------------------------------------------------ models


def _randomize(params, stats, rng):
    """Perturbed 1-d params; SPD covariances of each site's own g,
    positive variances, small means, nonzero counts."""
    params = jax.tree.map(lambda a: a + rng.normal(0, 0.1, a.shape).astype(a.dtype)
                          if a.ndim == 1 else a, params)

    def leaf(path, a):
        name = getattr(path[-1], "name", str(path[-1]))
        if name == "cov":
            g = a.shape[-1]
            m = rng.normal(size=a.shape)
            return (m @ np.swapaxes(m, -1, -2) / g + 0.5 * np.eye(g)).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 2.0, size=a.shape).astype(np.float32)
        if name == "mean":
            return rng.normal(0.0, 0.2, size=a.shape).astype(np.float32)
        return np.full(a.shape, 3, a.dtype)  # count

    return params, jax.tree_util.tree_map_with_path(leaf, stats)


def _init(model, sample):
    variables = jax.jit(lambda k: model.init(k, sample, train=True))(jax.random.key(0))
    return _randomize(jax.tree.map(np.asarray, variables["params"]),
                      jax.tree.map(np.asarray, variables["batch_stats"]),
                      np.random.default_rng(0))


def _tied(port, params, stats):
    load_jax_variables(port, jax.tree.map(np.asarray, params),
                       jax.tree.map(np.asarray, stats))
    return port.to(memory_format=torch.channels_last)


def _assert_eval_matches(jax_model, port, params, stats, images):
    """The deployment forward: the JAX cache against the port's (each
    site's ``[G, g, g]`` with ``g`` clamped to its width), and the logits
    of both through their caches."""
    cache = make_whiten_cache_fn("cholesky")(jax.tree.map(jnp.asarray, stats))
    ref = jax.jit(make_serve_forward(jax_model))(params, stats, cache, jnp.asarray(images))
    port.eval()
    port_cache = make_whiten_cache(port)
    for name, w in port_cache.items():
        jw_ = cache["whiten_cache"]
        for key in name.split("."):
            jw_ = jw_[key]
        assert tuple(w.shape) == jw_["w"].shape, name
    install_whiten_cache(port, port_cache)
    try:
        with torch.no_grad():
            ours = port(torch.from_numpy(images)).numpy()
    finally:
        install_whiten_cache(port, None)
    np.testing.assert_allclose(ours, np.asarray(ref), rtol=1e-4, atol=1e-4)
    return port_cache


@pytest.mark.parametrize("g", [16, 48])
def test_lenet_eval_matches_jax(g):
    """LeNet-DWT's eval forward through the whitening cache at g = 16 (dn1
    G = 2, dn2 G = 3) and g = 48 (dn1 clamped to one group of 32, dn2 one
    of 48: the eval matrices ``[1, 32, 32]`` and ``[1, 48, 48]`` that the
    shape check used to refuse)."""
    model = JaxLeNetDWT(group_size=g)
    params, stats = _init(model, jnp.zeros((2, 2, 28, 28, 1)))
    port = _tied(LeNetDWT(group_size=g), params, stats)
    images = np.random.default_rng(1).normal(size=(5, 28, 28, 1)).astype(np.float32)
    cache = _assert_eval_matches(model, port, params, stats, images)
    shapes = {name: tuple(w.shape) for name, w in cache.items()}
    want = min(32, g)
    assert shapes == {"dn1": (32 // want, want, want), "dn2": (48 // g, g, g)}


@pytest.mark.parametrize("g", [16, 128])
def test_tiny_resnet_eval_matches_jax(g):
    """The tiny ResNet-DWT's eval forward at g = 16 and at g = 128, where
    the C = 64 sites clamp to one group of 64 and the C = 256 sites have
    two groups of 128."""
    model = JaxResNetDWT(stage_sizes=(1, 1, 1, 1), num_classes=5, group_size=g)
    params, stats = _init(model, jnp.zeros((3, 1, 32, 32, 3)))
    port = _tied(ResNetDWT.tiny(num_classes=5, group_size=g), params, stats)
    images = np.random.default_rng(2).normal(size=(4, 32, 32, 3)).astype(np.float32)
    cache = _assert_eval_matches(model, port, params, stats, images)
    assert {tuple(w.shape) for w in cache.values()} == (
        {(4, 16, 16), (16, 16, 16)} if g == 16 else {(1, 64, 64), (2, 128, 128)})


def test_install_eval_matrix_takes_the_clamped_group():
    """A site resolves g as the op does: ``min(C, group_size)``."""
    site = LeNetDWT(group_size=64).dn1  # C = 32
    install_eval_matrix(site, torch.eye(32)[None])
    assert site.eval_matrix.shape == (1, 32, 32)
    with pytest.raises(ValueError, match="eval matrix"):
        install_eval_matrix(site, torch.eye(16).repeat(2, 1, 1))


def _updates(port, before, after):
    errs = {}
    for name, p in port.named_parameters():
        ref = (after[name] - before[name]).detach().double()
        ours = (p - before[name]).detach().double()
        errs[name] = float((ours - ref).norm() / ref.norm())
    return errs


def test_lenet_train_step_matches_jax():
    """One LeNet-DWT train step at g = 16 (Adam, entropy loss) from the
    same state: metrics, every running stat and the parameters (updates
    of the biases that feed a normalization are rounding noise and are
    held by value only)."""
    from dwt_tpu.train.optim import adam_l2, multistep_schedule, with_lr_backoff
    from dwt_tpu_torch.config import DigitsConfig
    from dwt_tpu_torch.train.optim import digits_tx

    g, spe = 16, 8
    cfg = DigitsConfig(group_size=g)
    model = JaxLeNetDWT(group_size=g)
    params, stats = _init(model, jnp.zeros((2, N, 28, 28, 1)))
    tx = with_lr_backoff(adam_l2(multistep_schedule(
        cfg.lr, cfg.lr_milestones, cfg.lr_gamma, scale=spe), cfg.weight_decay))
    jparams = jax.tree.map(jnp.asarray, params)
    state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=jparams,
                          batch_stats=jax.tree.map(jnp.asarray, stats),
                          opt_state=tx.init(jparams))
    rng = np.random.default_rng(4)
    batch = {"source_x": rng.normal(size=(N, 28, 28, 1)).astype(np.float32),
             "source_y": rng.integers(0, 10, size=N),
             "target_x": rng.normal(size=(N, 28, 28, 1)).astype(np.float32)}
    new_state, ref = jax.jit(jsteps.make_digits_train_step(model, tx, 0.1))(
        state, jax.tree.map(jnp.asarray, batch))
    port = _tied(LeNetDWT(group_size=g), params, stats)
    optimizer, schedules = digits_tx(port, cfg, spe)
    tstate = TrainState(port, optimizer, schedules)
    metrics = steps.make_digits_train_step(port, 0.1)(
        tstate, {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()})
    for key in ("loss", "cls_loss", "entropy_loss", "grad_norm"):
        np.testing.assert_allclose(float(metrics[key]), float(ref[key]), err_msg=key,
                                   **METRIC_TOL)
    after = _tied(LeNetDWT(group_size=g), new_state.params, new_state.batch_stats)
    params_after = dict(after.named_parameters())
    for name, value in port.state_dict().items():
        if name not in params_after:  # running stats; parameters by update below
            np.testing.assert_allclose(value.detach().numpy(),
                                       after.state_dict()[name].numpy(), err_msg=name,
                                       **DIGITS_STATS_TOL)
    before = dict(_tied(LeNetDWT(group_size=g), params, stats).named_parameters())
    errs = _updates(port, before, params_after)
    normalized = {"conv1.bias", "conv2.bias", "fc3.bias", "fc4.bias", "fc5.bias"}
    worst = max((k for k in errs if k not in normalized), key=errs.get)
    assert errs[worst] <= UPDATE_TOL, (worst, errs[worst])


@pytest.mark.slow
def test_tiny_resnet_train_step_matches_jax():
    """One tiny ResNet-DWT MEC train step at g = 16 (two-group SGD) from the
    same state: metrics, every parameter and running stat, and each
    parameter's update."""
    g, size, classes = 16, 32, 5
    model = JaxResNetDWT(stage_sizes=(1, 1, 1, 1), num_classes=classes, group_size=g)
    params, stats = _init(model, jnp.zeros((3, N, size, size, 3)))
    tx = jax_officehome_tx(JaxOfficeHomeConfig(group_size=g))
    jparams = jax.tree.map(jnp.asarray, params)
    state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=jparams,
                          batch_stats=jax.tree.map(jnp.asarray, stats),
                          opt_state=tx.init(jparams))
    rng = np.random.default_rng(5)
    img = lambda: rng.normal(size=(N, size, size, 3)).astype(np.float32)
    batch = {"source_x": img(), "source_y": rng.integers(0, classes, size=N),
             "target_x": img(), "target_aug_x": img()}
    new_state, ref = jax.jit(jsteps.make_officehome_train_step(model, tx, 0.1))(
        state, jax.tree.map(jnp.asarray, batch))
    port = _tied(ResNetDWT.tiny(num_classes=classes, group_size=g), params, stats)
    optimizer, schedules = officehome_tx(port, OfficeHomeConfig(group_size=g))
    tstate = TrainState(port, optimizer, schedules)
    metrics = steps.make_officehome_train_step(port, 0.1)(
        tstate, {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()})
    for key in ("loss", "cls_loss", "mec_loss", "grad_norm"):
        np.testing.assert_allclose(float(metrics[key]), float(ref[key]), err_msg=key,
                                   **METRIC_TOL)
    tie = lambda p, s: _tied(ResNetDWT.tiny(num_classes=classes, group_size=g), p, s)
    after = tie(new_state.params, new_state.batch_stats)
    for name, value in port.state_dict().items():
        np.testing.assert_allclose(value.detach().numpy(),
                                   after.state_dict()[name].numpy(), err_msg=name,
                                   **MODEL_TOL)
    errs = _updates(port, dict(tie(params, stats).named_parameters()),
                    dict(after.named_parameters()))
    worst = max(errs, key=errs.get)
    assert errs[worst] <= UPDATE_TOL, (worst, errs[worst])


# -------------------------------------------------------------------- loop


def test_zero_collection_passes_record_the_skipped_phase_for_every_whitener():
    """At ``--stat_collection_passes 0`` the OfficeHome loop writes one
    ``stat_collection`` record with ``skipped=True`` whatever the whitener,
    as the JAX loop does (``dwt_tpu/train/loop.py``), then the final
    test."""
    for name in ("cholesky", "newton_schulz"):
        cfg = OfficeHomeConfig(synthetic=True, arch="tiny", num_classes=4,
                               img_crop_size=16, source_batch_size=2, synthetic_size=4,
                               num_iters=1, check_acc_step=100, stat_collection_passes=0,
                               num_workers=0, whitener=name, group_size=16, device="cpu")
        out = []
        loop.run_officehome(cfg, lambda k, s, **f: out.append((k, s, f)))
        kinds = [k for k, _, _ in out]
        assert ("stat_collection", 1, {"skipped": True, "whitener": name}) in out
        assert kinds[-2:] == ["stat_collection", "final_test"], kinds
