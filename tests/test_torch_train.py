"""Port parity: the OfficeHome train step, stat collection and eval counters
of ``dwt_tpu_torch`` against the live JAX package, on the tiny ResNet-DWT.

The model is ``ResNetDWT(stage_sizes=(1,1,1,1), num_classes=5)`` at 32×32,
8 images per stream.  At 32×32 stage 4 is 1×1, so each domain's stage-4
BN sites normalize over as many samples as there are images, and fewer
images make the step ill-conditioned: at 2 the gradient norm is ~1e4 and
f32 rounding differences grow to percent level in the stem's gradient;
at 4 even the JAX package's own XLA and Pallas paths differ by 2e-4 in
the gradient norm; at 8 everything agrees to ~1e-6.  Weights come from the
JAX ``model.init`` with perturbed affines and randomized running stats,
tied into the port through the bridge; the port's post-step state is
compared with JAX's post-step variables loaded into a second port model
through the same bridge.  Every step starts from JAX's state (re-tied),
never from the port's own previous step: free-running lockstep diverges
through the Cholesky chain.

Tolerances: losses and grad norm ``rtol=1e-4``; every parameter and
running stat ``rtol=1e-4, atol=1e-5`` (sums in other orders through
convolutions, the Cholesky factors and their gradients).  A step moves
the backbone by ~1e-3 of its gradient, under that parameter tolerance,
so each parameter's update ``Δ = post − pre`` is also held to JAX's:
``‖Δ − Δ_jax‖ / ‖Δ_jax‖ ≤ 2e-3`` per parameter (the worst leaf, a norm
``gamma``, measures ≤ 4e-4 across these three steps; a missing or
reversed update scores ≥ 1).  Eval counters: ``loss_sum`` ``rtol=1e-4``,
``correct`` and ``count`` exact.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dwt_tpu.config import OfficeHomeConfig as JaxOfficeHomeConfig
from dwt_tpu.nn import ResNetDWT as JaxResNetDWT
from dwt_tpu.train import steps as jsteps
from dwt_tpu.train.evalpipe import make_whiten_cache_fn
from dwt_tpu.train.loop import _synthetic_classification_arrays as jax_arrays
from dwt_tpu.train.optim import officehome_tx as jax_officehome_tx
from dwt_tpu.train.state import TrainState as JaxTrainState
from dwt_tpu_torch.cli import officehome as cli
from dwt_tpu_torch.config import OfficeHomeConfig
from dwt_tpu_torch.convert import load_jax_variables
from dwt_tpu_torch.nn.resnet import ResNetDWT
from dwt_tpu_torch.train import loop, steps
from dwt_tpu_torch.train.evalpipe import install_whiten_cache, make_whiten_cache
from dwt_tpu_torch.train.optim import officehome_tx
from dwt_tpu_torch.train.state import TrainState

N, SIZE, CLASSES = 8, 32, 5
METRIC_TOL = dict(rtol=1e-4)
STATE_TOL = dict(rtol=1e-4, atol=1e-5)
UPDATE_TOL = 2e-3


def _randomize(params, stats, rng):
    """Perturbed affines and head bias; SPD covariances, positive
    variances, small means and nonzero counts."""
    params = jax.tree.map(
        lambda a: a + rng.normal(0, 0.1, a.shape).astype(a.dtype)
        if a.ndim == 1 else a, params)

    def leaf(path, a):
        name = getattr(path[-1], "name", str(path[-1]))
        if name == "cov":
            m = rng.normal(size=a.shape)
            return (m @ np.swapaxes(m, -1, -2) / 4 + 0.5 * np.eye(4)).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 2.0, size=a.shape).astype(np.float32)
        if name == "mean":
            return rng.normal(0.0, 0.2, size=a.shape).astype(np.float32)
        return np.full(a.shape, 3, a.dtype)  # count

    return params, jax.tree_util.tree_map_with_path(leaf, stats)


@pytest.fixture(scope="module")
def jax_setup():
    """``(jax model, JAX TrainState, jitted JAX train step by use_pallas)``."""
    model = JaxResNetDWT(stage_sizes=(1, 1, 1, 1), num_classes=CLASSES)
    tx = jax_officehome_tx(JaxOfficeHomeConfig())
    variables = jax.jit(lambda k: model.init(
        k, jnp.zeros((3, N, SIZE, SIZE, 3)), train=True))(jax.random.key(0))
    params, stats = _randomize(jax.tree.map(np.asarray, variables["params"]),
                               jax.tree.map(np.asarray, variables["batch_stats"]),
                               np.random.default_rng(0))
    params = jax.tree.map(jnp.asarray, params)
    state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                          batch_stats=jax.tree.map(jnp.asarray, stats),
                          opt_state=tx.init(params))
    train_steps = {
        p: jax.jit(jsteps.make_officehome_train_step(
            model.clone(use_pallas=p), tx, 0.1))
        for p in (False, True)
    }
    return model, state, train_steps


def _batch(seed):
    rng = np.random.default_rng(seed)
    img = lambda: rng.normal(size=(N, SIZE, SIZE, 3)).astype(np.float32)
    return {"source_x": img(), "source_y": rng.integers(0, CLASSES, size=N),
            "target_x": img(), "target_aug_x": img()}


def _port(jax_state) -> ResNetDWT:
    port = ResNetDWT.tiny(num_classes=CLASSES)
    load_jax_variables(port, jax.tree.map(np.asarray, jax_state.params),
                       jax.tree.map(np.asarray, jax_state.batch_stats))
    return port.to(memory_format=torch.channels_last)


def _port_state(jax_state) -> TrainState:
    """The port's train state tied to JAX's: weights, stats, the step
    count and the SGD momentum (optax's trace)."""
    port = _port(jax_state)
    optimizer, schedules = officehome_tx(port, OfficeHomeConfig())
    traces = [s.trace for s in jax.tree.leaves(
        jax_state.opt_state, is_leaf=lambda s: isinstance(s, optax.TraceState))
        if isinstance(s, optax.TraceState)]
    if any(jax.tree.leaves(t) for t in traces):
        masked = lambda s: isinstance(s, optax.MaskedNode)
        trace = jax.tree.map(lambda a, b: b if masked(a) else a, *traces,
                             is_leaf=masked)
        holder = ResNetDWT.tiny(num_classes=CLASSES)
        load_jax_variables(holder, jax.tree.map(np.asarray, trace),
                           jax.tree.map(np.asarray, jax_state.batch_stats))
        buffers = dict(holder.named_parameters())
        for name, p in port.named_parameters():
            optimizer.state[p]["momentum_buffer"] = buffers[name].detach().clone()
    return TrainState(port, optimizer, schedules, step=int(jax_state.step))


def _assert_state_matches(port, jax_state):
    ref = _port(jax_state).state_dict()
    for name, value in port.state_dict().items():
        np.testing.assert_allclose(value.detach().numpy(), ref[name].numpy(),
                                   err_msg=name, **STATE_TOL)


def update_errors(port, jax_state, new_jax_state):
    """Per parameter: ``‖Δ − Δ_jax‖ / ‖Δ_jax‖``, the port's update (its
    post-step value minus the shared pre-step value) against JAX's."""
    before = dict(_port(jax_state).named_parameters())
    after = dict(_port(new_jax_state).named_parameters())
    errs = {}
    for name, p in port.named_parameters():
        ref = (after[name] - before[name]).detach().double()
        ours = (p - before[name]).detach().double()
        errs[name] = float((ours - ref).norm() / ref.norm())
    return errs


def _assert_step_matches(jax_step, jax_state, batch):
    new_jax_state, ref = jax_step(jax_state, jax.tree.map(jnp.asarray, batch))
    state = _port_state(jax_state)
    metrics = steps.make_officehome_train_step(state.model, 0.1)(
        state, {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()})
    for key in ("loss", "cls_loss", "mec_loss", "grad_norm"):
        np.testing.assert_allclose(float(metrics[key]), float(ref[key]),
                                   err_msg=key, **METRIC_TOL)
    assert bool(metrics["finite"])
    assert state.step == int(new_jax_state.step)
    _assert_state_matches(state.model, new_jax_state)
    errs = update_errors(state.model, jax_state, new_jax_state)
    worst = max(errs, key=errs.get)
    assert errs[worst] <= UPDATE_TOL, (worst, errs[worst])
    return new_jax_state


@pytest.mark.parametrize("use_pallas", [False, True])
def test_train_step_matches_jax(jax_setup, use_pallas):
    _, state, train_steps = jax_setup
    _assert_step_matches(train_steps[use_pallas], state, _batch(1))


def test_second_step_from_retied_jax_state(jax_setup):
    """Step 2 from JAX's post-step-1 state: momentum buffers are live."""
    _, state, train_steps = jax_setup
    state1, _ = train_steps[False](state, jax.tree.map(jnp.asarray, _batch(1)))
    _assert_step_matches(train_steps[False], state1, _batch(2))


def test_stat_collection_step_matches_jax(jax_setup):
    model, state, _ = jax_setup
    x = np.random.default_rng(3).normal(size=(N + 1, SIZE, SIZE, 3)).astype(np.float32)
    new_state = jax.jit(jsteps.make_stat_collection_step(model, 3))(
        state, jnp.asarray(x))
    port = _port(state)
    params = {k: v.clone() for k, v in port.named_parameters()}
    steps.make_stat_collection_step(port, 3)(TrainState(port, None, ()),
                                             torch.from_numpy(x))
    _assert_state_matches(port, new_state)
    assert all(torch.equal(v, params[k]) for k, v in port.named_parameters())


def test_accum_eval_counters_match_jax_on_a_masked_batch(jax_setup):
    model, state, _ = jax_setup
    rng = np.random.default_rng(4)
    x = rng.normal(size=(6, SIZE, SIZE, 3)).astype(np.float32)
    y = rng.integers(0, CLASSES, size=6)
    mask = np.array([True] * 4 + [False] * 2)  # a padded ragged tail
    cache = make_whiten_cache_fn("cholesky")(state.batch_stats)
    ref = jax.jit(jsteps.make_accum_eval_step(model))(
        jsteps.eval_counters(), state.params, state.batch_stats, cache,
        {"x": x[None], "y": y[None], "mask": mask[None]})
    port = _port(state)
    install_whiten_cache(port, make_whiten_cache(port))
    ours = steps.make_accum_eval_step(port)(
        steps.eval_counters(torch.device("cpu")),
        {"x": torch.from_numpy(x[None]), "y": torch.from_numpy(y[None]),
         "mask": torch.from_numpy(mask[None])})
    np.testing.assert_allclose(float(ours["loss_sum"]), float(ref["loss_sum"]),
                               **METRIC_TOL)
    assert int(ours["correct"]) == int(ref["correct"])
    assert int(ours["count"]) == int(ref["count"]) == 4
    assert ours["correct"].dtype == ours["count"].dtype == torch.int32


def test_synthetic_arrays_equal_jax():
    for args in [(8, (16, 16, 3), 5, 1), (6, (32, 32, 3), 65, 3, 0.5)]:
        ours, ref = loop._synthetic_classification_arrays(*args), jax_arrays(*args)
        np.testing.assert_array_equal(ours[0], ref[0])
        np.testing.assert_array_equal(ours[1], ref[1])


CLI_ARGS = ["--synthetic", "--arch", "tiny", "--img_crop_size", "32",
            "--source_batch_size", "2", "--num_iters", "2",
            "--check_acc_step", "2", "--stat_collection_passes", "1"]


def test_cli_trains_evaluates_and_collects_on_cpu():
    records = []
    cfg = cli.config_from_args(cli.build_parser().parse_args(
        CLI_ARGS + ["--device", "cpu", "--log_interval", "1"]))
    assert cfg.sgd_momentum == 0.9 and cfg.lr_milestones == (6000,)
    acc = loop.run_officehome(cfg, lambda kind, step, **f: records.append(
        (kind, step, f)))
    assert np.isfinite(acc) and 0.0 <= acc <= 100.0
    kinds = [r[0] for r in records]
    assert kinds == ["train", "train", "test", "stat_collection", "final_test",
                     "params_digest"]
    assert all(np.isfinite(r[2][k]) for r in records[:2]
               for k in ("loss", "cls_loss", "mec_loss", "grad_norm"))
    assert records[-2][2]["accuracy"] == acc
    # 32 synthetic test images at the default test batch of 10: three
    # full batches and a ragged one, padded for eval and left ragged to
    # collect.
    assert records[-2][2]["count"] == 32 and records[-2][2]["forwards"] == 4
    assert records[3][2]["forwards"] == 4
    assert cli.main(CLI_ARGS + ["--device", "cpu", "--num_iters", "1",
                                "--stat_collection_passes", "0"]) >= 0.0


def test_trainer_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(CLI_ARGS)
