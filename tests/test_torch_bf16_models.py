"""Port parity: bf16 train steps and bf16 serving of ``dwt_tpu_torch`` against the live JAX package.

LeNet-DWT (8 images per domain at 28², with the Cholesky and the SWBN
whitener; Newton–Schulz's bf16 factorization is held to JAX's op by op in
``test_torch_bf16.py``, its JAX step compiles for most of a minute), built
with ``dtype`` bf16 on both sides (JAX's ``dtype=jnp.bfloat16``, the
port's ``dtype=torch.bfloat16``), tied through the weight bridge from
JAX's init with perturbed affines and randomized running stats: one train
step — its losses and every updated running stat against JAX's,
and its train-mode logits within the spread bf16 itself adds
(:func:`_within_bf16_spread`) — and the bf16 serving forward of LeNet-DWT
against JAX's bf16 eval forward.  Parameters, gradients and optimizer state stay
f32 in the port, as ``grads_in_param_dtype`` and the f32 optimizer state
hold them in JAX.

Tolerance: JAX's bf16 tolerance, ``rtol = atol = 2e-2``
(``tests/test_pallas_whitening.py:65``); logits relative to their largest
magnitude.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dwt_tpu.nn import LeNetDWT as JaxLeNetDWT
from dwt_tpu.train import steps as jsteps
from dwt_tpu.train.optim import adam_l2 as jax_adam_l2
from dwt_tpu.train.optim import multistep_schedule as jax_multistep
from dwt_tpu.train.optim import with_lr_backoff
from dwt_tpu.train.state import TrainState as JaxTrainState
from dwt_tpu_torch.config import DigitsConfig
from dwt_tpu_torch.convert import load_jax_variables
from dwt_tpu_torch.nn import LeNetDWT
from dwt_tpu_torch.serve.engine import ServeEngine
from dwt_tpu_torch.train import steps
from dwt_tpu_torch.train.optim import digits_tx
from dwt_tpu_torch.train.state import TrainState

TOL = dict(rtol=2e-2, atol=2e-2)
BF16 = torch.bfloat16


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _randomize(params, stats, rng):
    """Perturbed affines and biases; SPD covariances, positive variances,
    small means, nonzero counts and tracked matrices off the identity."""
    params = jax.tree.map(lambda a: (a + rng.normal(0, 0.1, a.shape)).astype(np.float32)
                          if a.ndim == 1 else a, params)

    def leaf(path, a):
        name = getattr(path[-1], "name", str(path[-1]))
        if name == "cov":
            m = rng.normal(size=a.shape)
            return (m @ np.swapaxes(m, -1, -2) / 4 + 0.5 * np.eye(4)).astype(np.float32)
        if name == "w":
            return (a + 0.05 * rng.normal(size=a.shape)).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 2.0, size=a.shape).astype(np.float32)
        if name == "mean":
            return rng.normal(0.0, 0.2, size=a.shape).astype(np.float32)
        return np.full(a.shape, 3, a.dtype)  # count

    return params, jax.tree_util.tree_map_with_path(leaf, stats)


def _tie(jax_model, port, sample):
    """JAX's init of ``jax_model`` on ``sample``, randomized, and ``port``
    loaded with the same values."""
    variables = jax.jit(lambda k: jax_model.init(k, sample, train=True))(jax.random.key(0))
    params, stats = _randomize(jax.tree.map(np.asarray, variables["params"]),
                               jax.tree.map(np.asarray, variables["batch_stats"]),
                               np.random.default_rng(0))
    load_jax_variables(port, params, stats)
    return params, stats, port.to(memory_format=torch.channels_last)


def _jax_train_logits(model, params, stats, x):
    """JAX's train-mode forward (jitted: op-by-op dispatch of a whole
    model costs seconds per forward on the CPU)."""
    return jax.jit(lambda p, s, v: model.apply({"params": p, "batch_stats": s}, v,
                                               train=True, mutable=["batch_stats"])[0])(
        params, stats, x)


def _scaled_close(ours, ref):
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    scale = np.abs(ref).max()
    np.testing.assert_allclose(ours / scale, ref / scale, **TOL)


def _within_bf16_spread(ours, ref, ref_f32):
    """Train-mode logits: the port's bf16 logits no further from JAX's bf16
    logits than twice JAX's own bf16 logits are from its f32 ones.  BN over
    a few samples per domain, fed bf16 activations whose mean is large
    against their spread, amplifies each framework's roundings alike (~5%
    of the logits' scale at 8 images per domain), so two bf16 forwards
    agree only within that spread."""
    ours, ref, ref_f32 = (np.asarray(a, np.float64) for a in (ours, ref, ref_f32))
    spread = np.abs(ref - ref_f32).max()
    assert np.abs(ours - ref).max() <= 2 * spread, (np.abs(ours - ref).max(), spread)


def _assert_stats_match(port, ref_port):
    ref = ref_port.state_dict()
    for name, value in port.state_dict().items():
        if not name.endswith(("weight", "bias", "gamma", "beta")):
            assert value.dtype == ref[name].dtype, name
            np.testing.assert_allclose(value.double().numpy(), ref[name].double().numpy(),
                                       err_msg=name, **TOL)


def _assert_f32_state(state):
    for p in state.model.parameters():
        assert p.dtype == torch.float32 and p.grad.dtype == torch.float32
    for buffers in state.optimizer.state.values():
        for v in buffers.values():
            assert not torch.is_floating_point(v) or v.dtype == torch.float32


@pytest.mark.parametrize("name", ["cholesky", "swbn"])
def test_lenet_bf16_step_matches_jax(name):
    """One bf16 digits step from tied weights: logits, losses and every
    updated running stat against JAX's bf16 step."""
    n = 8
    jax_model = JaxLeNetDWT(group_size=4, dtype=jnp.bfloat16, whitener=name)
    params, stats, port = _tie(jax_model, LeNetDWT(group_size=4, dtype=BF16, whitener=name),
                               jnp.zeros((2, n, 28, 28, 1)))
    rng = np.random.default_rng(1)
    batch = {"source_x": rng.normal(size=(n, 28, 28, 1)).astype(np.float32),
             "target_x": rng.normal(size=(n, 28, 28, 1)).astype(np.float32),
             "source_y": rng.integers(0, 10, size=n)}
    x = np.stack([batch["source_x"], batch["target_x"]])
    logits_ref, ref_f32 = (_jax_train_logits(jax_model.clone(dtype=dt), params, stats, x)
                           for dt in (jnp.bfloat16, jnp.float32))
    with torch.no_grad():
        logits = LeNetDWT(group_size=4, dtype=BF16, whitener=name).train()
        load_jax_variables(logits, params, stats)
        logits = logits(torch.from_numpy(x))
    assert logits.dtype == BF16
    _within_bf16_spread(logits.float().numpy(), np.asarray(logits_ref, np.float32),
                        np.asarray(ref_f32))

    tx = with_lr_backoff(jax_adam_l2(jax_multistep(1e-3, (50, 80), 0.1, scale=8), 5e-4))
    jparams = jax.tree.map(jnp.asarray, params)
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=jparams,
                           batch_stats=jax.tree.map(jnp.asarray, stats),
                           opt_state=tx.init(jparams))
    new_jax, ref = jax.jit(jsteps.make_digits_train_step(jax_model, tx, 0.1))(
        jstate, jax.tree.map(jnp.asarray, batch))
    optimizer, schedules = digits_tx(port, DigitsConfig(), 8)
    state = TrainState(port, optimizer, schedules)
    metrics = steps.make_digits_train_step(port, 0.1)(
        state, {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()})
    for key in ("loss", "cls_loss", "entropy_loss"):
        np.testing.assert_allclose(float(metrics[key]), float(ref[key]), err_msg=key, **TOL)
    assert bool(metrics["finite"])
    after = LeNetDWT(group_size=4, whitener=name)
    load_jax_variables(after, jax.tree.map(np.asarray, new_jax.params),
                       jax.tree.map(np.asarray, new_jax.batch_stats))
    _assert_stats_match(port, after)
    _assert_f32_state(state)


def test_lenet_bf16_serving_matches_jax_bf16_eval():
    """The engine at ``--serve_dtype bf16`` (a bf16 model from f32
    parameters, the cache factorized in f32 and cast): f32 logits within
    JAX's bf16 tolerance of the JAX bf16 eval forward, and within the same
    band of the port's f32 engine."""
    jax_model = JaxLeNetDWT(group_size=4, dtype=jnp.bfloat16)
    params, stats, port = _tie(jax_model, LeNetDWT(group_size=4, dtype=BF16),
                               jnp.zeros((2, 2, 28, 28, 1)))
    images = np.random.default_rng(3).normal(size=(5, 28, 28, 1)).astype(np.float32)
    ref = jax.jit(lambda p, s, v: jax_model.apply({"params": p, "batch_stats": s}, v,
                                                  train=False))(params, stats, images)
    engine = ServeEngine(port, (28, 28, 1), buckets=(8,), device="cpu")
    assert all(p.dtype == torch.float32 for p in port.parameters())
    assert port.dn1.eval_matrix.dtype == torch.float32
    assert torch.equal(port.dn1.eval_matrix, port.dn1.eval_matrix.bfloat16().float())
    ours = engine.infer(images)
    assert ours.dtype == np.float32
    _scaled_close(ours, np.asarray(ref, np.float32))
    f32 = LeNetDWT(group_size=4)
    load_jax_variables(f32, params, stats)
    _scaled_close(ours, ServeEngine(f32, (28, 28, 1), buckets=(8,), device="cpu").infer(images))
