"""Port parity: the digits (USPS→MNIST) slice of ``dwt_tpu_torch`` against the live JAX package.

The train step, the eval step, the Adam recipe and its epoch-scaled
schedule, the data (synthetic arrays and the USPS/MNIST loaders), the
trainer's CLI and the server's ``--model lenet``.  The model is the full
LeNet-DWT at 28×28, 8 images per domain, from JAX's ``model.init`` with
perturbed affines and biases and randomized running stats, tied into the
port through the bridge.  JAX runs its XLA path and its Pallas kernels in
interpret mode (``use_pallas=True``); the port runs on the CPU.

Tolerances, and what they read:

* Metrics (loss, its cls and entropy parts, the gradient norm) ``rtol =
  1e-4`` in f32 (readings ≤ 2.5e-6), ``1e-12`` in float64 (≤ 1e-15).
* Gradients, per parameter: ``‖g − g_jax‖ ≤ rtol·‖g_jax‖ + atol·‖g_all‖``
  with ``rtol = 1e-4, atol = 1e-6`` in f32 (readings ≤ 1e-5 of the leaf's
  norm) and ``1e-10, 1e-12`` in float64.  The ``atol`` term is for the five
  biases that feed a normalization site (``conv1``, ``conv2``, ``fc3``,
  ``fc4``, ``fc5``): the batch mean removes them, so their exact gradient
  is zero and both frameworks return rounding noise (~1e-7 in f32 against
  a gradient norm of ~60, ~1e-15 in float64).
* Running stats ``rtol = atol = 1e-4`` in f32, ``1e-10`` in float64.
* Post-Adam parameters, compared in float64 over two steps: ``rtol = atol
  = 1e-10`` (readings ≤ 1.9e-12), and each parameter's update ``Δ = post −
  pre`` within ``1e-10`` of JAX's relative to ``‖Δ_jax‖`` (readings ≤
  1.2e-13), the five biases within ``1e-8`` (≤ 2.7e-10).  Adam divides by
  ``|g| + 1e-8``, so where ``g`` is rounding noise plus the small L2 term
  the noise reaches the update.  In f32 the update is held at ``2e-3``
  per parameter (readings ≤ 1.3e-4) for every parameter but those five
  biases, whose update f32 reads 1e-4–2.5e-2 apart (up to 1.7e-4 in value
  against an lr of 1e-3): a property of the step, which float64 pins
  down.
"""

from __future__ import annotations

import gzip
import os
import pickle
import struct
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dwt_tpu.config import DigitsConfig as JaxDigitsConfig
from dwt_tpu.data import datasets as jax_datasets
from dwt_tpu.nn import LeNetDWT as JaxLeNetDWT
from dwt_tpu.ops.losses import entropy_loss, softmax_cross_entropy
from dwt_tpu.train import steps as jsteps
from dwt_tpu.train.loop import _digits_datasets as jax_digits_datasets
from dwt_tpu.train.optim import adam_l2 as jax_adam_l2
from dwt_tpu.train.optim import multistep_schedule as jax_multistep
from dwt_tpu.train.optim import with_lr_backoff
from dwt_tpu.train.state import TrainState as JaxTrainState
from dwt_tpu_torch.cli import usps_mnist as cli
from dwt_tpu_torch.config import DigitsConfig
from dwt_tpu_torch.convert import load_jax_variables
from dwt_tpu_torch.data import datasets
from dwt_tpu_torch.nn import LeNetDWT
from dwt_tpu_torch.serve import server
from dwt_tpu_torch.train import loop, steps
from dwt_tpu_torch.train.evalpipe import EvalPipeline
from dwt_tpu_torch.train.optim import digits_tx, multistep_schedule, set_learning_rates
from dwt_tpu_torch.train.state import TrainState

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 8
STEPS_PER_EPOCH = 8  # the schedule's scale in the step tests
METRIC_KEYS = ("loss", "cls_loss", "entropy_loss", "grad_norm")
TOLS = {  # per dtype: metrics, gradients (rtol, atol), stats
    "f32": dict(metric=1e-4, grad=(1e-4, 1e-6), stats=dict(rtol=1e-4, atol=1e-4)),
    "f64": dict(metric=1e-12, grad=(1e-10, 1e-12), stats=dict(rtol=1e-10, atol=1e-10)),
}
F32_UPDATE_TOL = 2e-3
F64_PARAM_TOL = dict(rtol=1e-10, atol=1e-10)
F64_UPDATE_TOL = (1e-10, 1e-8)  # (every parameter, the normalized biases)
NORMALIZED_BIASES = {"conv1.bias", "conv2.bias", "fc3.bias", "fc4.bias", "fc5.bias"}
CLI_ARGS = ["--synthetic", "--group_size", "4", "--synthetic_size", "64",
            "--epochs", "1"]


def _randomize(params, stats, rng, dtype):
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


@pytest.fixture(scope="module")
def init():
    """JAX's LeNet-DWT init as numpy trees ``(params, batch_stats)``."""
    model = JaxLeNetDWT(group_size=4)
    variables = jax.jit(lambda k: model.init(
        k, jnp.zeros((2, N, 28, 28, 1)), train=True))(jax.random.key(0))
    return (jax.tree.map(np.asarray, variables["params"]),
            jax.tree.map(np.asarray, variables["batch_stats"]))


def _np_dtype(dtype):
    return np.float64 if dtype == "f64" else np.float32


def _torch_dtype(dtype):
    return torch.float64 if dtype == "f64" else torch.float32


def _batch(seed, dtype):
    rng = np.random.default_rng(seed)
    img = lambda: rng.normal(size=(N, 28, 28, 1)).astype(_np_dtype(dtype))
    return {"source_x": img(), "source_y": rng.integers(0, 10, size=N),
            "target_x": img()}


def _jax_tx():
    """The JAX loop's optimizer, backoff wrapper (inert at 1.0) included."""
    return with_lr_backoff(jax_adam_l2(
        jax_multistep(1e-3, (50, 80), 0.1, scale=STEPS_PER_EPOCH), 5e-4))


def _jax_model(dtype, use_pallas=False):
    return JaxLeNetDWT(group_size=4, use_pallas=use_pallas,
                       dtype=jnp.float64 if dtype == "f64" else jnp.float32)


def _jax_step(state, batch, dtype, use_pallas=False):
    """JAX's digits train step and, beside it, the gradient of the same
    loss (the step applies it without returning it)."""
    model = _jax_model(dtype, use_pallas)
    x = jnp.stack([batch["source_x"], batch["target_x"]])

    def loss_fn(params):
        logits, _ = model.apply(
            {"params": params, "batch_stats": state.batch_stats}, x,
            train=True, mutable=["batch_stats"])
        return (softmax_cross_entropy(logits[0], batch["source_y"])
                + 0.1 * entropy_loss(logits[1]))

    grads = jax.jit(jax.grad(loss_fn))(state.params)
    new_state, metrics = jax.jit(jsteps.make_digits_train_step(
        model, _jax_tx(), 0.1))(state, jax.tree.map(jnp.asarray, batch))
    return new_state, metrics, grads


def _jax_state(params, stats):
    params = jax.tree.map(jnp.asarray, params)
    return JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                         batch_stats=jax.tree.map(jnp.asarray, stats),
                         opt_state=_jax_tx().init(params))


def _port(params, stats, dtype) -> LeNetDWT:
    port = LeNetDWT(group_size=4).to(_torch_dtype(dtype))
    load_jax_variables(port, jax.tree.map(np.asarray, params),
                       jax.tree.map(np.asarray, stats))
    return port.to(memory_format=torch.channels_last)


def _port_state(jax_state, dtype) -> TrainState:
    """The port's train state tied to JAX's: weights, stats, the step count
    and Adam's moments and count."""
    port = _port(jax_state.params, jax_state.batch_stats, dtype)
    optimizer, schedules = digits_tx(port, DigitsConfig(), STEPS_PER_EPOCH)
    (adam,) = [s for s in jax.tree.leaves(
        jax_state.opt_state, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    if int(adam.count):
        mu = dict(_port(adam.mu, jax_state.batch_stats, dtype).named_parameters())
        nu = dict(_port(adam.nu, jax_state.batch_stats, dtype).named_parameters())
        for name, p in port.named_parameters():
            optimizer.state[p] = {
                "step": torch.tensor(float(adam.count)),
                "exp_avg": mu[name].detach().clone(),
                "exp_avg_sq": nu[name].detach().clone(),
            }
    return TrainState(port, optimizer, schedules, step=int(jax_state.step))


def _port_batch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _assert_step_matches(jax_state, batch, dtype, use_pallas=False):
    """One digits step on both sides from ``jax_state``: metrics,
    gradients, stats and parameters at the module docstring's limits.
    Returns JAX's new state."""
    tol = TOLS[dtype]
    new_jax, ref, grads = _jax_step(jax_state, batch, dtype, use_pallas)
    state = _port_state(jax_state, dtype)
    metrics = steps.make_digits_train_step(state.model, 0.1)(
        state, _port_batch(batch))
    for key in METRIC_KEYS:
        np.testing.assert_allclose(float(metrics[key]), float(ref[key]),
                                   rtol=tol["metric"], err_msg=key)
    assert bool(metrics["finite"]) and state.step == int(new_jax.step)

    ref_grads = dict(_port(grads, jax_state.batch_stats, dtype).named_parameters())
    g_all = float(ref["grad_norm"])
    rtol, atol = tol["grad"]
    for name, p in state.model.named_parameters():
        err = float((p.grad - ref_grads[name]).detach().norm())
        bound = rtol * float(ref_grads[name].detach().norm()) + atol * g_all
        assert err <= bound, (name, err)

    after = _port(new_jax.params, new_jax.batch_stats, dtype)
    ref_state = after.state_dict()
    for name, value in state.model.state_dict().items():
        if not name.endswith(("weight", "bias", "gamma", "beta")):
            np.testing.assert_allclose(value.numpy(), ref_state[name].numpy(),
                                       err_msg=name, **tol["stats"])

    before = dict(_port(jax_state.params, jax_state.batch_stats, dtype)
                  .named_parameters())
    ref_params = {k: v.detach() for k, v in after.named_parameters()}
    for name, p in state.model.named_parameters():
        p = p.detach()
        delta_ref = (ref_params[name] - before[name].detach()).double()
        err = float(((p - before[name].detach()).double() - delta_ref).norm()
                    / delta_ref.norm())
        if dtype == "f64":
            np.testing.assert_allclose(p.numpy(), ref_params[name].numpy(),
                                       err_msg=name, **F64_PARAM_TOL)
            assert err <= F64_UPDATE_TOL[name in NORMALIZED_BIASES], (name, err)
        elif name not in NORMALIZED_BIASES:
            assert err <= F32_UPDATE_TOL, (name, err)
    return new_jax


@pytest.mark.parametrize("use_pallas", [False, True])
def test_digits_step_matches_jax_in_f32(init, use_pallas):
    params, stats = _randomize(*init, np.random.default_rng(0), np.float32)
    _assert_step_matches(_jax_state(params, stats), _batch(1, "f32"), "f32",
                         use_pallas)


def test_digits_step_and_a_retied_second_step_match_jax_in_f64(init):
    """Step 1 from the shared init, then step 2 from JAX's post-step-1
    state re-tied into the port (Adam's moments and count live), both in
    float64, post-Adam parameters included."""
    params, stats = _randomize(*init, np.random.default_rng(0), np.float64)
    with jax.enable_x64(True):
        state1 = _assert_step_matches(_jax_state(params, stats),
                                      _batch(1, "f64"), "f64")
        assert int(state1.step) == 1
        _assert_step_matches(state1, _batch(2, "f64"), "f64")


def test_eval_step_and_ragged_eval_pass_match_jax(init):
    """``make_eval_step`` on one batch; the eval pipeline over 7 images at
    a test batch of 4 (the ragged tail padded and masked) against JAX's
    eval step summed over the unpadded batches."""
    params, stats = _randomize(*init, np.random.default_rng(3), np.float32)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(7, 28, 28, 1)).astype(np.float32)
    y = rng.integers(0, 10, size=7)
    jax_eval = jax.jit(jsteps.make_eval_step(JaxLeNetDWT(group_size=4)))
    parts = [jax_eval(params, stats, x[a:b], y[a:b]) for a, b in ((0, 4), (4, 7))]
    port = _port(params, stats, "f32")
    ours = steps.make_eval_step(port)(torch.from_numpy(x[:4]), torch.from_numpy(y[:4]))
    np.testing.assert_allclose(float(ours["loss_sum"]), float(parts[0]["loss_sum"]),
                               rtol=1e-4)
    assert int(ours["correct"]) == int(parts[0]["correct"])
    assert int(ours["count"]) == 4 and ours["count"].dtype == torch.int32

    result = EvalPipeline(4, torch.device("cpu"), num_domains=2).evaluate(
        TrainState(port, None, ()), datasets.ArrayDataset(x, y))
    loss_sum = sum(float(p["loss_sum"]) for p in parts)
    correct = sum(int(p["correct"]) for p in parts)
    assert result["count"] == 7 and result["forwards"] == 2
    np.testing.assert_allclose(result["loss"], loss_sum / 7, rtol=1e-4)
    assert result["accuracy"] == 100.0 * correct / 7
    assert port.dn1.eval_matrix is None  # the pass's cache is uninstalled


def test_lr_sequence_matches_the_jax_schedule():
    """Epoch milestones (50, 80) at 3 steps per epoch: the lr the port's
    optimizer gets at every step equals optax's schedule, decaying at steps
    147 and 237 (one epoch early, the reference's pre-step quirk)."""
    spe = 3
    ref = jax_multistep(1e-3, (50, 80), 0.1, scale=spe)
    ours = multistep_schedule(1e-3, (50, 80), 0.1, scale=spe)
    optimizer, schedules = digits_tx(LeNetDWT(group_size=4), DigitsConfig(), spe)
    seen = []
    for step in range(0, 100 * spe):
        set_learning_rates(optimizer, schedules, step)
        seen.append(optimizer.param_groups[0]["lr"])
        np.testing.assert_allclose(ours(step), float(ref(step)), rtol=1e-6)
    assert seen == [ours(s) for s in range(100 * spe)]
    assert (ours(146), ours(147), ours(236), ours(237)) == pytest.approx(
        (1e-3, 1e-4, 1e-4, 1e-5))
    group = optimizer.param_groups[0]
    assert isinstance(optimizer, torch.optim.Adam)
    assert group["weight_decay"] == 5e-4 and group["betas"] == (0.9, 0.999)
    assert len(group["params"]) == len(list(LeNetDWT().parameters()))


def test_synthetic_digits_arrays_equal_jax():
    cfg = dict(synthetic=True, synthetic_size=48, seed=3)
    ours = loop._digits_datasets(DigitsConfig(**cfg))
    ref = jax_digits_datasets(JaxDigitsConfig(**cfg))
    assert [len(d) for d in ours] == [48, 48, 24]
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a.images, b.images)
        np.testing.assert_array_equal(a.labels, b.labels)
        assert a.images.shape[1:] == (28, 28, 1)


def _write_usps(path, rng):
    split = lambda n: [rng.uniform(0, 1, size=(n, 1, 28, 28)).astype(np.float32),
                       rng.integers(0, 10, size=(n, 1))]
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with gzip.open(path, "wb") as f:
        pickle.dump([split(5), split(3)], f)


def _write_mnist_idx(root, prefix, rng, n):
    os.makedirs(root, exist_ok=True)
    images = rng.integers(0, 256, size=(n, 28, 28), dtype=np.uint8)
    labels = rng.integers(0, 10, size=(n,), dtype=np.uint8)
    with open(os.path.join(root, f"{prefix}-images-idx3-ubyte"), "wb") as f:
        f.write(struct.pack(">IIII", 2051, n, 28, 28) + images.tobytes())
    with open(os.path.join(root, f"{prefix}-labels-idx1-ubyte"), "wb") as f:
        f.write(struct.pack(">II", 2049, n) + labels.tobytes())


def _assert_same(ours, ref):
    for a, b in zip(ours, ref):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_loaders_equal_jax_on_tiny_files(tmp_path):
    rng = np.random.default_rng(0)
    usps = str(tmp_path / "usps" / "usps_28x28.pkl")
    _write_usps(usps, rng)
    for train in (True, False):
        ours = datasets.load_usps(str(tmp_path / "usps"), train=train, seed=3)
        _assert_same(ours, jax_datasets.load_usps(str(tmp_path / "usps"),
                                                  train=train, seed=3))
        assert ours[0].shape == ((30 if train else 3), 28, 28, 1)
    assert datasets.USPS_MULTIPLIER == jax_datasets.USPS_MULTIPLIER == 6

    mnist = str(tmp_path / "mnist")
    _write_mnist_idx(mnist, "train", rng, 6)
    _write_mnist_idx(mnist, "t10k", rng, 4)
    for train in (True, False):
        ours = datasets.load_mnist(mnist, train=train)
        _assert_same(ours, jax_datasets.load_mnist(mnist, train=train))
        assert ours[0].max() <= 1.0 and ours[0].shape[1:] == (28, 28, 1)

    processed = str(tmp_path / "mnist_pt")
    os.makedirs(os.path.join(processed, "processed"))
    torch.save((torch.randint(0, 256, (5, 28, 28), dtype=torch.uint8),
                torch.randint(0, 10, (5,))),
               os.path.join(processed, "processed", "training.pt"))
    _assert_same(datasets.load_mnist(processed),
                 jax_datasets.load_mnist(processed))

    # The loaders of the whole run, normalization included.
    cfg = dict(data_root=str(tmp_path), seed=3)
    for ours, ref in zip(loop._digits_datasets(DigitsConfig(**cfg)),
                         jax_digits_datasets(JaxDigitsConfig(**cfg))):
        _assert_same((ours.images, ours.labels), (ref.images, ref.labels))

    with pytest.raises(FileNotFoundError, match="usps_28x28.pkl"):
        datasets.load_usps(str(tmp_path / "nowhere"))
    with pytest.raises(FileNotFoundError, match="MNIST not found"):
        datasets.load_mnist(str(tmp_path / "nowhere"))


def test_run_digits_records_and_refusals():
    records = []
    cfg = cli.config_from_args(cli.build_parser().parse_args(
        CLI_ARGS + ["--epochs", "2", "--log_interval", "1", "--device", "cpu"]))
    assert (cfg.lr, cfg.lr_milestones, cfg.sgd_momentum) == (1e-3, (50, 80), 0.5)
    acc = loop.run_digits(cfg, lambda kind, step, **f: records.append((kind, step, f)))
    # 64 images at 32 per stream: 2 steps per epoch, then the epoch's eval
    # over 32 test images in one padded forward of the test batch (100).
    assert [(k, s) for k, s, _ in records] == [
        ("train", 1), ("train", 2), ("test", 2), ("train", 3), ("train", 4),
        ("test", 4), ("params_digest", 4)]
    assert all(np.isfinite(f[k]) for k, _, f in records if k == "train"
               for k in METRIC_KEYS)
    assert [f["epoch"] for _, _, f in records[:-1]] == [0, 0, 0, 1, 1, 1]
    test = records[-2][2]
    assert test["accuracy"] == acc and 0.0 <= acc <= 100.0
    assert test["count"] == 32 and test["forwards"] == 1

    records.clear()
    with pytest.raises(ValueError, match="divisible"):  # conv2's 48 channels
        loop.run_digits(DigitsConfig(synthetic=True, device="cpu"),
                        lambda kind, step, **f: records.append(kind))
    assert records == ["warning"]
    with pytest.raises(ValueError, match="can not be the same"):
        loop.run_digits(DigitsConfig(target="usps", group_size=4, device="cpu"))
    with pytest.raises(ValueError, match="equal source/target batch"):
        loop.run_digits(DigitsConfig(target_batch_size=16, group_size=4,
                                     device="cpu"))


def test_cli_trains_and_evaluates_on_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "dwt_tpu_torch.cli.usps_mnist", *CLI_ARGS,
         "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "final target accuracy" in out.stdout
    assert '"kind": "test"' in out.stderr  # the log records


def test_trainer_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(CLI_ARGS)


def test_server_serves_lenet_on_cpu():
    args = server.build_parser().parse_args([
        "--model", "lenet", "--buckets", "1,8", "--init_random", "--seed", "0",
        "--device", "cpu"])
    engine = server.build_engine(args)
    assert engine.input_shape == (28, 28, 1) and engine.buckets == (1, 8)
    sites = (engine.model.dn1, engine.model.dn2)
    assert [tuple(s.eval_matrix.shape) for s in sites] == [(8, 4, 4), (12, 4, 4)]
    x = np.random.default_rng(0).normal(size=(5, 28, 28, 1)).astype(np.float32)
    out = engine.infer(x)
    assert out.shape == (5, 10) and np.isfinite(out).all()
    # Fresh stats amplify activations by ~1/sqrt(eps) per whitened site:
    # relative to the largest logit, as the other serving tests compare.
    close = lambda a, b: np.testing.assert_allclose(
        a, b, rtol=1e-5, atol=1e-5 * float(np.abs(b).max()))
    with torch.no_grad():
        close(out, engine.model(torch.from_numpy(x)).numpy())
    client = server.ServeClient(engine, max_batch_delay_ms=1.0)
    front = server.HttpFront(client, "127.0.0.1", 0)
    http = server.HttpServeClient("127.0.0.1", front.port, timeout=60)
    try:
        close(http.infer(x[:1], binary=True), out[:1])
    finally:
        http.close()
        front.close()
