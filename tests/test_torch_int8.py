"""Port int8 deployment format against the JAX package.

``quantize_int8`` must give bitwise the JAX package's int8 weights and
per-tensor scales (each step is the same f32 arithmetic, round half to
even), ``dequantize_int8`` bitwise its dequantized weights, and the int8
engine's logits must match the JAX int8 engine's within f32 tolerance
(``rtol=1e-4``, ``atol=1e-4`` × the logits' scale — the eval forward's
tolerance in ``test_torch_lenet.py``), on LeNet-DWT and the tiny
ResNet-DWT with the same randomized weights and SPD stats.  The
generation keeps its weights resident as int8 and dequantizes inside
each forward; a candidate with corrupted scales is refused by the
canary.
"""

from __future__ import annotations

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dwt_tpu.nn import LeNetDWT as JaxLeNetDWT
from dwt_tpu.nn import ResNetDWT as JaxResNetDWT
from dwt_tpu.serve import ServeEngine as JaxServeEngine
from dwt_tpu.serve.quant import dequantize_int8 as jax_dequantize
from dwt_tpu.serve.quant import quantize_int8 as jax_quantize
from dwt_tpu_torch.convert import load_jax_variables
from dwt_tpu_torch.fleet import CanaryGate
from dwt_tpu_torch.nn import LeNetDWT
from dwt_tpu_torch.nn.resnet import ResNetDWT
from dwt_tpu_torch.serve import server
from dwt_tpu_torch.serve.engine import ServeEngine, Version
from dwt_tpu_torch.serve.quant import dequantize_int8, quantize_int8, quantize_tensor

torch.set_num_threads(2)

TOL = dict(rtol=1e-4, atol=1e-4)


def _randomize(params, stats, rng):
    """Perturbed affines; SPD covariances, positive variances, small
    means, counts kept."""
    params = jax.tree.map(
        lambda a: (a + rng.normal(0, 0.1, a.shape) if a.ndim == 1 else a
                   ).astype(np.float32), params)

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
        return np.asarray(a)

    return params, jax.tree_util.tree_map_with_path(leaf, stats)


ARCHS = {
    "lenet": (lambda: JaxLeNetDWT(group_size=4), lambda: LeNetDWT(group_size=4),
              (28, 28, 1), 2),
    "tiny": (lambda: JaxResNetDWT(stage_sizes=(1, 1, 1, 1), num_classes=5),
             lambda: ResNetDWT.tiny(num_classes=5), (32, 32, 3), 3),
}


@pytest.fixture(scope="module", params=sorted(ARCHS))
def pair(request):
    """``(arch, jax model, params, stats, port model, shape)``, the same
    randomized weights in both."""
    jax_ctor, port_ctor, shape, domains = ARCHS[request.param]
    model = jax_ctor()
    sample = jnp.zeros((domains, 1) + shape, jnp.float32)
    variables = jax.jit(lambda k: model.init(k, sample, train=True))(jax.random.key(0))
    params, stats = _randomize(jax.tree.map(np.asarray, variables["params"]),
                               jax.tree.map(np.asarray, variables["batch_stats"]),
                               np.random.default_rng(0))
    port = port_ctor()
    load_jax_variables(port, params, stats)
    return request.param, model, params, stats, port, shape


def _jax_leaf(tree, name):
    """The JAX leaf of port parameter ``name`` (``conv1.weight`` →
    ``conv1/kernel``) in the port's layout."""
    *scope, leaf = name.split(".")
    a = tree
    for key in scope + ["kernel" if leaf == "weight" else leaf]:
        a = a[key]
    a = np.asarray(a)
    if a.ndim == 4:
        return a.transpose(3, 2, 0, 1)  # HWIO -> OIHW
    if a.ndim == 2 and leaf == "weight":
        return a.T
    return a


def test_quantize_int8_is_bitwise_the_jax_packages(pair):
    _, _, params, _, port, _ = pair
    q, scales = quantize_int8(port.named_parameters())
    jq, jscales = jax_quantize(params)
    deq = dequantize_int8(q, scales)
    jdeq = jax_dequantize(jq, jscales)
    assert sorted(q) == sorted(n for n, _ in port.named_parameters())
    for name in q:
        assert q[name].dtype == torch.int8 and scales[name].dtype == torch.float32
        np.testing.assert_array_equal(q[name].numpy(), _jax_leaf(jq, name))
        np.testing.assert_array_equal(scales[name].numpy(), _jax_leaf(jscales, name))
        np.testing.assert_array_equal(deq[name].numpy(), _jax_leaf(jdeq, name))


@pytest.mark.parametrize("values", [
    [0.0, 0.0, 0.0],                   # all zero: scale 1, exact
    [127.0, -63.5, 0.5, 1.5, -2.5],    # ties round half to even
    [1e-30, -3e-30, 2e-30],            # tiny magnitudes
    [3.4e38, -1.0, 2.0],               # near the f32 limit
])
def test_quantize_tensor_edges_match(values):
    w = np.asarray(values, np.float32)
    q, s = quantize_tensor(torch.from_numpy(w))
    jq, js = jax_quantize({"w": jnp.asarray(w)})
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq["w"]))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js["w"]))


def test_non_float_tensors_pass_through():
    step = torch.tensor(7, dtype=torch.int32)
    q, s = quantize_tensor(step)
    assert q is step and float(s) == 1.0
    assert dequantize_int8({"step": step}, {"step": s})["step"] is step


@pytest.fixture(scope="module")
def engines(pair):
    arch, model, params, stats, port, shape = pair
    ours = ServeEngine(copy.deepcopy(port), shape, buckets=(8,), device="cpu", quantize=True)
    ref = JaxServeEngine(model, params, stats, shape, buckets=(8,), quantize=True)
    x = np.random.default_rng(1).normal(size=(8,) + shape).astype(np.float32)
    return arch, ours, ref, x


def test_int8_engine_logits_match_the_jax_int8_engine(engines):
    _, ours, ref, x = engines
    got, want = ours.infer(x), ref.infer(x)
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, rtol=TOL["rtol"], atol=TOL["atol"] * scale)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_the_generation_keeps_int8_weights_resident(engines):
    _, ours, _, _ = engines
    st = ours.state
    assert {t.dtype for t in st.params.values()} == {torch.int8}
    assert {t.dtype for t in st.scales.values()} == {torch.float32}
    assert sorted(st.params) == sorted(st.scales)
    # The module holds nothing float of its parameters: each float read
    # is a dequantization of the resident int8 tensor.
    assert all(p.dtype == torch.int8 for p in st.model.parameters())
    name = next(iter(st.params))
    mod = st.model.get_submodule(name.rsplit(".", 1)[0]) if "." in name else st.model
    leaf = name.rsplit(".", 1)[-1]
    np.testing.assert_array_equal(
        getattr(mod, leaf).detach().numpy(),
        (st.params[name].float() * st.scales[name]).numpy())


def test_an_adapted_int8_generation_shares_the_int8_weights(engines):
    _, ours, _, x = engines
    base = ours.state
    stats = {k: v.numpy() for k, v in base.batch_stats.items()}
    st = ours.build_state_from_stats(base, stats, version=Version(9, "same"))
    for name, q in base.params.items():
        assert st.params[name].data_ptr() == q.data_ptr()
        assert st.scales[name].dtype == torch.float32
    # The same stats refactorized: the same logits, bitwise.
    np.testing.assert_array_equal(ours.infer(x, state=st), ours.infer(x))


def test_canary_refuses_a_scale_corrupted_int8_candidate(engines):
    _, ours, _, x = engines
    y = ours.infer(x).argmax(-1)  # live accuracy 100%
    gate = CanaryGate(ours, x, y, max_regress_pp=5.0)
    assert gate.check(ours.state).ok
    bad = ours.build_state_from_stats(
        ours.state, {k: v.numpy() for k, v in ours.state.batch_stats.items()},
        version=Version(2, "bad"))
    for i, scale in enumerate(bad.scales.values()):
        # Per-leaf corruption (a uniform rescale of every scale is largely
        # absorbed by the normalization layers).
        scale.mul_(1.0 + 40.0 * (i % 3))
    verdict = gate.check(bad)
    assert not verdict.ok
    assert "regressed" in verdict.reason or "non-finite" in verdict.reason
    # The candidate's scales are its own: the live generation is intact.
    assert gate.check(ours.state).ok


def test_server_flag_builds_an_int8_engine():
    args = server.build_parser().parse_args([
        "--model", "lenet", "--init_random", "--quantize_int8", "--buckets", "1,4",
        "--device", "cpu"])
    engine = server.build_engine(args)
    assert engine.quantize and engine.buckets == (1, 4)
    assert {t.dtype for t in engine.state.params.values()} == {torch.int8}
    x = np.random.default_rng(3).normal(size=(3, 28, 28, 1)).astype(np.float32)
    assert np.isfinite(engine.infer(x)).all()
