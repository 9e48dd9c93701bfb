"""Port parity: the tiny ResNet-DWT eval forward of ``dwt_tpu_torch`` against
the live JAX package, through the weight bridge.

The model is ``ResNetDWT(stage_sizes=(1,1,1,1), num_classes=5)`` at
32×32 — the server's ``tiny``: full channel widths, one block per stage,
five whitened sites.  Params come from the JAX ``model.init``; the
running stats are randomized with numpy (means, SPD covariances,
positive variances) so that no site runs on its init values.  The port
(on CPU, plain apply) is held to the JAX deployment forward
(``make_serve_forward`` with the ``make_whiten_cache_fn`` cache) and to
the Pallas model (``use_pallas=True``, interpret mode).

Tolerance on logits: ``rtol=atol=1e-4`` — the convolutions sum in other
orders in XLA and in PyTorch's CPU kernels.
"""

from __future__ import annotations

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dwt_tpu.nn import ResNetDWT as JaxResNetDWT
from dwt_tpu.nn import norms as jax_norms
from dwt_tpu.train.evalpipe import make_whiten_cache_fn
from dwt_tpu.train.steps import make_serve_forward
from dwt_tpu_torch.convert import load_jax_variables
from dwt_tpu_torch.nn.resnet import ResNetDWT, padded_num_classes
from dwt_tpu_torch.nn import norms
from dwt_tpu_torch.nn.norms import install_eval_matrix
from dwt_tpu_torch.serve.engine import make_whiten_cache

TOL = dict(rtol=1e-4, atol=1e-4)
SIZE = 32
CLASSES = 5


def _randomize_stats(tree, rng):
    """Replace every stat leaf with a plausible random value: SPD
    covariances, positive variances, small means."""
    def leaf(path, a):
        name = path[-1].name if hasattr(path[-1], "name") else str(path[-1])
        a = np.asarray(a)
        if name == "cov":
            g = a.shape[-1]
            m = rng.normal(size=a.shape)
            return (m @ np.swapaxes(m, -1, -2) / g + 0.5 * np.eye(g)).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 2.0, size=a.shape).astype(np.float32)
        if name == "mean":
            return rng.normal(0.0, 0.2, size=a.shape).astype(np.float32)
        return a  # count
    return jax.tree_util.tree_map_with_path(leaf, tree)


@pytest.fixture(scope="module")
def tied():
    """``(jax model, params, batch_stats, port model, images)``."""
    model = JaxResNetDWT(stage_sizes=(1, 1, 1, 1), num_classes=CLASSES)
    sample = jnp.zeros((3, 1, SIZE, SIZE, 3), jnp.float32)
    variables = jax.jit(lambda key: model.init(key, sample, train=True))(
        jax.random.key(0))
    rng = np.random.default_rng(0)
    params = jax.tree.map(np.asarray, variables["params"])
    # Non-zero affines and head bias so the bridge's leaves all matter.
    params = jax.tree.map(
        lambda a: a + rng.normal(0, 0.1, a.shape).astype(a.dtype)
        if a.ndim == 1 else a, params)
    stats = _randomize_stats(variables["batch_stats"], rng)
    port = ResNetDWT.tiny(num_classes=CLASSES)
    load_jax_variables(port, params, stats)
    port.eval()
    images = rng.normal(size=(4, SIZE, SIZE, 3)).astype(np.float32)
    return model, params, stats, port, images


def _port_forward(port, images, cached=True):
    port = port.to(memory_format=torch.channels_last)
    sites = make_whiten_cache(port) if cached else {}
    for name, w in sites.items():
        install_eval_matrix(port.get_submodule(name), w)
    try:
        with torch.inference_mode():
            return port(torch.from_numpy(images)).numpy()
    finally:
        for name in sites:
            install_eval_matrix(port.get_submodule(name), None)


def test_serve_forward_matches_jax(tied):
    model, params, stats, port, images = tied
    jstats = jax.tree.map(jnp.asarray, stats)
    cache = make_whiten_cache_fn("cholesky", 1e-3, 1)(jstats)
    ref = jax.jit(make_serve_forward(model))(
        params, jstats, cache, jnp.asarray(images))
    ours = _port_forward(port, images)
    assert ours.shape == (4, CLASSES)
    np.testing.assert_allclose(ours, np.asarray(ref), **TOL)


def test_uncached_forward_matches_cached(tied):
    _, _, _, port, images = tied
    np.testing.assert_allclose(
        _port_forward(port, images, cached=False),
        _port_forward(port, images), rtol=1e-5, atol=1e-5)


def test_forward_matches_jax_pallas_model(tied):
    model, params, stats, port, images = tied
    pallas_model = model.clone(use_pallas=True)
    ref = jax.jit(lambda v, x: pallas_model.apply(v, x, train=False))(
        {"params": params, "batch_stats": stats}, jnp.asarray(images[:2]))
    np.testing.assert_allclose(_port_forward(port, images[:2]),
                               np.asarray(ref), **TOL)


def test_train_mode_is_next_slice(tied):
    """Train mode landed with the port's second slice (its parity tests are
    in ``test_torch_train.py``): it takes the domain-stacked
    ``[3, N, H, W, 3]`` batch and returns ``[3, N, K]`` logits; an
    eval-shaped batch raises."""
    _, _, _, port, images = tied
    port = copy.deepcopy(port).train()  # train forwards advance the stats
    with pytest.raises(ValueError, match="domains=3"):
        port(torch.from_numpy(images))
    logits = port(torch.from_numpy(np.stack([images[:2]] * 3)))
    assert logits.shape == (3, 2, CLASSES) and torch.isfinite(logits).all()


def test_merge_split_domains_match_jax():
    x = np.arange(3 * 2 * 5 * 4, dtype=np.float32).reshape(3, 2, 5, 4)
    merged = norms.merge_domains(torch.from_numpy(x))
    np.testing.assert_array_equal(
        merged.numpy(), np.asarray(jax_norms.merge_domains(jnp.asarray(x))))
    np.testing.assert_array_equal(
        norms.split_domains(merged, 3).numpy(),
        np.asarray(jax_norms.split_domains(jnp.asarray(merged.numpy()), 3)))


def test_whiten_cache_refuses_sites_that_disagree():
    model = ResNetDWT.tiny(num_classes=CLASSES)
    # The stem plus layer1_0's dn1, dn2, dn3 and downsample_dn.
    assert len(make_whiten_cache(model)) == 5
    model.layer1_0.dn2.eps = 1e-2
    with pytest.raises(ValueError, match="disagree"):
        make_whiten_cache(model)


def test_padded_head_slices_to_num_classes():
    assert padded_num_classes(65, 0) == 65
    assert padded_num_classes(65, 8) == 72
    model = ResNetDWT.tiny(num_classes=5, pad_classes_to=4).eval()
    assert model.fc_out.out_features == 8
    with torch.inference_mode():
        out = model(torch.zeros(1, SIZE, SIZE, 3))
    assert out.shape == (1, 5)


# ------------------------------------------------------------------ bridge


def _tiny_variables():
    port = ResNetDWT.tiny(num_classes=CLASSES)
    rng = np.random.default_rng(1)
    params, stats = {}, {}
    for name, mod in port.named_modules():
        path = name.split(".") if name else []
        if isinstance(mod, torch.nn.Conv2d):
            o, i, kh, kw = mod.weight.shape
            _set(params, path + ["kernel"], rng.normal(size=(kh, kw, i, o)))
        elif isinstance(mod, torch.nn.Linear):
            _set(params, path + ["kernel"],
                 rng.normal(size=(mod.in_features, mod.out_features)))
            _set(params, path + ["bias"], rng.normal(size=(mod.out_features,)))
        elif hasattr(mod, "gamma"):
            c = mod.features
            _set(params, path + ["gamma"], rng.normal(size=(c,)))
            _set(params, path + ["beta"], rng.normal(size=(c,)))
            if hasattr(mod, "cov"):
                _set(stats, path + ["whitening"], {
                    "mean": rng.normal(size=(3, c)),
                    "cov": rng.normal(size=(3, c // 4, 4, 4))})
            else:
                _set(stats, path + ["bn"], {
                    "mean": rng.normal(size=(3, c)),
                    "var": rng.uniform(1, 2, size=(3, c)),
                    "count": np.arange(3, dtype=np.int32)})
    return port, params, stats


def _set(tree, path, value):
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def test_bridge_conv_hwio_to_oihw():
    port, params, stats = _tiny_variables()
    load_jax_variables(port, params, stats)
    hwio = params["layer1_0"]["conv2"]["kernel"]
    np.testing.assert_array_equal(
        port.layer1_0.conv2.weight.detach().numpy(),
        np.transpose(hwio, (3, 2, 0, 1)).astype(np.float32))
    # Spot-check one element by index: O, I, H, W ← H, W, I, O.
    assert port.conv1.weight[5, 2, 1, 3].item() == pytest.approx(
        params["conv1"]["kernel"][1, 3, 2, 5])


def test_bridge_dense_in_out_to_out_in():
    port, params, stats = _tiny_variables()
    load_jax_variables(port, params, stats)
    np.testing.assert_array_equal(
        port.fc_out.weight.detach().numpy(),
        params["fc_out"]["kernel"].T.astype(np.float32))
    np.testing.assert_array_equal(
        port.fc_out.bias.detach().numpy(),
        params["fc_out"]["bias"].astype(np.float32))


def test_bridge_whitening_and_bn_stats():
    port, params, stats = _tiny_variables()
    load_jax_variables(port, params, stats)
    w = stats["layer1_0"]["dn3"]["whitening"]
    np.testing.assert_array_equal(port.layer1_0.dn3.mean.numpy(),
                                  w["mean"].astype(np.float32))
    np.testing.assert_array_equal(port.layer1_0.dn3.cov.numpy(),
                                  w["cov"].astype(np.float32))
    assert port.layer1_0.dn3.cov.shape == (3, 64, 4, 4)
    bn = stats["layer3_0"]["downsample_dn"]["bn"]
    np.testing.assert_array_equal(port.layer3_0.downsample_dn.var.numpy(),
                                  bn["var"].astype(np.float32))
    np.testing.assert_array_equal(port.layer3_0.downsample_dn.count.numpy(),
                                  bn["count"])
    np.testing.assert_array_equal(port.dn1.gamma.detach().numpy(),
                                  params["dn1"]["gamma"].astype(np.float32))


def test_bridge_missing_leaf_raises():
    port, params, stats = _tiny_variables()
    del params["layer2_0"]["downsample_conv"]
    with pytest.raises(KeyError, match="layer2_0/downsample_conv/kernel"):
        load_jax_variables(port, params, stats)
    port, params, stats = _tiny_variables()
    del stats["dn1"]["whitening"]["cov"]
    with pytest.raises(KeyError, match="dn1/whitening/cov"):
        load_jax_variables(port, params, stats)


def test_bridge_misshaped_and_unused_leaves_raise():
    port, params, stats = _tiny_variables()
    params["conv1"]["kernel"] = params["conv1"]["kernel"][:, :, :, :32]
    with pytest.raises(ValueError, match="conv1/kernel"):
        load_jax_variables(port, params, stats)
    port, params, stats = _tiny_variables()
    params["layer5_0"] = {"conv1": {"kernel": np.zeros((1, 1, 2, 2))}}
    with pytest.raises(ValueError, match="layer5_0/conv1/kernel"):
        load_jax_variables(port, params, stats)
