"""Port parity: ViT-DWT (``dwt_tpu_torch.nn.vit``) against the live JAX ``dwt_tpu.nn.ViTDWT``.

The model is ``vit_tiny`` (patch 4, 2 blocks, 32 wide, 4 heads; 2
whitened sites — ``dn_patch``, ``blk0.dn`` — and one domain-BN site,
``blk1.dn``) at 16×16 (16 tokens), 4 images per stream, 5 classes.
Weights come from the JAX ``model.init`` with perturbed affines, biases
and LayerNorm parameters, and randomized running stats (SPD covariances,
positive variances), tied into the port through the weight bridge.

Held to JAX: the train forward (logits and every site's advanced stats),
the eval forward through the whiten cache, one MEC train step (losses,
post-step parameters and stats, each parameter's update), the eval and
stat-collection passes of the eval pipelines, the bf16 forwards, the
float64 forwards under ``jax.enable_x64(True)``; and each place where a
plain PyTorch transcription would differ from the Flax model — LayerNorm's
epsilon, the tanh GELU, the token order, ``pos_embed``'s length, where the
whitening sits, the padded head, remat — by a test that fails on the
plain transcription.  Then the trainer's CLI with ``--backbone vit_tiny
--img_crop_size 16`` (8 images per stream) against the JAX CLI's records
from the same initial state, and its checkpoint served by
``ServeEngine``.

Tolerances: f32 logits and stats ``rtol = atol = 1e-4`` (sums in other
orders through the convolution, the matmuls and the Cholesky factors);
losses ``rtol = 1e-4``, parameters after the step ``rtol = 1e-4, atol =
1e-5``, each parameter's update within ``2e-3`` of JAX's (relative, in
norm); float64 ``rtol = atol = 1e-9``; bf16 JAX's bf16 tolerance ``rtol =
atol = 2e-2``, logits relative to their largest magnitude; records as
``tests/test_torch_dispatch.py`` holds them; served logits ``1e-5`` of
their scale from the trainer's eval forward of the same checkpoint.
"""

from __future__ import annotations

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from flax import linen as fnn

from dwt_tpu.cli import officehome as jax_officehome_cli
from dwt_tpu.config import OfficeHomeConfig as JaxOfficeHomeConfig
from dwt_tpu.nn import ViTDWT as JaxViTDWT
from dwt_tpu.train import steps as jsteps
from dwt_tpu.train.evalpipe import EvalPipeline as JaxEvalPipeline
from dwt_tpu.train.evalpipe import make_whiten_cache_fn
from dwt_tpu.train.optim import officehome_tx as jax_officehome_tx
from dwt_tpu.train.state import TrainState as JaxTrainState
from dwt_tpu_torch.cli import officehome
from dwt_tpu_torch.config import OfficeHomeConfig
from dwt_tpu_torch.convert import load_jax_variables
from dwt_tpu_torch.data.datasets import ArrayDataset
from dwt_tpu_torch.nn import DomainBatchNorm, DomainWhiten, ViTDWT, build_backbone
from dwt_tpu_torch.serve.engine import ServeEngine
from dwt_tpu_torch.nn.vit import LN_EPS, LayerNorm
from dwt_tpu_torch.train import loop, steps
from dwt_tpu_torch.train.evalpipe import EvalPipeline, install_whiten_cache, make_whiten_cache
from dwt_tpu_torch.train.optim import officehome_tx
from dwt_tpu_torch.train.state import TrainState
from dwt_tpu_torch.utils import checkpoint as ckpt
from test_torch_backbones import RUN, _jax_config, _jax_init, _padded_twin, _run_both

SIZE, N, CLASSES = 16, 4, 5
TOL = dict(rtol=1e-4, atol=1e-4)
METRIC_TOL = dict(rtol=1e-4)
STATE_TOL = dict(rtol=1e-4, atol=1e-5)
UPDATE_TOL = 2e-3
F64_TOL = dict(rtol=1e-9, atol=1e-9)
BF16_TOL = 2e-2
SERVE_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _randomize(params, stats, rng, dtype=np.float32):
    """Perturbed 1-D leaves (biases, affines, LayerNorm scales); SPD
    covariances, positive variances, small means, nonzero counts."""
    params = jax.tree.map(lambda a: (a + rng.normal(0, 0.1, a.shape)).astype(dtype)
                          if a.ndim == 1 else a.astype(dtype), params)

    def leaf(path, a):
        name = getattr(path[-1], "name", str(path[-1]))
        if name == "cov":
            m = rng.normal(size=a.shape)
            return (m @ np.swapaxes(m, -1, -2) / 4 + 0.5 * np.eye(4)).astype(dtype)
        if name == "var":
            return rng.uniform(0.5, 2.0, size=a.shape).astype(dtype)
        if name == "mean":
            return rng.normal(0.0, 0.2, size=a.shape).astype(dtype)
        if name == "w":  # swbn's tracked matrix: near the identity
            return (np.eye(4) + rng.normal(0.0, 0.05, size=a.shape)).astype(dtype)
        return np.full(a.shape, 3, a.dtype)  # count

    return params, jax.tree_util.tree_map_with_path(leaf, stats)


def _jax_model(**kw):
    return JaxViTDWT.vit_tiny(num_classes=CLASSES, **kw)


@pytest.fixture(scope="module")
def tied():
    """``(params, batch_stats)`` of the JAX vit_tiny, randomized."""
    variables = jax.jit(lambda k: _jax_model().init(
        k, jnp.zeros((3, N, SIZE, SIZE, 3)), train=True))(jax.random.key(0))
    return _randomize(jax.tree.map(np.asarray, variables["params"]),
                      jax.tree.map(np.asarray, variables["batch_stats"]),
                      np.random.default_rng(0))


def _port(params, stats, dtype=None, **kw) -> ViTDWT:
    port = ViTDWT.vit_tiny(num_classes=CLASSES, image_size=SIZE, dtype=dtype, **kw)
    if dtype is torch.float64:
        port = port.double()
    load_jax_variables(port, params, stats)
    return port.to(memory_format=torch.channels_last)


def _images(seed, *lead):
    return np.random.default_rng(seed).normal(size=lead + (SIZE, SIZE, 3)).astype(np.float32)


def _state_of(port) -> dict:
    return {k: v.detach().double().numpy() for k, v in port.state_dict().items()}


def _assert_state_matches(port, params, stats, tol=STATE_TOL, keys=None, **kw):
    ref = _state_of(_port(params, stats, **kw))
    for name, value in _state_of(port).items():
        if keys is None or name in keys:
            np.testing.assert_allclose(value, ref[name], err_msg=name, **tol)


def _stat_keys(port):
    return {k for k in port.state_dict()
            if k.endswith((".mean", ".cov", ".var", ".count", ".w"))}


def test_bridge_ties_every_flax_leaf(tied):
    """Every Flax leaf has a port counterpart of the same scope name — the
    LayerNorms' ``scale`` and the bare ``pos_embed`` included — and a
    leaf missing, extra or of the wrong shape fails loudly."""
    params, stats = tied
    port = _port(params, stats)
    np.testing.assert_array_equal(port.pos_embed.detach().numpy(), params["pos_embed"])
    np.testing.assert_array_equal(port.blk1.ln2.weight.detach().numpy(),
                                  params["blk1"]["ln2"]["scale"])
    np.testing.assert_array_equal(port.blk0.attn_q.weight.detach().numpy(),
                                  params["blk0"]["attn_q"]["kernel"].T)
    missing = copy.deepcopy(params)
    del missing["blk0"]["ln1"]["scale"]
    with pytest.raises(KeyError, match="blk0/ln1/scale"):
        _port(missing, stats)
    extra = copy.deepcopy(params)
    extra["blk0"]["ln1"]["offset"] = np.zeros(32, np.float32)
    with pytest.raises(ValueError, match="match no module"):
        _port(extra, stats)
    wrong = copy.deepcopy(params)
    wrong["pos_embed"] = np.zeros((1, 4, 32), np.float32)
    with pytest.raises(ValueError, match="pos_embed has shape"):
        _port(wrong, stats)


@pytest.mark.parametrize("whitener", ["cholesky", "newton_schulz", "swbn"])
def test_train_forward_and_stats_match_jax(tied, whitener):
    """The train forward's logits and every site's advanced stats, with
    each whitener (swbn's stats carry the tracked matrix ``w``)."""
    params, stats = tied
    if whitener != "cholesky":
        variables = jax.jit(lambda k: _jax_model(whitener=whitener).init(
            k, jnp.zeros((3, N, SIZE, SIZE, 3)), train=True))(jax.random.key(0))
        _, stats = _randomize(jax.tree.map(np.asarray, variables["params"]),
                              jax.tree.map(np.asarray, variables["batch_stats"]),
                              np.random.default_rng(1))
    x = _images(1, 3, N)
    ref, new = jax.jit(lambda p, s, x: _jax_model(whitener=whitener).apply(
        {"params": p, "batch_stats": s}, x, train=True, mutable=["batch_stats"]))(
            params, stats, x)
    port = _port(params, stats, whitener=whitener).train()
    with torch.no_grad():
        ours = port(torch.from_numpy(x)).numpy()
    assert ours.shape == (3, N, CLASSES)
    np.testing.assert_allclose(ours, np.asarray(ref), **TOL)
    _assert_state_matches(port, params, jax.tree.map(np.asarray, new["batch_stats"]),
                          TOL, _stat_keys(port), whitener=whitener)


def test_eval_forward_through_the_whiten_cache_matches_jax(tied):
    params, stats = tied
    x = _images(2, 6)
    cache = make_whiten_cache_fn("cholesky")(stats)
    ref = jax.jit(jsteps.make_serve_forward(_jax_model()))(params, stats, cache, x)
    port = _port(params, stats).eval()
    port_cache = make_whiten_cache(port)
    assert sorted(port_cache) == ["blk0.dn", "dn_patch"]
    install_whiten_cache(port, port_cache)
    with torch.no_grad():
        ours = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(ours, np.asarray(ref), **TOL)


def _batch(seed):
    rng = np.random.default_rng(seed)
    return {"source_x": _images(seed, N), "source_y": rng.integers(0, CLASSES, size=N),
            "target_x": _images(seed + 100, N), "target_aug_x": _images(seed + 200, N)}


def test_mec_train_step_matches_jax(tied):
    """One MEC step through the port's step and JAX's: losses, every
    parameter and running stat after the step, each parameter's update."""
    params, stats = tied
    tx = jax_officehome_tx(JaxOfficeHomeConfig())
    jparams = jax.tree.map(jnp.asarray, params)
    state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=jparams,
                          batch_stats=jax.tree.map(jnp.asarray, stats),
                          opt_state=tx.init(jparams))
    batch = _batch(3)
    new_state, ref = jax.jit(jsteps.make_officehome_train_step(_jax_model(), tx, 0.1))(
        state, jax.tree.map(jnp.asarray, batch))
    port = _port(params, stats)
    optimizer, schedules = officehome_tx(port, OfficeHomeConfig())
    metrics = steps.make_officehome_train_step(port, 0.1)(
        TrainState(port, optimizer, schedules),
        {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()})
    for key in ("loss", "cls_loss", "mec_loss", "grad_norm"):
        np.testing.assert_allclose(float(metrics[key]), float(ref[key]), err_msg=key,
                                   **METRIC_TOL)
    new_params = jax.tree.map(np.asarray, new_state.params)
    new_stats = jax.tree.map(np.asarray, new_state.batch_stats)
    _assert_state_matches(port, new_params, new_stats)
    before = dict(_port(params, stats).named_parameters())
    after = dict(_port(new_params, new_stats).named_parameters())
    for name, p in port.named_parameters():
        ref_step = (after[name] - before[name]).detach().double()
        err = float(((p - before[name]).detach().double() - ref_step).norm()
                    / ref_step.norm())
        assert err <= UPDATE_TOL, (name, err)


def test_two_group_sgd_splits_the_vit_as_jax_labels_it(tied):
    """The port's two parameter groups are the ones JAX's ``label_fn``
    gives a ViT: read off ``officehome_tx``'s optax state, where each
    group's momentum holds its own leaves and masks the other's."""
    import optax

    params, stats = tied
    opt_state = jax_officehome_tx(JaxOfficeHomeConfig()).init(
        jax.tree.map(jnp.asarray, params))
    partition = next(s for s in opt_state if hasattr(s, "inner_states"))
    flax_leaf = {"kernel": "weight", "scale": "weight"}
    ref = {}
    for group, masked in partition.inner_states.items():
        trace = next(s for s in masked.inner_state if isinstance(s, optax.TraceState)).trace
        for path, leaf in jax.tree_util.tree_leaves_with_path(
                trace, is_leaf=lambda x: isinstance(x, optax.MaskedNode)):
            if not isinstance(leaf, optax.MaskedNode):
                keys = [k.key for k in path]
                ref[".".join(keys[:-1] + [flax_leaf.get(keys[-1], keys[-1])])] = group
    port = _port(params, stats)
    optimizer, _ = officehome_tx(port, OfficeHomeConfig())
    head = {id(p) for p in optimizer.param_groups[0]["params"]}
    ours = {name: "head" if id(p) in head else "backbone"
            for name, p in port.named_parameters()}
    assert ours == ref
    assert sorted(n for n, g in ours.items() if g == "head") == ["fc_out.bias",
                                                                 "fc_out.weight"]


def test_eval_and_collection_passes_match_jax(tied):
    """The eval pipelines' eval pass (7 images at a test batch of 4: a
    padded ragged tail) and one stat-collection pass."""
    params, stats = tied
    rng = np.random.default_rng(5)
    x = _images(5, 7)
    y = rng.integers(0, CLASSES, size=7)
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32),
                           params=jax.tree.map(jnp.asarray, params),
                           batch_stats=jax.tree.map(jnp.asarray, stats), opt_state=None)
    jpipe = JaxEvalPipeline(lambda axis_name=None: _jax_model(), 4, num_domains=3)
    ref = jpipe.evaluate(jstate, ArrayDataset(x, y))
    collected = jpipe.collect_stats(jstate, ArrayDataset(x, y))
    port = _port(params, stats)
    pipe = EvalPipeline(4, torch.device("cpu"), num_domains=3)
    ours = pipe.evaluate(TrainState(port, None, ()), ArrayDataset(x, y))
    assert ours["count"] == ref["count"] == 7 and ours["forwards"] == 2
    assert ours["accuracy"] == ref["accuracy"]
    np.testing.assert_allclose(ours["loss"], ref["loss"], **METRIC_TOL)
    assert port.dn_patch.eval_matrix is None  # the pass's cache is uninstalled
    pipe.collect_stats(TrainState(port, None, ()), ArrayDataset(x, y))
    _assert_state_matches(port, params, jax.tree.map(np.asarray, collected.batch_stats),
                          TOL, _stat_keys(port))


def test_bf16_forwards_match_jax_within_bf16(tied):
    """bf16 compute from f32 parameters: the train forward's logits and
    the eval forward's, and the f32 running stats, within bf16's
    tolerance of JAX's bf16 model."""
    params, stats = tied
    x = _images(6, 3, N)
    model = _jax_model(dtype=jnp.bfloat16)
    ref, new = jax.jit(lambda p, s, x: model.apply(
        {"params": p, "batch_stats": s}, x, train=True, mutable=["batch_stats"]))(
            params, stats, x)
    cache = make_whiten_cache_fn("cholesky")(stats)
    ref_eval = jax.jit(jsteps.make_serve_forward(model))(params, stats, cache, x[0])
    port = _port(params, stats, dtype=torch.bfloat16).train()
    with torch.no_grad():
        ours = port(torch.from_numpy(x))
    assert ours.dtype == torch.bfloat16
    assert {p.dtype for p in port.parameters()} == {torch.float32}
    ref = np.asarray(ref.astype(jnp.float32))
    assert np.abs(ours.float().numpy() - ref).max() <= BF16_TOL * np.abs(ref).max()
    _assert_state_matches(port, params, jax.tree.map(np.asarray, new["batch_stats"]),
                          dict(rtol=BF16_TOL, atol=BF16_TOL), _stat_keys(port))
    port = _port(params, stats, dtype=torch.bfloat16).eval()
    install_whiten_cache(port, {k: w.to(torch.bfloat16).float()
                                for k, w in make_whiten_cache(port).items()})
    with torch.no_grad():
        ours_eval = port(torch.from_numpy(x[0])).float().numpy()
    ref_eval = np.asarray(ref_eval.astype(jnp.float32))
    assert np.abs(ours_eval - ref_eval).max() <= BF16_TOL * np.abs(ref_eval).max()


def test_train_and_eval_match_jax_in_f64():
    variables = jax.jit(lambda k: _jax_model().init(
        k, jnp.zeros((3, N, SIZE, SIZE, 3)), train=True))(jax.random.key(1))
    params, stats = _randomize(jax.tree.map(np.asarray, variables["params"]),
                               jax.tree.map(np.asarray, variables["batch_stats"]),
                               np.random.default_rng(7), np.float64)
    x = _images(7, 3, N).astype(np.float64)
    with jax.enable_x64(True):
        model = _jax_model(dtype=jnp.float64)
        ref, new = model.apply({"params": params, "batch_stats": stats}, x,
                               train=True, mutable=["batch_stats"])
        ref_eval = model.apply({"params": params, "batch_stats": stats}, x[0],
                               train=False)
        ref, ref_eval = np.asarray(ref), np.asarray(ref_eval)
        new = jax.tree.map(np.asarray, new["batch_stats"])
    assert ref.dtype == np.float64
    port = _port(params, stats, torch.float64)
    with torch.no_grad():
        ours_eval = port.eval()(torch.from_numpy(x[0])).numpy()
        ours = port.train()(torch.from_numpy(x)).numpy()
    assert ours.dtype == np.float64
    np.testing.assert_allclose(ours_eval, ref_eval, **F64_TOL)
    np.testing.assert_allclose(ours, ref, **F64_TOL)
    ref_port = _port(params, new, torch.float64).state_dict()
    for name in _stat_keys(port):
        np.testing.assert_allclose(port.state_dict()[name].numpy(),
                                   ref_port[name].numpy(), err_msg=name, **F64_TOL)


# ------------------------------------------------------------------ traps


def _flax_layer_norm(x, scale, bias, dtype=None):
    ln = fnn.LayerNorm(dtype=dtype)
    return np.asarray(ln.apply({"params": {"scale": scale, "bias": bias}}, x))


def test_layer_norm_is_flax_layer_norm_with_its_epsilon():
    """Tokens of variance ~1e-6, where the epsilon matters: the port's
    LayerNorm (1e-6) matches Flax's; torch's default 1e-5 does not."""
    rng = np.random.default_rng(8)
    x = (rng.normal(size=(2, 5, 32)) * 1e-3).astype(np.float32)
    scale = rng.normal(1.0, 0.1, size=32).astype(np.float32)
    bias = rng.normal(0.0, 0.1, size=32).astype(np.float32)
    ref = _flax_layer_norm(x, scale, bias)
    ln = LayerNorm(32)
    assert LN_EPS == ln.eps == 1e-6
    with torch.no_grad():
        ln.weight.copy_(torch.from_numpy(scale))
        ln.bias.copy_(torch.from_numpy(bias))
        ours = ln(torch.from_numpy(x)).numpy()
        torch_default = F.layer_norm(torch.from_numpy(x), (32,), ln.weight, ln.bias).numpy()
    np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=1e-4)
    assert np.abs(torch_default - ref).max() > 0.1
    # A bf16 input: f32 statistics, the result in bf16, as Flax's dtype=bf16.
    xb = torch.from_numpy(x).to(torch.bfloat16)
    with torch.no_grad():
        yb = ln(xb)
    assert yb.dtype == torch.bfloat16
    ref_b = _flax_layer_norm(jnp.asarray(xb.float().numpy(), jnp.bfloat16), scale, bias,
                             jnp.bfloat16).astype(np.float32)
    np.testing.assert_allclose(yb.float().numpy(), ref_b, rtol=BF16_TOL, atol=BF16_TOL)


def test_gelu_is_the_tanh_approximation():
    x = np.linspace(-4.0, 4.0, 801)
    ref = np.asarray(fnn.gelu(jnp.asarray(x, jnp.float32)))
    t = torch.from_numpy(x).float()
    np.testing.assert_allclose(F.gelu(t, approximate="tanh").numpy(), ref, rtol=1e-6,
                               atol=1e-6)
    assert np.abs(F.gelu(t).numpy() - ref).max() > 1e-4  # the exact GELU


def test_tokens_are_row_major_and_a_view():
    """The patch conv's channels_last output permuted to ``[B, H', W', C]``
    is contiguous, and its tokens (``dn_patch``'s input less ``pos_embed``)
    are JAX's row-major (h, w) order; the column-major order is not."""
    rng = np.random.default_rng(9)
    port = build_backbone("vit_tiny", num_classes=CLASSES, image_size=SIZE, seed=0)
    port = port.to(memory_format=torch.channels_last).eval()
    seen = {}
    port.conv_patch.register_forward_hook(lambda m, a, out: seen.update(conv=out))
    port.dn_patch.register_forward_pre_hook(lambda m, a: seen.update(tokens=a[0]))
    x = rng.normal(size=(2, SIZE, SIZE, 3)).astype(np.float32)
    with torch.no_grad():
        port(torch.from_numpy(x))
    nhwc = seen["conv"].permute(0, 2, 3, 1)
    assert nhwc.is_contiguous()
    assert nhwc.reshape(2, -1, 32).data_ptr() == seen["conv"].data_ptr()
    kernel = port.conv_patch.weight.detach().permute(2, 3, 1, 0).numpy()
    conv = fnn.Conv(32, (4, 4), strides=(4, 4), use_bias=False)
    ref = np.asarray(conv.apply({"params": {"kernel": kernel}}, x))  # [2, 4, 4, 32]
    tokens = (seen["tokens"] - port.pos_embed).detach().numpy()
    np.testing.assert_allclose(tokens, ref.reshape(2, -1, 32), rtol=1e-5, atol=1e-5)
    column_major = ref.transpose(0, 2, 1, 3).reshape(2, -1, 32)
    assert np.abs(tokens - column_major).max() > 1e-2


def test_pos_embed_length_is_fixed_by_the_image_size():
    port = build_backbone("vit_tiny", num_classes=CLASSES, image_size=SIZE, seed=0).eval()
    assert port.pos_embed.shape == (1, 16, 32)
    assert build_backbone("vit_dwt", image_size=224).pos_embed.shape == (1, 196, 384)
    with pytest.raises(ValueError, match="pos_embed holds 16"):
        port(torch.zeros(1, 20, 20, 3))
    with pytest.raises(ValueError, match="divisible by patch_size=4"):
        port(torch.zeros(1, 18, 18, 3))
    with pytest.raises(ValueError, match="not divisible"):
        build_backbone("vit_tiny", image_size=18)
    with pytest.raises(ValueError, match="domains=3"):
        port.train()(torch.zeros(2, 16, 16, 3))


def _site_kinds(port):
    return {n: type(m).__name__ for n, m in port.named_modules()
            if isinstance(m, (DomainWhiten, DomainBatchNorm))}


@pytest.mark.parametrize("name", ["vit_dwt", "vit_tiny"])
def test_whitening_sits_where_jax_puts_it(name):
    """The patch embed and the first max(1, depth // 4) blocks whiten, the
    rest are domain BN: vit_dwt 4 + 9 sites, vit_tiny 2 + 1 — JAX's
    ``whitening`` and ``bn`` collections, site for site."""
    jmodel = getattr(JaxViTDWT, name)(num_classes=CLASSES)
    size = 32 if name == "vit_dwt" else SIZE
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.key(0), jnp.zeros((3, 1, size, size, 3)), train=True))["batch_stats"]
    ref = {}
    for path, _ in jax.tree_util.tree_leaves_with_path(shapes):
        keys = [getattr(k, "key", str(k)) for k in path]
        kind = next(k for k in keys if k in ("whitening", "bn"))
        ref[".".join(keys[:keys.index(kind)])] = ("DomainWhiten" if kind == "whitening"
                                                 else "DomainBatchNorm")
    ours = _site_kinds(build_backbone(name, num_classes=CLASSES, image_size=size))
    assert ours == ref
    whitened = sum(v == "DomainWhiten" for v in ours.values())
    assert (whitened, len(ours) - whitened) == {"vit_dwt": (4, 9), "vit_tiny": (2, 1)}[name]


def test_padded_head_is_the_unpadded_head_bitwise(tied):
    """``pad_classes_to=4``: an 8-wide ``fc_out`` sliced to 5 classes.
    With the unpadded head's weights in its first rows, train logits and
    a train step's losses are bitwise the unpadded model's, and the
    eval logits match JAX's padded model."""
    params, stats = tied
    plain = _port(params, stats)
    padded = _padded_twin(plain, "vit_tiny", num_classes=CLASSES, image_size=SIZE)
    assert padded.fc_out.out_features == 8
    x = torch.from_numpy(_images(10, 3, N))
    with torch.no_grad():
        assert torch.equal(plain.train()(x), padded.train()(x))
    batch = {k: torch.from_numpy(np.asarray(v)) for k, v in _batch(11).items()}
    metrics = []
    for m in (copy.deepcopy(plain), copy.deepcopy(padded)):
        optimizer, schedules = officehome_tx(m, OfficeHomeConfig())
        metrics.append(steps.make_officehome_train_step(m, 0.1)(
            TrainState(m, optimizer, schedules), batch))
    assert all(float(metrics[0][k]) == float(metrics[1][k]) for k in metrics[0])
    # JAX's padded head: the unpadded kernel with 3 zero columns.
    jparams = copy.deepcopy(params)
    jparams["fc_out"] = {"kernel": np.pad(params["fc_out"]["kernel"], ((0, 0), (0, 3))),
                         "bias": np.pad(params["fc_out"]["bias"], (0, 3))}
    cache = make_whiten_cache_fn("cholesky")(stats)
    ref = jax.jit(jsteps.make_serve_forward(_jax_model(pad_classes_to=4)))(
        jparams, stats, cache, x[0].numpy())
    port = _port(jparams, stats, pad_classes_to=4).eval()
    install_whiten_cache(port, make_whiten_cache(port))
    with torch.no_grad():
        ours = port(x[0]).numpy()
    assert ours.shape == (N, CLASSES)
    np.testing.assert_allclose(ours, np.asarray(ref), **TOL)


def test_remat_step_equals_the_plain_step(tied):
    """``remat=True`` recomputes each block in the backward: the same
    losses, gradients and parameters after the step, and the running
    stats advanced once, bitwise as without."""
    params, stats = tied
    batch = {k: torch.from_numpy(np.asarray(v)) for k, v in _batch(12).items()}
    out = []
    for remat in (False, True):
        port = _port(params, stats, remat=remat)
        optimizer, schedules = officehome_tx(port, OfficeHomeConfig())
        metrics = steps.make_officehome_train_step(port, 0.1)(
            TrainState(port, optimizer, schedules), batch)
        out.append((metrics, port))
    (m0, p0), (m1, p1) = out
    for key in ("loss", "cls_loss", "mec_loss", "grad_norm"):
        np.testing.assert_allclose(float(m1[key]), float(m0[key]), rtol=1e-6, err_msg=key)
    for name in _stat_keys(p0):
        assert torch.equal(p0.state_dict()[name], p1.state_dict()[name]), name
    for (name, a), b in zip(p0.named_parameters(), p1.parameters()):
        torch.testing.assert_close(b.detach(), a.detach(), rtol=1e-6, atol=1e-6, msg=name)


def test_fresh_init_follows_the_flax_initializers():
    """Seeded: the same seed gives the same weights; dense layers
    lecun-normal (std sqrt(1/fan_in)) with zero biases, LayerNorms γ = 1
    and β = 0, ``pos_embed`` N(0, 0.02²), the patch conv kaiming-normal
    fan_out."""
    a = build_backbone("vit_dwt", seed=3).requires_grad_(False)
    b = build_backbone("vit_dwt", seed=3)
    assert all(torch.equal(v, b.state_dict()[k]) for k, v in a.state_dict().items())
    assert not torch.equal(a.pos_embed, build_backbone("vit_dwt", seed=4).pos_embed)
    assert float(a.pos_embed.std()) == pytest.approx(0.02, rel=0.05)
    assert float(a.blk3.mlp_fc1.weight.std()) == pytest.approx(384 ** -0.5, rel=0.05)
    assert float(a.blk3.mlp_fc2.weight.std()) == pytest.approx(1536 ** -0.5, rel=0.05)
    fan_out = 384 * 16 * 16
    assert float(a.conv_patch.weight.std()) == pytest.approx((2 / fan_out) ** 0.5, rel=0.05)
    assert not a.blk0.attn_q.bias.any() and not a.fc_out.bias.any()
    assert torch.equal(a.ln_out.weight, torch.ones(384)) and not a.blk5.ln1.bias.any()


def test_token_sites_take_views_and_refuse_other_layouts():
    """A train site gets the merged ``[D·N, L, C]`` tokens as ``[D, N·L,
    C]`` rows without a copy (the kernels' operand); a non-contiguous token
    tensor fails there, in train and eval, instead of being copied."""
    site = DomainWhiten(32, 4, num_domains=3)
    seen = {}
    original = site._train
    site._train = lambda x3: seen.update(x3=x3) or original(x3)
    tokens = torch.randn(3 * 2, 16, 32)
    site.train()(tokens)
    assert seen["x3"].shape == (3, 2 * 16, 32)
    assert seen["x3"].data_ptr() == tokens.data_ptr()
    torch.testing.assert_close(seen["x3"][1], tokens[2:4].reshape(-1, 32))
    strided = torch.randn(3 * 2, 32, 16).transpose(1, 2)
    with pytest.raises(RuntimeError, match="view"):
        site.train()(strided)
    with pytest.raises(RuntimeError, match="view"):
        site.eval()(strided[:2])


# -------------------------------------------------------------------- CLI


VIT_ARGS = RUN + ["--backbone", "vit_tiny", "--img_crop_size", "16", "--num_classes", "5"]


def test_vit_cli_trains_as_the_jax_loop_and_its_checkpoint_serves(tmp_path):
    """``--backbone vit_tiny --img_crop_size 16`` through both CLIs'
    parsers: the port's records are JAX's; the trainer's checkpoint
    restores into ``ServeEngine``, which serves the trainer's eval
    logits."""
    jax_cfg = _jax_config(jax_officehome_cli.build_parser(), VIT_ARGS)
    port_cfg = officehome.config_from_args(officehome.build_parser().parse_args(
        VIT_ARGS + ["--device", "cpu", "--ckpt_dir", str(tmp_path),
                    "--ckpt_every_iters", "2", "--no-async_ckpt"]))
    assert port_cfg.backbone == jax_cfg.backbone == "vit_tiny"
    built = loop.build_model(port_cfg)
    assert isinstance(built, ViTDWT) and built.pos_embed.shape == (1, 16, 32)
    variables = _jax_init(JaxViTDWT.vit_tiny(num_classes=5), jax_cfg)
    model = load_jax_variables(ViTDWT.vit_tiny(num_classes=5, image_size=16),
                               jax.tree.map(np.asarray, variables["params"]),
                               jax.tree.map(np.asarray, variables["batch_stats"]))
    _run_both(jax_cfg, port_cfg, model)

    images = np.random.default_rng(4).normal(size=(8, 16, 16, 3)).astype(np.float32)
    engine = ServeEngine.from_checkpoint(
        str(tmp_path), build_backbone("vit_tiny", num_classes=5, image_size=16),
        (16, 16, 3), buckets=(1, 8), device="cpu")
    assert engine.step == 2
    trainer = build_backbone("vit_tiny", num_classes=5, image_size=16)
    state = TrainState(trainer, *officehome_tx(trainer, port_cfg))
    ckpt.restore_state(str(tmp_path), state)
    trainer = trainer.to(memory_format=torch.channels_last).eval()
    install_whiten_cache(trainer, make_whiten_cache(trainer))
    with torch.no_grad():
        expect = trainer(torch.from_numpy(images)).numpy()
    for n in (1, 8):
        got = engine.infer(images[:n])
        assert got.shape == (n, 5)
        assert np.abs(got - expect[:n]).max() <= SERVE_TOL * np.abs(expect[:n]).max()
