"""Port parity: train-mode batch norm, the losses, the lr schedule and the
two-group SGD of ``dwt_tpu_torch`` against the live JAX package.

Tolerances: f32 elementwise/reduction results ``rtol=1e-5, atol=1e-6``
(sums in other orders); BN outputs and stats ``rtol=1e-4, atol=1e-5`` (a
one-pass ``E[x²] − m²`` variance cancels bits); the schedule ``rtol=1e-6``
(optax computes it in f32); optimizer trajectories ``rtol=1e-5,
atol=1e-7`` after three steps.
"""

from __future__ import annotations

import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

import dwt_tpu.ops.batch_norm  # noqa: F401  (the module, not the function)
from dwt_tpu.ops import losses as jl
from dwt_tpu.train import optim as jopt
from dwt_tpu_torch.nn import norms
import dwt_tpu_torch.ops.batch_norm  # noqa: F401
from dwt_tpu_torch.ops import losses as tl
from dwt_tpu_torch.train import optim as topt

# ``ops/__init__`` re-exports the function under the module's name.
jbn = sys.modules["dwt_tpu.ops.batch_norm"]
tbn = sys.modules["dwt_tpu_torch.ops.batch_norm"]
TOL = dict(rtol=1e-5, atol=1e-6)
BN_TOL = dict(rtol=1e-4, atol=1e-5)


def _bn_inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(4, 5, 3, 16)) * 2.0 + 1.0).astype(np.float32)
    mean = rng.normal(size=(16,)).astype(np.float32)
    var = rng.uniform(0.5, 2.0, size=(16,)).astype(np.float32)
    return x, mean, var


@pytest.mark.parametrize("momentum", [0.1, None])
def test_batch_norm_train_matches_jax(momentum):
    x, mean, var = _bn_inputs()
    jstats = jbn.BatchNormStats(jnp.asarray(mean), jnp.asarray(var),
                                jnp.asarray(3, jnp.int32))
    tstats = tbn.BatchNormStats(torch.from_numpy(mean), torch.from_numpy(var),
                                torch.tensor(3, dtype=torch.int32))
    ref_y, ref = jbn.batch_norm(jnp.asarray(x), jstats, train=True,
                                momentum=momentum)
    y, new = tbn.batch_norm(torch.from_numpy(x), tstats, train=True,
                            momentum=momentum)
    np.testing.assert_allclose(y.numpy(), np.asarray(ref_y), **BN_TOL)
    np.testing.assert_allclose(new.mean.numpy(), np.asarray(ref.mean), **BN_TOL)
    np.testing.assert_allclose(new.var.numpy(), np.asarray(ref.var), **BN_TOL)
    assert int(new.count) == int(ref.count) == 4
    assert new.mean.dtype == new.var.dtype == torch.float32
    assert new.count.dtype == torch.int32


def test_batch_norm_eval_matches_jax():
    x, mean, var = _bn_inputs(1)
    stats = (mean, var, np.int32(0))
    ref, _ = jbn.batch_norm(jnp.asarray(x), jbn.BatchNormStats(
        *map(jnp.asarray, stats)), train=False)
    y, _ = tbn.batch_norm(torch.from_numpy(x), tbn.BatchNormStats(
        *map(torch.as_tensor, stats)), train=False)
    np.testing.assert_allclose(y.numpy(), np.asarray(ref), **BN_TOL)


def test_domain_batch_norm_site_matches_vmapped_jax():
    """A train-mode DomainBatchNorm: each domain's slice with its own
    branch, the shared affine after — as the Flax site's vmap."""
    d, n, h, w, c = 3, 2, 4, 3, 8
    rng = np.random.default_rng(2)
    x = rng.normal(size=(d, n, h, w, c)).astype(np.float32) + 0.5
    mean = rng.normal(size=(d, c)).astype(np.float32)
    var = rng.uniform(0.5, 2, size=(d, c)).astype(np.float32)
    count = np.array([0, 5, 9], np.int32)
    gamma = rng.normal(size=(c,)).astype(np.float32)
    beta = rng.normal(size=(c,)).astype(np.float32)
    ref_y, ref = jax.vmap(lambda xx, st: jbn.batch_norm(
        xx, st, train=True, momentum=None))(
        jnp.asarray(x), jbn.BatchNormStats(*map(jnp.asarray, (mean, var, count))))
    site = norms.DomainBatchNorm(c, num_domains=d, momentum=None).train()
    with torch.no_grad():
        for name, v in [("mean", mean), ("var", var), ("count", count),
                        ("gamma", gamma), ("beta", beta)]:
            getattr(site, name).copy_(torch.from_numpy(v))
    act = torch.from_numpy(x.reshape(d * n, h, w, c)).permute(0, 3, 1, 2)
    y = site(act).permute(0, 2, 3, 1).reshape(x.shape)
    np.testing.assert_allclose(y.detach().numpy(),
                               np.asarray(ref_y) * gamma + beta, **BN_TOL)
    np.testing.assert_allclose(site.mean.numpy(), np.asarray(ref.mean), **BN_TOL)
    np.testing.assert_allclose(site.var.numpy(), np.asarray(ref.var), **BN_TOL)
    np.testing.assert_array_equal(site.count.numpy(), np.asarray(ref.count))


def _logits(seed=0, n=6, k=5):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, k)) * 3).astype(np.float32)


@pytest.mark.parametrize("name,args", [
    ("entropy_loss", (0,)),
    ("mec_loss", (0, 1)),
])
def test_unlabelled_losses_match_jax(name, args):
    xs = [_logits(s) for s in args]
    ref = getattr(jl, name)(*map(jnp.asarray, xs))
    ours = getattr(tl, name)(*map(torch.from_numpy, xs))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_labelled_losses_match_jax(reduction):
    logits = _logits(3)
    labels = np.array([0, 4, 2, 2, 1, 3])
    logp = np.array(jax.nn.log_softmax(jnp.asarray(logits)))
    pairs = [
        (jl.nll_loss(jnp.asarray(logp), jnp.asarray(labels), reduction),
         tl.nll_loss(torch.from_numpy(logp), torch.from_numpy(labels), reduction)),
        (jl.softmax_cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                  reduction),
         tl.softmax_cross_entropy(torch.from_numpy(logits),
                                  torch.from_numpy(labels), reduction)),
    ]
    for ref, ours in pairs:
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **TOL)
    with pytest.raises(ValueError, match="reduction"):
        tl.nll_loss(torch.from_numpy(logp), torch.from_numpy(labels), "max")


def test_accuracy_and_promotion_match_jax():
    logits, labels = _logits(4), np.array([0, 1, 2, 3, 4, 0])
    assert float(tl.accuracy(torch.from_numpy(logits), torch.from_numpy(labels))) \
        == pytest.approx(float(jl.accuracy(jnp.asarray(logits), jnp.asarray(labels))))
    assert tl.at_least_f32(torch.zeros(2, dtype=torch.bfloat16)).dtype == torch.float32
    assert tl.at_least_f32(torch.zeros(2, dtype=torch.float64)).dtype == torch.float64


def test_multistep_schedule_matches_jax():
    m = 6000
    for milestones in [(m,), (m, 8000)]:
        ref = jopt.multistep_schedule(1e-2, milestones, 0.1)
        ours = topt.multistep_schedule(1e-2, milestones, 0.1)
        for step in [0, m - 2, m - 1, m, m + 1, 7999, 8000]:
            assert ours(step) == pytest.approx(float(ref(step)), rel=1e-6), step
    # Each decay lands one step early (the reference's pre-step call).
    ours = topt.multistep_schedule(1.0, (10,), 0.5)
    assert [ours(s) for s in (8, 9, 10)] == [1.0, 0.5, 0.5]


class _Net(nn.Module):
    """A backbone and an ``fc_out`` head, the two param groups."""

    def __init__(self):
        super().__init__()
        self.body = nn.Linear(4, 3)
        self.fc_out = nn.Linear(3, 2)


def test_sgd_two_group_matches_optax_over_three_steps():
    rng = np.random.default_rng(5)
    net = _Net()
    params = {name: rng.normal(size=tuple(p.shape)).astype(np.float32)
              for name, p in net.named_parameters()}
    with torch.no_grad():
        for name, p in net.named_parameters():
            p.copy_(torch.from_numpy(params[name]))
    grads = [{k: rng.normal(size=v.shape).astype(np.float32)
              for k, v in params.items()} for _ in range(3)]
    cfg = types.SimpleNamespace(lr=0.1, lr_milestones=(2,), lr_gamma=0.5,
                                backbone_lr_scale=0.1, sgd_momentum=0.9,
                                weight_decay=5e-4)
    # JAX: the tree keyed by top-level module, as the Flax param tree is.
    tree = lambda flat: {
        top: {leaf: jnp.asarray(v) for (t, leaf), v in
              ((tuple(k.split(".")), v) for k, v in flat.items()) if t == top}
        for top in ("body", "fc_out")}
    tx = jopt.officehome_tx(cfg)
    jparams = tree(params)
    opt_state = tx.init(jparams)
    optimizer, schedules = topt.officehome_tx(net, cfg)
    assert [len(g["params"]) for g in optimizer.param_groups] == [2, 2]
    for step, g in enumerate(grads):
        updates, opt_state = tx.update(tree(g), opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for name, p in net.named_parameters():
            p.grad = torch.from_numpy(g[name])
        topt.set_learning_rates(optimizer, schedules, step)
        optimizer.step()
    for name, p in net.named_parameters():
        top, leaf = name.split(".")
        np.testing.assert_allclose(p.detach().numpy(),
                                   np.asarray(jparams[top][leaf]),
                                   rtol=1e-5, atol=1e-7)
