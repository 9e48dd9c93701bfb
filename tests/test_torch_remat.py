"""``--remat``: a rematerialized ResNet-DWT train step against the plain one, on the CPU.

``ResNetDWT(remat=True)`` runs each bottleneck under
``torch.utils.checkpoint`` (``nn.norms.remat``), whose backward runs the
block's forward again.  The norm sites update their running stats in
place, so the recompute must neither advance them a second time nor read
the advanced ones (SWBN's tracked matrix above all).  Held here: from the
same weights, stats and batch, a remat step and a plain step of the tiny
ResNet-DWT (one block per stage, 2 images per stream at 32²) give bitwise
equal running stats, and loss and every gradient within ``1e-6``
(relative to the gradient's norm), with the Cholesky and the SWBN
whitener, in f32 and in bf16; the recompute really runs (the whitened
sites of the checkpointed blocks compute their moments twice), and a
no-grad or eval forward does not checkpoint.  The JAX counterpart is
``flax.linen.remat`` around each ``BottleneckDWT`` (``dwt_tpu/nn/
resnet.py``), which re-runs its whitening too.
"""

from __future__ import annotations

import copy

import pytest
import torch

from dwt_tpu_torch.config import OfficeHomeConfig
from dwt_tpu_torch.nn.resnet import build_resnet
from dwt_tpu_torch.ops import cuda_whitening
from dwt_tpu_torch.train.optim import officehome_tx
from dwt_tpu_torch.train.state import TrainState
from dwt_tpu_torch.train.steps import make_officehome_train_step

TOL = 1e-6
SITES = 5  # tiny ResNet-DWT's whitened sites: the stem and stage 1's four
STAGE1_SITES = 4  # those inside the checkpointed stage-1 block


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _batch(seed=0):
    g = torch.Generator().manual_seed(seed)
    x = lambda: torch.randn(2, 32, 32, 3, generator=g)
    return {"source_x": x(), "source_y": torch.tensor([0, 3]),
            "target_x": x(), "target_aug_x": x()}


def _step(model, counts):
    """One OfficeHome step of ``model``; returns its metrics and its
    gradients, and counts the moments calls in ``counts``."""
    optimizer, schedules = officehome_tx(model, OfficeHomeConfig())
    state = TrainState(model, optimizer, schedules)
    real = cuda_whitening.whiten_moments

    def counted(x, g):
        counts.append(1)
        return real(x, g)

    cuda_whitening.whiten_moments = counted
    try:
        metrics = make_officehome_train_step(model)(state, _batch())
    finally:
        cuda_whitening.whiten_moments = real
    return metrics, {n: p.grad.clone() for n, p in model.named_parameters()}


@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
@pytest.mark.parametrize("whitener", ["cholesky", "swbn"])
def test_remat_step_equals_the_plain_step(whitener, dtype):
    plain = build_resnet("tiny", num_classes=4, seed=1, whitener=whitener, dtype=dtype)
    plain.to(memory_format=torch.channels_last)
    if whitener == "swbn":  # tracked matrices off the identity
        g = torch.Generator().manual_seed(2)
        for site in (plain.dn1, plain.layer1_0.dn2):
            site.w.add_(0.05 * torch.randn(site.w.shape, generator=g))
    remat = copy.deepcopy(plain)
    remat.remat = True
    counts_plain, counts_remat = [], []
    m_plain, g_plain = _step(plain, counts_plain)
    m_remat, g_remat = _step(remat, counts_remat)
    assert len(counts_plain) == SITES
    assert len(counts_remat) == SITES + STAGE1_SITES  # the recompute ran
    stats_plain, stats_remat = plain.state_dict(), remat.state_dict()
    for name, value in stats_plain.items():
        if not name.endswith(("weight", "bias", "gamma", "beta")):
            assert torch.equal(stats_remat[name], value), name
    for key in ("loss", "cls_loss", "mec_loss", "grad_norm"):
        torch.testing.assert_close(m_remat[key], m_plain[key], rtol=TOL, atol=0)
    for name, grad in g_plain.items():
        err = float((g_remat[name] - grad).norm())
        assert err <= TOL * max(float(grad.norm()), 1e-12), (name, err)
    # The updated parameters follow from equal gradients.
    for (name, p), q in zip(plain.named_parameters(), remat.parameters()):
        torch.testing.assert_close(q, p, rtol=TOL, atol=TOL, msg=name)


def test_remat_checkpoints_only_a_train_forward_with_grad():
    """Stat collection (train mode, no grad) and eval run each block once:
    the moments of a collection forward are the plain model's, bitwise."""
    plain = build_resnet("tiny", num_classes=4, seed=1)
    remat = build_resnet("tiny", num_classes=4, seed=1, remat=True)
    x = torch.randn(3, 2, 32, 32, 3, generator=torch.Generator().manual_seed(3))
    for model in (plain, remat):
        model.to(memory_format=torch.channels_last).train()
        with torch.no_grad():
            model(x)
    assert all(torch.equal(a, b) for a, b in zip(plain.state_dict().values(),
                                                 remat.state_dict().values()))
    plain.eval(), remat.eval()
    with torch.no_grad():
        assert torch.equal(plain(x[0]), remat(x[0]))
