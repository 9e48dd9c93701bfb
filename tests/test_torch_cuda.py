"""The port's CUDA kernels on the card, and their CPU-side dispatch.

Tests marked ``cuda`` need a GPU and skip without one; run them on a
machine with the card (no JAX needed there; ``--noconftest`` skips the
repository's conftest, which imports JAX)::

    python -m pytest --noconftest tests/test_torch_cuda.py -q

The whitening-apply kernel (one launch for the D domains of ``x [D, M,
C]``, or for one ``x [M, C]``) is held to its plain PyTorch version on the
same device, ``rtol = atol = 1e-5`` (both sum 4 products per output, in
different orders); two calls, calls at other grid sizes, and replays of a
CUDA graph that captured one, are bitwise equal.  The moments kernel (one launch for the D
domains of ``x [D, M, C]``) is held to its plain version and to a float64
two-pass computation of each domain: mean ``rtol = atol = 1e-6``, cov
``rtol = 1e-4, atol = 1e-5`` (f32 sums in another order); two calls, and
replays of a CUDA graph that captured one, are bitwise equal.  The data
plane's ``prefetch_to_device`` delivers batches on the card bitwise equal
to their numpy sources, through its reused pinned buffers and when closed
mid-stream.  A one-replica fleet serving on the card leaves the
balancer process without a CUDA context (no ``/dev/nvidia*`` descriptor
open, where the replica has one).  The CPU-side
tests check the dispatch rules: a CPU tensor takes the plain version,
any other device raises, and ``chip_smoke.py`` refuses to run without
CUDA.
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from dwt_tpu_torch.ops import cuda_whitening
from dwt_tpu_torch.ops.whitening import _shrink, whitening_matrix

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel runs only on the card")
    return torch.device("cuda")


def _args(c=64, m=1000, device="cpu", seed=0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(1.0, 2.0, size=(m, c)).astype(np.float32))
    mean = torch.from_numpy(rng.normal(0.0, 0.5, size=(c,)).astype(np.float32))
    a = rng.normal(size=(c // 4, 4, 4))
    cov = torch.from_numpy((a @ np.swapaxes(a, -1, -2) / 4 + 0.5 * np.eye(4))
                           .astype(np.float32))
    w = whitening_matrix(_shrink(cov, 1e-3))
    return x.to(device), mean.to(device), w.to(device)


def test_cpu_tensor_takes_plain_version_without_launch():
    x, mean, w = _args()
    before = cuda_whitening.apply_launches
    y = cuda_whitening.whiten_apply(x, mean, w)
    assert cuda_whitening.apply_launches == before
    torch.testing.assert_close(y, cuda_whitening.whiten_apply_plain(x, mean, w),
                               rtol=0, atol=0)
    # The plain version is the block-diagonal product.
    ref = (x - mean) @ torch.block_diag(*w).T
    torch.testing.assert_close(y, ref, **TOL)


def test_other_devices_raise():
    x, mean, w = _args(device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_whitening.whiten_apply(x, mean, w)


def test_chip_smoke_refuses_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the no-CUDA exit; this machine has a GPU")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


@pytest.mark.cuda
@pytest.mark.parametrize("c,m", [(64, 1000), (256, 1000), (64, 37), (256, 4096)])
def test_kernel_matches_plain(cuda_device, c, m):
    x, mean, w = _args(c, m, device=cuda_device)
    before = cuda_whitening.apply_launches
    y = cuda_whitening.whiten_apply(x, mean, w)
    torch.cuda.synchronize()
    assert cuda_whitening.apply_launches == before + 1
    torch.testing.assert_close(y, cuda_whitening.whiten_apply_plain(x, mean, w),
                               **TOL)


@pytest.mark.cuda
def test_kernel_reads_a_channels_last_activation_in_place(cuda_device):
    act = torch.randn(2, 64, 9, 7, device=cuda_device).contiguous(
        memory_format=torch.channels_last)
    x2d = act.permute(0, 2, 3, 1).view(-1, 64)  # no copy
    assert x2d.data_ptr() == act.data_ptr()
    _, mean, w = _args(device=cuda_device)
    torch.testing.assert_close(cuda_whitening.whiten_apply(x2d, mean, w),
                               cuda_whitening.whiten_apply_plain(x2d, mean, w),
                               **TOL)


@pytest.mark.cuda
def test_wrapper_rejects_bad_group_size(cuda_device):
    """A group size that does not divide C raises; g = 8, 16 and 48 (C =
    48) launch the kernel."""
    x, mean, _ = _args(device=cuda_device)
    w24 = torch.eye(24, device=cuda_device).repeat(2, 1, 1)  # 2 × 24 ≠ 64
    with pytest.raises(ValueError, match="group size"):
        cuda_whitening.whiten_apply(x, mean, w24)
    for c, g in ((64, 8), (64, 16), (48, 48)):
        x, mean, _ = _args(c, device=cuda_device)
        w = torch.eye(g, device=cuda_device).repeat(c // g, 1, 1)
        before = cuda_whitening.apply_launches
        y = cuda_whitening.whiten_apply(x, mean, w)
        assert cuda_whitening.apply_launches == before + 1
        torch.testing.assert_close(y, x - mean, **TOL)


@pytest.mark.cuda
def test_wrapper_rejects_non_contiguous(cuda_device):
    x, mean, w = _args(device=cuda_device)
    strided = torch.cat([x, x], dim=1)[:, ::2]  # an [M, C] view, not dense
    with pytest.raises(ValueError, match="contiguous"):
        cuda_whitening.whiten_apply(strided, mean, w)


@pytest.mark.cuda
def test_wrapper_rejects_non_f32(cuda_device):
    x, mean, w = _args(device=cuda_device)
    with pytest.raises(TypeError, match="float32"):
        cuda_whitening.whiten_apply(x.half(), mean, w)
    with pytest.raises(TypeError, match="float32"):
        cuda_whitening.whiten_apply(x.double(), mean.double(), w.double())


@pytest.mark.cuda
def test_wrapper_rejects_device_mismatch(cuda_device):
    x, mean, w = _args(device=cuda_device)
    with pytest.raises(ValueError, match="mean is on cpu"):
        cuda_whitening.whiten_apply(x, mean.cpu(), w)


def test_cpu_apply_writes_into_out():
    x, mean, w = _args()
    out = torch.empty(2, *x.shape)
    y = cuda_whitening.whiten_apply(x, mean, w, out=out[1])
    assert y.data_ptr() == out[1].data_ptr()
    torch.testing.assert_close(out[1], cuda_whitening.whiten_apply_plain(x, mean, w),
                               rtol=0, atol=0)


@pytest.mark.cuda
def test_kernel_writes_into_a_slice_of_out(cuda_device):
    x, mean, w = _args(device=cuda_device)
    out = torch.zeros(3, *x.shape, device=cuda_device)
    cuda_whitening.whiten_apply(x, mean, w, out=out[1])
    torch.cuda.synchronize()
    torch.testing.assert_close(out[1], cuda_whitening.whiten_apply_plain(x, mean, w),
                               **TOL)
    assert not out[0].any() and not out[2].any()


MEAN_TOL = dict(rtol=1e-6, atol=1e-6)
COV_TOL = dict(rtol=1e-4, atol=1e-5)


def _two_pass_f64(x):
    x = x.double()
    mean = x.mean(dim=0)
    t = (x - mean).view(x.shape[0], -1, 4)
    return mean, torch.einsum("mgc,mgd->gcd", t, t) / x.shape[0]


@pytest.mark.cuda
@pytest.mark.parametrize("c,m,offset", [
    (64, 1000, 0.0), (256, 1000, 0.0), (64, 7, 0.0), (256, 56448, 0.0),
    (64, 225792, 0.0), (256, 4096, 5.0),
])
def test_moments_kernel_matches_plain_and_two_pass(cuda_device, c, m, offset):
    x, _, _ = _args(c, m, device=cuda_device)
    x = x + offset
    before = cuda_whitening.moments_launches
    mean, cov = cuda_whitening.whiten_moments(x, 4)
    torch.cuda.synchronize()
    assert cuda_whitening.moments_launches == before + 1
    p_mean, p_cov = cuda_whitening.whiten_moments_plain(x, 4)
    r_mean, r_cov = _two_pass_f64(x)
    torch.testing.assert_close(mean, p_mean, **MEAN_TOL)
    torch.testing.assert_close(cov, p_cov, **COV_TOL)
    torch.testing.assert_close(mean.double(), r_mean, **MEAN_TOL)
    torch.testing.assert_close(cov.double(), r_cov, **COV_TOL)


@pytest.mark.cuda
def test_moments_kernel_is_deterministic(cuda_device):
    x, _, _ = _args(256, 56448, device=cuda_device)
    a = cuda_whitening.whiten_moments(x, 4)
    b = cuda_whitening.whiten_moments(x, 4)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.cuda
def test_moments_wrapper_rejects_what_the_kernel_does_not_take(cuda_device):
    x, _, _ = _args(device=cuda_device)
    with pytest.raises(TypeError, match="float32"):
        cuda_whitening.whiten_moments(x.double(), 4)
    with pytest.raises(TypeError, match="float32"):
        cuda_whitening.whiten_moments(x.half(), 4)
    with pytest.raises(ValueError, match="group size"):
        cuda_whitening.whiten_moments(x, 24)  # does not divide C = 64
    for c, g in ((64, 8), (64, 16), (48, 48)):
        xc, _, _ = _args(c, device=cuda_device)
        before = cuda_whitening.moments_launches
        _, cov = cuda_whitening.whiten_moments(xc, g)
        assert cuda_whitening.moments_launches == before + 1
        assert cov.shape == (c // g, g, g)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_whitening.whiten_moments(torch.cat([x, x], dim=1)[:, ::2], 4)
    with pytest.raises(ValueError, match="no rows"):
        cuda_whitening.whiten_moments(x[:0], 4)
    with pytest.raises(ValueError, match="domains"):  # one counter per domain
        cuda_whitening.whiten_moments(
            torch.zeros(65, 8, 64, device=cuda_device), 4)


def _domains(d, m, c, device, seed=0, offset=0.0):
    """``[D, M, C]`` f32 on ``device``, domain ``i`` its own draw with a
    mean offset of ``offset + i``."""
    return torch.stack([_args(c, m, seed=seed + i)[0] + offset + i
                        for i in range(d)]).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 2, 3])
@pytest.mark.parametrize("c,m,offset", [
    (64, 1000, 0.0), (256, 1000, 4.0), (64, 7, 0.0), (64, 56448, 0.0),
    (256, 56448, 0.0),
])
def test_batched_moments_kernel_matches_plain_and_two_pass(cuda_device, d, c,
                                                          m, offset):
    """One launch for all D domains; each domain against the plain
    version and a float64 two-pass computation of its own slice."""
    x = _domains(d, m, c, cuda_device, seed=m + c, offset=offset)
    before = cuda_whitening.moments_launches
    mean, cov = cuda_whitening.whiten_moments(x, 4)
    torch.cuda.synchronize()
    assert cuda_whitening.moments_launches == before + 1
    assert mean.shape == (d, c) and cov.shape == (d, c // 4, 4, 4)
    p_mean, p_cov = cuda_whitening.whiten_moments_plain(x, 4)
    torch.testing.assert_close(mean, p_mean, **MEAN_TOL)
    torch.testing.assert_close(cov, p_cov, **COV_TOL)
    for i in range(d):
        r_mean, r_cov = _two_pass_f64(x[i])
        torch.testing.assert_close(mean[i].double(), r_mean, **MEAN_TOL)
        torch.testing.assert_close(cov[i].double(), r_cov, **COV_TOL)


@pytest.mark.cuda
def test_batched_moments_kernel_is_bitwise_repeatable(cuda_device):
    x = _domains(3, 56448, 64, cuda_device, seed=5)
    a = cuda_whitening.whiten_moments(x, 4)
    b = cuda_whitening.whiten_moments(x, 4)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.cuda
def test_batched_moments_kernel_replays_in_a_cuda_graph(cuda_device):
    """A launch captured in a CUDA graph and replayed twice gives the eager
    call's result bitwise: the arrival counter is zero again after every
    launch, replays included.  The capture records one launch and makes
    none: the count moves by the replays."""
    x = _domains(3, 56448, 256, cuda_device, seed=6, offset=2.0)
    eager = cuda_whitening.whiten_moments(x, 4)  # also warms up the shape
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    before = cuda_whitening.moments_launches
    with cuda_whitening.capture_launches() as recorded, torch.cuda.graph(graph):
        captured = cuda_whitening.whiten_moments(x, 4)
    assert recorded == {"apply": 0, "moments": 1}
    assert cuda_whitening.moments_launches == before
    cuda_whitening.count_replay(recorded, 2)
    assert cuda_whitening.moments_launches == before + 2
    for _ in range(2):
        captured[0].zero_()
        captured[1].zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(captured[0], eager[0])
        assert torch.equal(captured[1], eager[1])
    again = cuda_whitening.whiten_moments(x, 4)
    assert torch.equal(again[0], eager[0]) and torch.equal(again[1], eager[1])


@pytest.mark.cuda
def test_moments_wrapper_rejects_a_strided_domain_stack(cuda_device):
    """A ``[D, M, C]`` whose domains are not one contiguous block raises."""
    x = _domains(3, 1000, 64, cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_whitening.whiten_moments(x[:, ::2], 4)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_whitening.whiten_moments(x.transpose(0, 1), 4)
    with pytest.raises(ValueError, match=r"\[M, C\] or \[D, M, C\]"):
        cuda_whitening.whiten_moments(x[None], 4)


@pytest.mark.cuda
def test_train_whiten_on_the_card_matches_the_cpu(cuda_device):
    """One train-mode site, kernels on the card, plain versions on the
    CPU: outputs, moments and input gradients."""
    x, _, _ = _args(64, 3 * 500, seed=3)
    r = torch.randn(3, 500, 64, generator=torch.Generator().manual_seed(0))
    results = []
    for device in (cuda_device, torch.device("cpu")):
        xd = x.view(3, 500, 64).to(device).requires_grad_(True)
        y, means, covs = cuda_whitening.TrainWhiten.apply(xd, 4, 1e-3)
        (y * r.to(device)).sum().backward()
        results.append([t.detach().cpu() for t in (y, means, covs, xd.grad)])
    for ours, ref, tol in zip(*results, [dict(rtol=2e-4, atol=2e-5), MEAN_TOL,
                                         COV_TOL, dict(rtol=2e-3, atol=5e-5)]):
        torch.testing.assert_close(ours, ref, **tol)


# The digits slice (LeNet-DWT): C = 32 (G = 8) and C = 48 (G = 12, whose
# 252-thread blocks are not a multiple of 32 and whose last cluster splits
# 12 groups over 8 ranks), 2 domains, a few thousand rows per domain.
DIGITS_MOMENTS = [  # (D, M, C)
    (2, 25088, 32), (2, 6272, 48),   # a train step's dn1 and dn2 at 32 per stream
    (2, 300, 48), (2, 5, 32),        # more blocks than rows: most read nothing
    (1, 6272, 48),
]


@pytest.mark.cuda
@pytest.mark.parametrize("d,m,c", DIGITS_MOMENTS)
def test_moments_kernel_at_digits_shapes(cuda_device, d, m, c):
    x = _domains(d, m, c, cuda_device, seed=m + c, offset=1.0)
    before = cuda_whitening.moments_launches
    mean, cov = cuda_whitening.whiten_moments(x, 4)
    again = cuda_whitening.whiten_moments(x, 4)
    torch.cuda.synchronize()
    assert cuda_whitening.moments_launches == before + 2
    assert torch.equal(mean, again[0]) and torch.equal(cov, again[1])
    p_mean, p_cov = cuda_whitening.whiten_moments_plain(x, 4)
    torch.testing.assert_close(mean, p_mean, **MEAN_TOL)
    torch.testing.assert_close(cov, p_cov, **COV_TOL)
    for i in range(d):
        r_mean, r_cov = _two_pass_f64(x[i])
        torch.testing.assert_close(mean[i].double(), r_mean, **MEAN_TOL)
        torch.testing.assert_close(cov[i].double(), r_cov, **COV_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("c,m", [
    (32, 784), (48, 196),            # a bucket-1 serve forward's dn1 and dn2
    (32, 25088), (48, 6272),         # one domain of a train step
    (48, 19600), (48, 7),
])
def test_apply_kernel_at_digits_shapes(cuda_device, c, m):
    x, mean, w = _args(c, m, device=cuda_device, seed=c + m)
    y = cuda_whitening.whiten_apply(x, mean, w)
    torch.cuda.synchronize()
    torch.testing.assert_close(y, cuda_whitening.whiten_apply_plain(x, mean, w),
                               **TOL)


@pytest.mark.cuda
def test_lenet_on_the_card_matches_the_cpu(cuda_device, monkeypatch):
    """LeNet-DWT's train forward (both kernels at both sites) and eval
    forward (the apply kernel) on the card against the same model on the
    CPU: logits and running stats.  Convolutions in full f32 on the card,
    as the trainer and the engine run them (TF32 off)."""
    from dwt_tpu_torch.nn.lenet import build_lenet

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(2, 32, 28, 28, 1)).astype(np.float32))
    results = []
    for device in (cuda_device, torch.device("cpu")):
        model = build_lenet(seed=0).to(device, memory_format=torch.channels_last)
        before = (cuda_whitening.moments_launches, cuda_whitening.apply_launches)
        with torch.no_grad():
            train_logits = model.train()(x.to(device))
            eval_logits = model.eval()(x[1].to(device))
        launches = (cuda_whitening.moments_launches - before[0],
                    cuda_whitening.apply_launches - before[1])
        results.append([train_logits.cpu(), eval_logits.cpu(), model.dn2.cov.cpu(),
                        model.dn1.mean.cpu()])
        if device.type == "cuda":  # one launch per site and pass for both domains
            assert launches == (2, 2 + 2)
    for ours, ref in zip(*results):
        torch.testing.assert_close(ours, ref, rtol=2e-4, atol=2e-4 * float(ref.abs().max()))


# The domain-batched apply: one launch for the D domains of x [D, M, C],
# each with its own mean [D, C] and matrix w [D, G, 4, 4].
APPLY_BATCHED = [  # (C, M)
    (32, 1), (48, 7), (64, 1000), (256, 1000),  # ragged M, under one block
    (32, 25088), (48, 6272),                    # LeNet-DWT's train sites
    (64, 56448), (256, 37),                     # ResNet50's stage 1; ragged
]


def _apply_domains(d, m, c, device, seed=0):
    """``x [D, M, C]``, ``mean [D, C]``, ``w [D, C/4, 4, 4]`` on ``device``,
    each domain its own draw."""
    parts = [_args(c, m, seed=seed + i) for i in range(d)]
    return tuple(torch.stack(ts).to(device) for ts in zip(*parts))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 2, 3])
@pytest.mark.parametrize("c,m", APPLY_BATCHED)
def test_batched_apply_kernel_matches_plain(cuda_device, d, c, m):
    x, mean, w = _apply_domains(d, m, c, cuda_device, seed=c + m)
    before = cuda_whitening.apply_launches
    y = cuda_whitening.whiten_apply(x, mean, w)
    torch.cuda.synchronize()
    assert cuda_whitening.apply_launches == before + 1
    assert y.shape == (d, m, c)
    torch.testing.assert_close(y, cuda_whitening.whiten_apply_plain(x, mean, w),
                               **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("c,m", [(48, 7), (256, 1000), (64, 56448)])
def test_batched_apply_does_not_depend_on_the_grid(cuda_device, c, m):
    """Launched through the C entry at other grids than the wrapper's —
    one block per domain, or far more blocks than rows, most of whose
    threads own nothing — the result is bitwise the wrapper's, and the
    2-D form gives bitwise the same numbers per domain."""
    x, mean, w = _apply_domains(3, m, c, cuda_device, seed=9)
    want = cuda_whitening.whiten_apply(x, mean, w)
    launch = cuda_whitening._apply_launch()
    for blocks in (1, 3, 500):
        y = torch.full_like(x, float("nan"))
        rc = launch(x.data_ptr(), mean.data_ptr(), w.data_ptr(), y.data_ptr(),
                    3, m, c, blocks, torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        assert rc == 0
        assert torch.equal(y, want), blocks
    for i in range(3):
        assert torch.equal(cuda_whitening.whiten_apply(x[i], mean[i], w[i]), want[i])


@pytest.mark.cuda
def test_batched_apply_kernel_is_bitwise_repeatable(cuda_device):
    x, mean, w = _apply_domains(3, 56448, 64, cuda_device, seed=5)
    a = cuda_whitening.whiten_apply(x, mean, w)
    b = cuda_whitening.whiten_apply(x, mean, w)
    assert torch.equal(a, b)


@pytest.mark.cuda
def test_batched_apply_kernel_replays_in_a_cuda_graph(cuda_device):
    """A launch captured in a CUDA graph and replayed twice writes the
    eager call's result bitwise.  The capture records one launch and makes
    none."""
    x, mean, w = _apply_domains(2, 6272, 48, cuda_device, seed=6)
    eager = cuda_whitening.whiten_apply(x, mean, w)  # also warms up the shape
    out = torch.empty_like(x)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    before = cuda_whitening.apply_launches
    with cuda_whitening.capture_launches() as recorded, torch.cuda.graph(graph):
        cuda_whitening.whiten_apply(x, mean, w, out=out)
    assert recorded == {"apply": 1, "moments": 0}
    assert cuda_whitening.apply_launches == before
    for _ in range(2):
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, eager)


@pytest.mark.cuda
def test_apply_wrapper_refuses_what_the_batched_kernel_does_not_take(cuda_device):
    """A strided domain stack is refused, not copied; so are a ``mean`` or
    ``w`` whose domains disagree with ``x``'s and a misaligned ``out``."""
    x, mean, w = _apply_domains(3, 1000, 64, cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_whitening.whiten_apply(x[:, ::2], mean, w)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_whitening.whiten_apply(x.transpose(0, 1).contiguous().transpose(0, 1),
                                    mean, w)
    with pytest.raises(ValueError, match="disagree"):
        cuda_whitening.whiten_apply(x, mean[:2], w)
    with pytest.raises(ValueError, match="disagree"):
        cuda_whitening.whiten_apply(x, mean, w[:2])
    with pytest.raises(ValueError, match=r"\[D, G, g, g\]"):
        cuda_whitening.whiten_apply(x, mean, w[0])
    with pytest.raises(ValueError, match="group size"):  # 24 does not divide 64
        cuda_whitening.whiten_apply(x, mean, torch.eye(24, device=cuda_device)
                                    .repeat(3, 2, 1, 1))
    for g in (8, 16):  # every g that divides C launches, one launch for D
        before = cuda_whitening.apply_launches
        cuda_whitening.whiten_apply(x, mean, torch.eye(g, device=cuda_device)
                                    .repeat(3, 64 // g, 1, 1))
        assert cuda_whitening.apply_launches == before + 1
    x48, mean48, _ = _apply_domains(3, 100, 48, cuda_device)
    before = cuda_whitening.apply_launches
    cuda_whitening.whiten_apply(x48, mean48, torch.eye(48, device=cuda_device)
                                .repeat(3, 1, 1, 1))
    assert cuda_whitening.apply_launches == before + 1
    buf = torch.empty(x.numel() + 1, device=cuda_device)
    with pytest.raises(ValueError, match="16-byte aligned"):
        cuda_whitening.whiten_apply(x, mean, w, out=buf[1:].view_as(x))
    with pytest.raises(ValueError, match="16-byte aligned"):
        cuda_whitening.whiten_apply(buf[1:].view_as(x), mean, w)
    with pytest.raises(ValueError, match=r"\[M, C\] or \[D, M, C\]"):
        cuda_whitening.whiten_apply(x[None], mean, w)


# ------------------------------------------------- prefetch to the card


def _host_batches(count, seed=0, rows=4):
    rng = np.random.default_rng(seed)
    return [{"x": rng.normal(size=(rows, 3, 32, 32)).astype(np.float32),
             "y": rng.integers(0, 65, size=rows),
             "mask": rng.integers(0, 2, size=rows).astype(bool)}
            for _ in range(count)]


def _assert_on_card_and_equal(got, want, device):
    for key, host in want.items():
        t = got[key]
        assert t.device.type == device.type and t.dtype == torch.from_numpy(host).dtype
        assert np.array_equal(t.cpu().numpy(), host)


@pytest.mark.cuda
def test_prefetch_delivers_batches_bitwise_through_the_pinned_ring(cuda_device):
    """Ten batches through a ring of size + 1 = 3 pinned sets (each reused
    three times or more), each consumed on the default stream after a
    kernel that keeps the card busy, and a batch of another shape (the
    ring reallocates that set)."""
    from dwt_tpu_torch.data.loader import prefetch_to_device

    src = _host_batches(10) + _host_batches(1, seed=1, rows=7)
    got = []
    for batch in prefetch_to_device(iter(src), size=2, device=cuda_device):
        torch.cuda._sleep(1_000_000)  # the consumer's stream lags the copies
        got.append({k: v.clone() for k, v in batch.items()})  # used on this stream
    torch.cuda.synchronize()
    assert len(got) == len(src)
    for g, s in zip(got, src):
        _assert_on_card_and_equal(g, s, cuda_device)


@pytest.mark.cuda
def test_prefetch_stops_cleanly_when_closed_mid_stream(cuda_device):
    import threading

    from dwt_tpu_torch.data.loader import prefetch_to_device

    src = _host_batches(5)
    pulled = []

    def endless():
        for i in range(10_000):
            pulled.append(i)
            yield src[i % 5]

    it = prefetch_to_device(endless(), size=2, device=cuda_device)
    first = next(it)
    second = next(it)
    it.close()  # joins the producer thread
    assert not [t for t in threading.enumerate() if t.name == "dwt-prefetch"]
    assert len(pulled) <= 6
    _assert_on_card_and_equal(first, src[0], cuda_device)
    _assert_on_card_and_equal(second, src[1], cuda_device)

    def failing():
        yield src[0]
        raise OSError("decode failed")

    it = prefetch_to_device(failing(), device=cuda_device)
    _assert_on_card_and_equal(next(it), src[0], cuda_device)
    with pytest.raises(OSError, match="decode failed"):
        next(it)


def _cuda_state(device):
    """A LeNet-DWT on the card, channels_last, with SGD after one step (its
    momentum buffers exist)."""
    from dwt_tpu_torch.nn import LeNetDWT
    from dwt_tpu_torch.train.optim import sgd_two_group, set_learning_rates
    from dwt_tpu_torch.train.state import TrainState

    torch.manual_seed(0)
    model = LeNetDWT(group_size=4).to(device, memory_format=torch.channels_last)
    opt = sgd_two_group(model, head_key="fc4")
    state = TrainState(model, opt, (lambda s: 1e-2, lambda s: 1e-3))
    for p in model.parameters():
        p.grad = torch.randn_like(p)
    set_learning_rates(opt, state.schedules, 0)
    opt.step()
    state.step = 1
    return state


@pytest.mark.cuda
def test_async_snapshot_is_ordered_before_the_next_in_place_updates(cuda_device, tmp_path):
    """The writer copies its snapshot on its own stream after an event
    recorded behind the snapshot's copies: parameters and momentum
    overwritten in place right after ``save`` returns (with a long kernel
    queue in front) do not reach the file, which holds the state of the
    save's step bitwise."""
    from dwt_tpu_torch.resilience import AsyncCheckpointer
    from dwt_tpu_torch.utils import checkpoint as ckpt

    state = _cuda_state(cuda_device)
    want = state.state_dict()
    big = torch.randn(4096, 4096, device=cuda_device)
    acp = AsyncCheckpointer()
    acp.save(str(tmp_path), 1, state)
    with torch.no_grad():
        for _ in range(20):
            big = big @ big / 64.0  # keep the compute stream busy
        for p in state.model.parameters():
            p.add_(1.0)
            state.optimizer.state[p]["momentum_buffer"].mul_(-1.0)
    path = acp.flush()
    got = torch.load(os.path.join(path, ckpt.STATE_FILE), weights_only=True)
    assert all(torch.equal(want["model"][k], got["model"][k]) for k in want["model"])
    for i, buffers in want["optimizer"]["state"].items():
        for name, v in buffers.items():
            assert torch.equal(v, got["optimizer"]["state"][i][name]), (i, name)
    # The snapshot's buffers are the checkpointer's, reused by the next save.
    before = {k: t.data_ptr() for k, t in acp._snapshot.buffers().items()}
    acp.save(str(tmp_path), 2, state)
    acp.flush()
    assert {k: t.data_ptr() for k, t in acp._snapshot.buffers().items()} == before


@pytest.mark.cuda
def test_guard_revert_on_the_card_copies_in_place(cuda_device):
    """The guard's device snapshot keeps each tensor's strides; a revert
    copies into the live parameters and momentum (pointers unchanged) and
    gives back the snapshot's values bitwise."""
    from dwt_tpu_torch.resilience import DivergenceGuard

    state = _cuda_state(cuda_device)
    model, opt = state.model, state.optimizer
    guard = DivergenceGuard("skip_step", 1)
    guard.prime(state)
    assert (guard._good.payload["model"]["conv1.weight"].stride()
            == model.conv1.weight.stride())
    want = {n: p.detach().clone() for n, p in model.named_parameters()}
    ptrs = [(p.data_ptr(), opt.state[p]["momentum_buffer"].data_ptr())
            for p in model.parameters()]
    with torch.no_grad():
        for p in model.parameters():
            p.fill_(float("nan"))
    state.step = 2
    guard.step(state, {"loss": torch.tensor(float("nan"), device=cuda_device),
                       "grad_norm": torch.tensor(1.0, device=cuda_device)}, 1, 2)
    assert state.step == 1 and guard.checks == 1
    assert ptrs == [(p.data_ptr(), opt.state[p]["momentum_buffer"].data_ptr())
                    for p in model.parameters()]
    assert all(torch.equal(p.detach(), want[n]) for n, p in model.named_parameters())


# ------------------------------------------- k steps per dispatch (graphs)


def _digits_run_state(device, seed=1):
    """LeNet-DWT on the card with the digits recipe's Adam (capturable, a
    device lr), milestones at steps 2 and 4."""
    from dwt_tpu_torch.config import DigitsConfig
    from dwt_tpu_torch.nn.lenet import build_lenet
    from dwt_tpu_torch.train.optim import digits_tx
    from dwt_tpu_torch.train.state import TrainState

    model = build_lenet(group_size=4, seed=seed).to(device, memory_format=torch.channels_last)
    optimizer, schedules = digits_tx(model, DigitsConfig(lr_milestones=(2, 3)), 2)
    return TrainState(model, optimizer, schedules)


def _digits_chunk(n, device, seed=0):
    rng = np.random.default_rng(seed)
    return {"source_x": torch.from_numpy(rng.normal(size=(n, 32, 28, 28, 1))
                                         .astype(np.float32)).to(device),
            "source_y": torch.from_numpy(rng.integers(0, 10, size=(n, 32))).to(device),
            "target_x": torch.from_numpy(rng.normal(size=(n, 32, 28, 28, 1))
                                         .astype(np.float32)).to(device)}


class _Deterministic:
    def __enter__(self):
        self.saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False

    def __exit__(self, *exc):
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = self.saved


def _assert_states_equal(a, b):
    for (name, x), y in zip(a.model.state_dict().items(), b.model.state_dict().values()):
        assert torch.equal(x, y), name
    for p, q in zip(a.model.parameters(), b.model.parameters()):
        for key, value in a.optimizer.state[p].items():
            assert torch.equal(value, b.optimizer.state[q][key]), key


@pytest.mark.cuda
def test_replayed_train_steps_are_bitwise_the_eager_steps(cuda_device):
    """Five digits steps (Adam, the lr decaying at steps 2 and 4): one by
    one eagerly, and as chunks of 3 + 2 through the scanned step (the first
    step eager on the side stream, the capture, then 4 replays).  Metrics,
    parameters, stats and Adam's moments bitwise equal; both kernels were
    captured once each per site and counted once per replay."""
    from dwt_tpu_torch.train import steps

    with _Deterministic():
        eager, graphed = _digits_run_state(cuda_device), _digits_run_state(cuda_device)
        chunk = _digits_chunk(5, cuda_device)
        step = steps.make_digits_train_step(eager.model)
        rows = [step(eager, {k: v[i] for k, v in chunk.items()}) for i in range(5)]
        scanned = steps.make_scanned_step(steps.make_digits_train_step(graphed.model), 3)
        before = (cuda_whitening.moments_launches, cuda_whitening.apply_launches)
        out = [scanned(graphed, {k: v[:3] for k, v in chunk.items()}),
               scanned(graphed, {k: v[3:] for k, v in chunk.items()})]
        torch.cuda.synchronize()
    assert graphed.step == eager.step == 5
    for key in rows[0]:
        assert torch.equal(torch.cat([o[key] for o in out]),
                           torch.stack([r[key] for r in rows])), key
    _assert_states_equal(eager, graphed)
    graph = scanned.graph
    assert (graph.captures, graph.replays) == (1, 4)
    assert graph.recorded == {"apply": 2, "moments": 2}
    assert (cuda_whitening.moments_launches - before[0],
            cuda_whitening.apply_launches - before[1]) == (10, 10)


@pytest.mark.cuda
def test_replayed_steps_read_the_lr_of_their_step(cuda_device):
    """OfficeHome's two-group SGD (fused, device lrs) on LeNet-DWT: a
    milestone inside a chunk and a backoff scale set between two chunks
    reach the replays — the parameters follow the eager steps bitwise, and
    differ from a run whose lr stayed the capture's."""
    from dwt_tpu_torch.nn.lenet import build_lenet
    from dwt_tpu_torch.train import steps
    from dwt_tpu_torch.train.optim import multistep_schedule, sgd_two_group
    from dwt_tpu_torch.train.state import TrainState

    def state():
        model = build_lenet(group_size=4, seed=1).to(cuda_device,
                                                    memory_format=torch.channels_last)
        return TrainState(model, sgd_two_group(model, head_key="fc4"),
                          (multistep_schedule(1e-2, (3,)), multistep_schedule(1e-3, (3,))))

    with _Deterministic():
        eager, graphed, frozen = state(), state(), state()
        chunk = _digits_chunk(6, cuda_device, seed=2)
        step = steps.make_digits_train_step(eager.model)
        for i in range(6):
            if i == 3:
                eager.lr_scale = 0.5
            step(eager, {k: v[i] for k, v in chunk.items()})
        scanned = steps.make_scanned_step(steps.make_digits_train_step(graphed.model), 3)
        scanned(graphed, {k: v[:3] for k, v in chunk.items()})
        graphed.lr_scale = 0.5
        scanned(graphed, {k: v[3:] for k, v in chunk.items()})
        frozen_step = steps.make_digits_train_step(frozen.model)
        for i in range(6):  # every step at the first step's lrs
            frozen.schedules = (lambda s: 1e-2, lambda s: 1e-3)
            frozen_step(frozen, {k: v[i] for k, v in chunk.items()})
        torch.cuda.synchronize()
    assert [g["lr_host"] for g in graphed.optimizer.param_groups] == pytest.approx([5e-4, 5e-5])
    assert [float(g["lr"]) for g in graphed.optimizer.param_groups] == pytest.approx([5e-4, 5e-5])
    _assert_states_equal(eager, graphed)
    assert not all(torch.equal(a, b) for a, b in zip(graphed.model.parameters(),
                                                      frozen.model.parameters()))


@pytest.mark.cuda
def test_eval_graph_reads_each_pass_cache(cuda_device):
    """Two eval passes at 8 batches per dispatch with a collection pass
    between them (new running stats, a new eval-matrix cache installed):
    the graph captured in the first pass gives each pass the counters of
    the eager path (one batch per dispatch), bitwise; the second pass only
    replays."""
    from dwt_tpu_torch.data.datasets import ArrayDataset
    from dwt_tpu_torch.train.evalpipe import EvalPipeline

    rng = np.random.default_rng(3)
    data = ArrayDataset(rng.normal(size=(250, 28, 28, 1)).astype(np.float32),
                        rng.integers(0, 10, size=(250,)))
    with _Deterministic():
        state = _digits_run_state(cuda_device)
        graphed = EvalPipeline(100, cuda_device, 2, eval_k=8)
        eager = EvalPipeline(100, cuda_device, 2, eval_k=1)
        passes = []
        for _ in range(2):
            passes.append([p.evaluate(state, data) for p in (graphed, eager)])
            EvalPipeline(100, cuda_device, 2).collect_stats(state, data)
    for ours, ref in passes:
        ours.pop("eval_s"), ref.pop("eval_s")
        assert ours == ref
    assert passes[0][0] != passes[1][0]  # the stats moved between the passes
    # 3 batches a pass: the first eager, then 2 replays; the second pass 3.
    assert (graphed.eval_graph.captures, graphed.eval_graph.replays) == (1, 5)


@pytest.mark.cuda
def test_harvester_put_does_not_wait_for_the_copy(cuda_device, monkeypatch):
    """A put behind a long queue of device work returns with its entry in
    flight (its event not fired, no rendezvous); the drain waits once and
    emits the device value."""
    from dwt_tpu_torch.train.harvest import AsyncMetricHarvester

    waits = []
    real = AsyncMetricHarvester._wait
    monkeypatch.setattr(AsyncMetricHarvester, "_wait",
                        lambda self, e: waits.append(len(e)) or real(self, e))
    big = torch.randn(4096, 4096, device=cuda_device)
    for _ in range(30):
        big = torch.sin(big @ big)  # bounded: the value below stays finite
    value = big[0, 0] * 0 + 3.0
    emitted = []
    h = AsyncMetricHarvester(2)
    h.put(1, 1, values={"v": value}, emit=lambda vals: emitted.append(float(vals["v"])))
    assert h.pending == 1 and not h._ring[0].ready() and waits == []
    h.drain()
    assert waits == [1] and emitted == [3.0]


@pytest.mark.cuda
def test_a_failed_capture_raises_and_runs_nothing_eagerly(cuda_device):
    """A step whose body reads a value back cannot be captured: the chunk
    raises with the reason after its one eager (warm-up) step, and no other
    step runs eagerly in its place."""
    from dwt_tpu_torch.train import steps

    state = _digits_run_state(cuda_device)
    inner = steps.make_digits_train_step(state.model).body

    def body(st, batch):
        metrics = inner(st, batch)
        float(metrics["loss"])  # a host sync: refused inside a capture
        return metrics

    scanned = steps.make_scanned_step(steps._train_step(body), 3)
    with pytest.raises(RuntimeError, match="CUDA graph capture of the train step failed"):
        scanned(state, _digits_chunk(3, cuda_device))
    assert state.step == 1 and scanned.graph.graph is None


@pytest.mark.cuda
@pytest.mark.parametrize("recipe", ["adam", "sgd"])
def test_a_cpu_checkpoint_resumes_into_the_captured_step(cuda_device, recipe):
    """A state saved on the CPU (Adam neither capturable nor foreach, SGD
    not fused, float lrs) resumes on the card into the card's update rule:
    the live flags and device lrs stay, and two steps through the scanned
    step (one eager, one replayed) are bitwise two eager steps of the same
    resumed state."""
    from dwt_tpu_torch.nn.lenet import build_lenet
    from dwt_tpu_torch.train import steps
    from dwt_tpu_torch.train.optim import multistep_schedule, sgd_two_group

    def state(device):
        if recipe == "adam":
            return _digits_run_state(device)
        from dwt_tpu_torch.train.state import TrainState
        model = build_lenet(group_size=4, seed=1).to(device, memory_format=torch.channels_last)
        return TrainState(model, sgd_two_group(model, head_key="fc4"),
                          (multistep_schedule(1e-2, (3,)), multistep_schedule(1e-3, (3,))))

    cpu = state(torch.device("cpu"))
    chunk = _digits_chunk(3, torch.device("cpu"), seed=4)
    steps.make_digits_train_step(cpu.model)(cpu, {k: v[0] for k, v in chunk.items()})
    payload = cpu.state_dict()
    flags = {"adam": {"capturable": True, "foreach": True}, "sgd": {"fused": True}}[recipe]
    with _Deterministic():
        eager, graphed = state(cuda_device), state(cuda_device)
        for s in (eager, graphed):
            s.load_state_dict(payload)
            for group in s.optimizer.param_groups:
                assert torch.is_tensor(group["lr"]) and group["lr"].is_cuda
                assert {k: group[k] for k in flags} == flags
        assert eager.step == graphed.step == 1
        card = {k: v[1:].to(cuda_device) for k, v in chunk.items()}
        step = steps.make_digits_train_step(eager.model)
        for i in range(2):
            step(eager, {k: v[i] for k, v in card.items()})
        scanned = steps.make_scanned_step(steps.make_digits_train_step(graphed.model), 2)
        scanned(graphed, card)
        torch.cuda.synchronize()
    assert (scanned.graph.captures, scanned.graph.replays) == (1, 1)
    _assert_states_equal(eager, graphed)


@pytest.mark.cuda
def test_one_step_per_dispatch_runs_eagerly(cuda_device):
    """At k = 1 the scanned step captures nothing: each one-batch chunk is
    the eager step, bitwise, its metrics stacked [1]."""
    from dwt_tpu_torch.train import steps

    with _Deterministic():
        eager, chunked = _digits_run_state(cuda_device), _digits_run_state(cuda_device)
        chunk = _digits_chunk(2, cuda_device, seed=5)
        step = steps.make_digits_train_step(eager.model)
        rows = [step(eager, {k: v[i] for k, v in chunk.items()}) for i in range(2)]
        scanned = steps.make_scanned_step(steps.make_digits_train_step(chunked.model), 1)
        out = [scanned(chunked, {k: v[i:i + 1] for k, v in chunk.items()}) for i in range(2)]
        torch.cuda.synchronize()
    assert (scanned.graph.captures, scanned.graph.replays) == (0, 0)
    for key in rows[0]:
        assert torch.equal(torch.cat([o[key] for o in out]),
                           torch.stack([r[key] for r in rows])), key
    _assert_states_equal(eager, chunked)


# The bf16 variants: x (and y) bf16, mean and w f32.  The apply is held
# bitwise to its plain version (the products of two bf16 values are exact
# in f32 and both sum the 4 terms in one order); the moments to the plain
# version and a float64 two-pass reference at the f32 tolerances.
BF16_SHAPES = [  # (D, M, C): ResNet50 train sites at 18 per stream, LeNet-DWT's, ragged
    (3, 18 * 112 * 112, 64), (3, 18 * 56 * 56, 256), (2, 32 * 28 * 28, 32),
    (2, 32 * 14 * 14, 48), (1, 1000, 48), (1, 7, 32), (1, 1, 64)]


def _bf16_site(d, m, c, device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    x = (torch.randn(d, m, c, device=device, generator=g) * 2 + 1).to(torch.bfloat16)
    mean = torch.randn(d, c, device=device, generator=g) * 0.5 + 1
    a = torch.randn(d, c // 4, 4, 4, device=device, generator=g)
    w = whitening_matrix(_shrink(a @ a.transpose(-1, -2) / 4 + 0.5 * torch.eye(4, device=device),
                                 1e-3))
    return x, mean, w


@pytest.mark.cuda
@pytest.mark.parametrize("d,m,c", BF16_SHAPES)
def test_bf16_kernels_match_their_plain_versions(cuda_device, d, m, c):
    x, mean, w = _bf16_site(d, m, c, cuda_device, seed=m + c)
    before = cuda_whitening.apply_launches, cuda_whitening.moments_launches
    y = cuda_whitening.whiten_apply(x, mean, w)
    assert y.dtype == torch.bfloat16
    assert torch.equal(y, cuda_whitening.whiten_apply_plain(x, mean, w))
    if d == 1:
        assert torch.equal(cuda_whitening.whiten_apply(x[0], mean[0], w[0]), y[0])
    got_mean, got_cov = cuda_whitening.whiten_moments(x, 4)
    assert got_mean.dtype == got_cov.dtype == torch.float32
    ref_mean, ref_cov = cuda_whitening.whiten_moments_plain(x, 4)
    torch.testing.assert_close(got_mean, ref_mean, **MEAN_TOL)
    torch.testing.assert_close(got_cov, ref_cov, **COV_TOL)
    for i in range(d):
        m64, c64 = _two_pass_f64(x[i].float())
        torch.testing.assert_close(got_mean[i].double(), m64, **MEAN_TOL)
        torch.testing.assert_close(got_cov[i].double(), c64, **COV_TOL)
    assert (cuda_whitening.apply_launches - before[0],
            cuda_whitening.moments_launches - before[1]) == (1 + (d == 1), 1)


@pytest.mark.cuda
def test_bf16_kernels_replay_in_a_cuda_graph(cuda_device):
    """Both bf16 launches captured in one graph and replayed twice give the
    eager calls' results bitwise; the capture records a launch of each."""
    x, mean, w = _bf16_site(3, 18 * 56 * 56, 64, cuda_device, seed=9)
    eager_moments = cuda_whitening.whiten_moments(x, 4)
    eager_y = cuda_whitening.whiten_apply(x, eager_moments[0], w)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with cuda_whitening.capture_launches() as recorded, torch.cuda.graph(graph):
        mean_c, cov_c = cuda_whitening.whiten_moments(x, 4)
        y_c = cuda_whitening.whiten_apply(x, mean_c, w)
    assert recorded == {"apply": 1, "moments": 1}
    for _ in range(2):
        for t in (mean_c, cov_c, y_c):
            t.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(mean_c, eager_moments[0]) and torch.equal(cov_c, eager_moments[1])
        assert torch.equal(y_c, eager_y)


@pytest.mark.cuda
def test_bf16_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    """A bf16 tensor reaches the bf16 kernel or raises: never widened to
    the f32 one.  The bf16 apply takes C a multiple of 8, f32 mean and w
    and a bf16 out; an f16 tensor is refused by both wrappers."""
    x, mean, w = _bf16_site(1, 100, 32, cuda_device)
    with pytest.raises(ValueError, match="multiple of 8"):
        cuda_whitening.whiten_apply(x[0, :, :12].contiguous(), mean[0, :12], w[0, :3])
    with pytest.raises(TypeError, match="mean must be float32"):
        cuda_whitening.whiten_apply(x[0], mean[0].bfloat16(), w[0])
    with pytest.raises(TypeError, match="w must be float32"):
        cuda_whitening.whiten_apply(x[0], mean[0], w[0].bfloat16())
    with pytest.raises(TypeError, match="out must be bfloat16"):
        cuda_whitening.whiten_apply(x[0], mean[0], w[0], out=torch.empty_like(x[0], dtype=torch.float32))
    for fn in (lambda t: cuda_whitening.whiten_apply(t, mean[0], w[0]),
               lambda t: cuda_whitening.whiten_moments(t, 4)):
        with pytest.raises(TypeError, match="float32 or bfloat16"):
            fn(x[0].half())


@pytest.mark.cuda
@pytest.mark.parametrize("whitener", ["cholesky", "newton_schulz", "swbn"])
def test_bf16_train_site_on_the_card_matches_the_cpu(cuda_device, whitener):
    """One bf16 train-mode site through both bf16 kernels on the card and
    through their plain versions on the CPU, per whitener: outputs within
    one bf16 rounding step, moments and the new stats at the f32
    tolerances, input gradients at bf16's."""
    from dwt_tpu_torch.ops import whitening

    x, _, _ = _bf16_site(3, 2000, 64, cuda_device, seed=4)
    r = torch.randn(3, 2000, 64, generator=torch.Generator().manual_seed(1))
    results = []
    for device in (cuda_device, torch.device("cpu")):
        xd = x.detach().to(device).requires_grad_(True)
        stats = whitening.get_whitener(whitener).init_stats(64, 4, device=device)
        stats = type(stats)(*(s.repeat((3,) + (1,) * s.dim()) for s in stats))
        y, new = cuda_whitening.cuda_group_whiten(xd, stats, group_size=4, train=True,
                                                  whitener=whitener)
        (y.float() * r.to(device)).sum().backward()
        results.append([t.detach().cpu() for t in (y, xd.grad, *new)])
    (y_gpu, g_gpu, *new_gpu), (y_cpu, g_cpu, *new_cpu) = results
    torch.testing.assert_close(y_gpu.float(), y_cpu.float(), rtol=2 ** -7, atol=1e-3)
    torch.testing.assert_close(g_gpu.float(), g_cpu.float(), rtol=2e-2, atol=2e-2)
    for ours, ref in zip(new_gpu, new_cpu):
        torch.testing.assert_close(ours, ref, rtol=1e-4, atol=1e-5)


# ------------------------------------------------------ other group sizes
#
# Both kernels at g other than 4 (each source's general body), f32 and
# bf16: held to their plain versions at the tolerances above (the bf16
# apply bitwise), and the moments also to a float64 two-pass of each
# domain, at 1001 rows and at the rows a ResNet50 train step gives the stem
# (C = 64) and stage 1 (C = 256); two calls and two replays of a captured
# call bitwise equal.  Also at the edges of the general bodies' tilings
# (GROUP_EDGES): g = 12, a multiple of 4 that is not one of 8, with four
# output channels a thread; g = 8 and 16, several groups a column tile;
# g = 64, one group a column tile in chunks of c; g = 128 and 2048, w
# streamed a chunk at a time and a group's outputs over several column
# tiles (and the moments' entry tiles over one group's slices); each at 1,
# 7, 129 (one more than the apply's tile of 128 rows) and 1001 rows, D = 1
# and 3.  Where a domain has fewer than 1001 rows, or fewer than 4 g, the
# apply takes a well-conditioned w of its own: the whitening matrix of so
# few rows' covariance is near-singular, and the f32 sums of its huge
# entries differ with the order of the terms.  From g = 128 on (the
# C = 2048 edges), as chip_smoke.py's group_check does from g = 32 on, a
# moment that misses the tolerance against its plain version or float64
# may pass within twice the plain version's own distance from float64
# (the f32 sums of a 2048-wide group over 1001 rows).

# (C, g) at the edges of the general bodies' tilings, and rows per domain.
GROUP_EDGES = [(48, 12), (64, 8), (256, 16), (64, 64), (2048, 128), (2048, 2048)]
GROUP_EDGE_ROWS = [1, 7, 129, 1001]
GROUP_CASES = (
    [pytest.param(3, c, m, g, id=f"{name}-g{g}")
     for name, c, m in [("64", 64, 1001), ("256", 256, 1001),
                        ("64-stem_rows", 64, 18 * 112 * 112),
                        ("256-stage1_rows", 256, 18 * 56 * 56)]
     for g in (8, 16, 64)]
    + [pytest.param(d, c, m, g, id=f"edge-{c}-{m}-g{g}-D{d}")
       for c, g in GROUP_EDGES for m in GROUP_EDGE_ROWS for d in (1, 3)])


def _group_two_pass(x, g):
    xd = x.double()
    mean = xd.mean(dim=1)
    t = (xd - mean[:, None]).view(*x.shape[:2], -1, g)
    return mean, torch.einsum("kmgc,kmgd->kgcd", t, t) / x.shape[1]


def _assert_group_moment(got, plain, f64, tol, g):
    """``got`` within ``tol`` of its plain version and of float64; from
    g = 128 on, failing that, within twice the plain version's own
    largest distance from float64."""
    wide = 2 * float((plain.double() - f64).abs().max()) if g >= 128 else 0.0
    for ref in (plain.double(), f64):
        err = (got.double() - ref).abs()
        assert (bool((err <= tol["atol"] + tol["rtol"] * ref.abs()).all())
                or float(err.max()) <= wide), (float(err.max()), wide)


def _group_w(cov, m, device):
    """The whitening matrix of ``cov [D, G, g, g]``, or a well-conditioned
    one of the same shape where its domains had fewer than 1001 or 4 g
    rows."""
    d, groups, g, _ = cov.shape
    if m >= 1001 and m >= 4 * g:
        return whitening_matrix(_shrink(cov, 1e-3))
    return _well_conditioned_w(d, groups * g, g, device)


def _well_conditioned_w(d, c, g, device, seed=3):
    """``[d, C/g, g, g]``: whitening matrices of covariances ``a aᵀ/g +
    I/2`` (numpy draws)."""
    a = np.random.default_rng(seed).normal(size=(d, c // g, g, g))
    cov = a @ np.swapaxes(a, -1, -2) / g + 0.5 * np.eye(g)
    return whitening_matrix(_shrink(torch.from_numpy(cov.astype(np.float32)), 1e-3)).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,c,m,g", GROUP_CASES)
def test_group_kernels_match_their_plain_versions(cuda_device, d, c, m, g, dtype):
    x = _domains(d, m, c, cuda_device, seed=c + g, offset=0.5).to(dtype)
    before = cuda_whitening.moments_launches, cuda_whitening.apply_launches
    mean, cov = cuda_whitening.whiten_moments(x, g)
    w = _group_w(cov, m, cuda_device)
    y = cuda_whitening.whiten_apply(x, mean, w)
    torch.cuda.synchronize()
    assert (cuda_whitening.moments_launches - before[0],
            cuda_whitening.apply_launches - before[1]) == (1, 1)
    assert cov.shape == (d, c // g, g, g) and y.dtype == dtype
    p_mean, p_cov = cuda_whitening.whiten_moments_plain(x, g)
    r_mean, r_cov = _group_two_pass(x.float(), g)
    _assert_group_moment(mean, p_mean, r_mean, MEAN_TOL, g)
    _assert_group_moment(cov, p_cov, r_cov, COV_TOL, g)
    plain = cuda_whitening.whiten_apply_plain(x, mean, w)
    if dtype is torch.bfloat16:
        assert torch.equal(y, plain)
    else:
        torch.testing.assert_close(y, plain, **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,c,m,g", [
    pytest.param(3, 256, 18 * 56 * 56, g, id=str(g)) for g in (8, 16, 64)] + [
    pytest.param(d, c, m, g, id=f"edge-{c}-{m}-g{g}-D{d}")
    for c, m, g in [(48, 1001, 12), (256, 129, 16), (2048, 1001, 128), (2048, 7, 2048)]
    for d in (1, 3)])
def test_group_kernels_repeat_and_replay_bitwise(cuda_device, d, c, m, g, dtype):
    """Two calls of each kernel, and two replays of one CUDA graph that
    captured both (the moments' arrival counters zero after each
    launch), bitwise equal."""
    x = _domains(d, m, c, cuda_device, seed=g).to(dtype)
    mean, cov = cuda_whitening.whiten_moments(x, g)
    w = _group_w(cov, m, cuda_device)
    y = cuda_whitening.whiten_apply(x, mean, w)
    again = cuda_whitening.whiten_moments(x, g)
    assert torch.equal(again[0], mean) and torch.equal(again[1], cov)
    assert torch.equal(cuda_whitening.whiten_apply(x, mean, w), y)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with cuda_whitening.capture_launches() as recorded, torch.cuda.graph(graph):
        g_mean, g_cov = cuda_whitening.whiten_moments(x, g)
        g_y = cuda_whitening.whiten_apply(x, mean, w)
    assert recorded == {"apply": 1, "moments": 1}
    for _ in range(2):
        for t in (g_mean, g_cov, g_y):
            t.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(g_mean, mean) and torch.equal(g_cov, cov)
        assert torch.equal(g_y, y)


@pytest.mark.cuda
def test_group_train_site_on_the_card_matches_the_cpu(cuda_device):
    """A g = 16 train-mode site through both kernels on the card against
    the same site on the CPU (the plain versions): output, new stats and
    input gradients."""
    from dwt_tpu_torch.ops import whitening

    x = _domains(3, 2000, 64, "cpu", seed=7)
    out = {}
    for device in ("cpu", cuda_device):
        xd = x.detach().clone().to(device).requires_grad_(True)
        stats = whitening.WhiteningStats(torch.zeros(3, 64, device=device),
                                         torch.eye(16, device=device).repeat(3, 4, 1, 1))
        y, new = cuda_whitening.cuda_group_whiten(xd, stats, group_size=16, train=True)
        (y * torch.arange(y.numel(), device=device).view_as(y).sin()).sum().backward()
        out[str(device)] = [t.detach().cpu() for t in (y, new.mean, new.cov, xd.grad)]
    for name, a, b in zip(("y", "mean", "cov", "grad"), out["cpu"], out[str(cuda_device)]):
        torch.testing.assert_close(b, a, rtol=2e-3, atol=5e-5, msg=name)


# ViT-S/16's whitened token sites (C = 384): a train site's [3, 18·196,
# 384] (3,528 rows a domain, not a multiple of the apply's 128-row chunks)
# and the [4·196, 384] rows of a bucket-4 forward, at g = 4 (the g = 4
# kernels), 16 and 64 (the tiled general bodies, 24 and 6 groups).
VIT_TOKENS = 196
VIT_CASES = [pytest.param(d, m, g, id=f"D{d}-M{m}-g{g}")
             for d, m in ((3, 18 * VIT_TOKENS), (None, 4 * VIT_TOKENS))
             for g in (4, 16, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,m,g", VIT_CASES)
def test_kernels_at_the_vit_token_sites(cuda_device, d, m, g, dtype):
    """Both kernels at ViT's token sites against their plain versions (the
    moments also against float64; the bf16 apply bitwise), one launch
    each; a second call of each and two replays of a CUDA graph that
    captured both, bitwise equal.  ``d=None``: the eval and serve apply's
    ``x [M, C]`` (its moments from the ``[1, M, C]`` view)."""
    x = _domains(d or 1, m, 384, cuda_device, seed=g, offset=0.5).to(dtype)
    before = cuda_whitening.moments_launches, cuda_whitening.apply_launches
    mean, cov = cuda_whitening.whiten_moments(x, g)
    w = _group_w(cov, m, cuda_device)
    xa, ma, wa = (x, mean, w) if d else (x[0], mean[0], w[0])
    y = cuda_whitening.whiten_apply(xa, ma, wa)
    torch.cuda.synchronize()
    assert (cuda_whitening.moments_launches - before[0],
            cuda_whitening.apply_launches - before[1]) == (1, 1)
    assert cov.shape == (d or 1, 384 // g, g, g) and y.shape == xa.shape
    p_mean, p_cov = cuda_whitening.whiten_moments_plain(x, g)
    r_mean, r_cov = _group_two_pass(x.float(), g)
    _assert_group_moment(mean, p_mean, r_mean, MEAN_TOL, g)
    _assert_group_moment(cov, p_cov, r_cov, COV_TOL, g)
    plain = cuda_whitening.whiten_apply_plain(xa, ma, wa)
    if dtype is torch.bfloat16:
        assert torch.equal(y, plain)
    else:
        torch.testing.assert_close(y, plain, **TOL)
    again = cuda_whitening.whiten_moments(x, g)
    assert torch.equal(again[0], mean) and torch.equal(again[1], cov)
    assert torch.equal(cuda_whitening.whiten_apply(xa, ma, wa), y)
    graph = torch.cuda.CUDAGraph()
    with cuda_whitening.capture_launches() as recorded, torch.cuda.graph(graph):
        g_mean, g_cov = cuda_whitening.whiten_moments(x, g)
        g_y = cuda_whitening.whiten_apply(xa, ma, wa)
    assert recorded == {"apply": 1, "moments": 1}
    for _ in range(2):
        for t in (g_mean, g_cov, g_y):
            t.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(g_mean, mean) and torch.equal(g_cov, cov)
        assert torch.equal(g_y, y)


@pytest.mark.cuda
def test_vit_on_the_card_matches_the_cpu(cuda_device, monkeypatch):
    """vit_tiny's train forward (both kernels at its 2 whitened token
    sites, one launch each per site for the 3 domains) and eval forward
    (the apply kernel) on the card against the same model on the CPU:
    logits and running stats.  Convolutions and matmuls in full f32."""
    from dwt_tpu_torch.nn.registry import build_backbone

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(3, 8, 16, 16, 3)).astype(np.float32))
    results = []
    for device in (cuda_device, torch.device("cpu")):
        model = build_backbone("vit_tiny", num_classes=5, image_size=16, seed=0)
        model = model.to(device, memory_format=torch.channels_last)
        before = (cuda_whitening.moments_launches, cuda_whitening.apply_launches)
        with torch.no_grad():
            train_logits = model.train()(x.to(device))
            eval_logits = model.eval()(x[1].to(device))
        launches = (cuda_whitening.moments_launches - before[0],
                    cuda_whitening.apply_launches - before[1])
        results.append([train_logits.cpu(), eval_logits.cpu(), model.dn_patch.cov.cpu(),
                        model.blk0.dn.mean.cpu()])
        if device.type == "cuda":
            assert launches == (2, 2 + 2)
    for ours, ref in zip(*results):
        torch.testing.assert_close(ours, ref, rtol=2e-4, atol=2e-4 * float(ref.abs().max()))


# The serving adapter's collect forward (``--adapt_batch 32`` tiled into
# ResNet50-DWT's 3 domains at 224²): 401,408 rows a domain at the stem and
# 100,352 in stage 1, 1.78× a train step's.  The grids and the moments'
# arrival counters size from the rows and D; both kernels, f32 and bf16,
# are held to their plain versions and the moments to float64 there.
COLLECT_SITES = [(3, 32 * 112 * 112, 64), (3, 32 * 56 * 56, 64), (3, 32 * 56 * 56, 256)]


@pytest.mark.cuda
@pytest.mark.parametrize("d,m,c", COLLECT_SITES)
def test_both_kernels_at_the_collect_sites_in_f32(cuda_device, d, m, c):
    g = torch.Generator(device=cuda_device).manual_seed(m + c)
    x = torch.randn(d, m, c, device=cuda_device, generator=g) * 1.5 + 0.5
    before = cuda_whitening.moments_launches, cuda_whitening.apply_launches
    mean, cov = cuda_whitening.whiten_moments(x, 4)
    w = whitening_matrix(_shrink(cov, 1e-3))
    y = cuda_whitening.whiten_apply(x, mean, w)
    torch.cuda.synchronize()
    assert (cuda_whitening.moments_launches - before[0],
            cuda_whitening.apply_launches - before[1]) == (1, 1)
    p_mean, p_cov = cuda_whitening.whiten_moments_plain(x, 4)
    torch.testing.assert_close(mean, p_mean, **MEAN_TOL)
    torch.testing.assert_close(cov, p_cov, **COV_TOL)
    for i in range(d):
        r_mean, r_cov = _two_pass_f64(x[i])
        torch.testing.assert_close(mean[i].double(), r_mean, **MEAN_TOL)
        torch.testing.assert_close(cov[i].double(), r_cov, **COV_TOL)
    torch.testing.assert_close(y, cuda_whitening.whiten_apply_plain(x, mean, w), **TOL)
    again = cuda_whitening.whiten_moments(x, 4)
    assert torch.equal(again[0], mean) and torch.equal(again[1], cov)


@pytest.mark.cuda
@pytest.mark.parametrize("d,m,c", COLLECT_SITES)
def test_both_kernels_at_the_collect_sites_in_bf16(cuda_device, d, m, c):
    x, mean, w = _bf16_site(d, m, c, cuda_device, seed=m + c + 1)
    y = cuda_whitening.whiten_apply(x, mean, w)
    assert torch.equal(y, cuda_whitening.whiten_apply_plain(x, mean, w))
    got_mean, got_cov = cuda_whitening.whiten_moments(x, 4)
    ref_mean, ref_cov = cuda_whitening.whiten_moments_plain(x, 4)
    torch.testing.assert_close(got_mean, ref_mean, **MEAN_TOL)
    torch.testing.assert_close(got_cov, ref_cov, **COV_TOL)
    m64, c64 = _two_pass_f64(x[0].float())
    torch.testing.assert_close(got_mean[0].double(), m64, **MEAN_TOL)
    torch.testing.assert_close(got_cov[0].double(), c64, **COV_TOL)


@pytest.mark.cuda
def test_the_adapter_collect_forward_on_the_card_matches_the_cpu(cuda_device):
    """The serving adapter's collect forward (``serve.adapt``) on the tiny
    ResNet-DWT: one moments and one apply launch per whitened site for the
    3 domains, the advanced stats equal to the same collect on the CPU; the
    int8 engine's logits on the card equal its CPU twin's."""
    from dwt_tpu_torch.nn.registry import build_backbone
    from dwt_tpu_torch.serve.adapt import make_collect_fn
    from dwt_tpu_torch.serve.engine import ServeEngine

    x = np.random.default_rng(0).normal(size=(8, 32, 32, 3)).astype(np.float32) * 1.3 + 0.4
    results = []
    for device in ("cuda", "cpu"):
        engine = ServeEngine(build_backbone("tiny", num_classes=5, seed=0), (32, 32, 3),
                             buckets=(8,), device=device, quantize=True)
        before = (cuda_whitening.moments_launches, cuda_whitening.apply_launches)
        stats = make_collect_fn(engine)(engine.state, engine.state.batch_stats, x)
        launches = (cuda_whitening.moments_launches - before[0],
                    cuda_whitening.apply_launches - before[1])
        if device == "cuda":
            assert launches == (5, 5)
        assert {t.dtype for t in engine.state.params.values()} == {torch.int8}
        results.append(({k: v.cpu() for k, v in stats.items()}, engine.infer(x)))
    (ours, ours_logits), (ref, ref_logits) = results
    for k in ref:
        scale = float(ref[k].abs().max()) or 1.0
        torch.testing.assert_close(ours[k], ref[k], rtol=2e-4, atol=2e-4 * scale)
    np.testing.assert_allclose(ours_logits, ref_logits, rtol=2e-4,
                               atol=2e-4 * float(np.abs(ref_logits).max()))


def _holds_cuda_context(pid):
    """A descriptor of ``pid`` open on an NVIDIA device node: a CUDA
    context keeps ``/dev/nvidia*`` open.  (``nvidia-smi``'s compute-apps
    pids cannot tell the processes apart where they run in a pid
    namespace of their own: every one reads as pid 1.)"""
    fds = f"/proc/{pid}/fd"
    for fd in os.listdir(fds):
        try:
            if os.readlink(os.path.join(fds, fd)).startswith("/dev/nvidia"):
                return True
        except OSError:
            pass
    return False


@pytest.mark.cuda
def test_fleet_balancer_holds_no_cuda_context(cuda_device):
    """``python -m dwt_tpu_torch.fleet.balancer`` with one replica serving
    LeNet-DWT on the card: the replica reports ``cuda`` and holds a CUDA
    context; the balancer, which imports no torch, holds none; SIGTERM
    drains both to exit 0."""
    import json
    import signal
    import urllib.request

    proc = subprocess.Popen(
        [sys.executable, "-m", "dwt_tpu_torch.fleet.balancer", "--port", "0",
         "--replicas", "1", "--no-autoscale", "--", "--model", "lenet",
         "--init_random", "--buckets", "1,4"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        ready = json.loads(proc.stdout.readline())
        replica = ready["replicas"][0]
        with urllib.request.urlopen(f"http://127.0.0.1:{replica['port']}/healthz",
                                    timeout=30) as resp:
            assert json.loads(resp.read())["device"].startswith("cuda")
        assert _holds_cuda_context(replica["pid"])
        assert not _holds_cuda_context(proc.pid)
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=120) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
