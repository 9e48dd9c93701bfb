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
mid-stream.  The CPU-side
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
    x, mean, _ = _args(device=cuda_device)
    w8 = torch.eye(8, device=cuda_device).repeat(8, 1, 1)
    with pytest.raises(ValueError, match="group size"):
        cuda_whitening.whiten_apply(x, mean, w8)


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
        cuda_whitening.whiten_moments(x, 8)
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
    launch, replays included."""
    x = _domains(3, 56448, 256, cuda_device, seed=6, offset=2.0)
    eager = cuda_whitening.whiten_moments(x, 4)  # also warms up the shape
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    before = cuda_whitening.moments_launches
    with torch.cuda.graph(graph):
        captured = cuda_whitening.whiten_moments(x, 4)
    assert cuda_whitening.moments_launches == before + 1
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
    eager call's result bitwise."""
    x, mean, w = _apply_domains(2, 6272, 48, cuda_device, seed=6)
    eager = cuda_whitening.whiten_apply(x, mean, w)  # also warms up the shape
    out = torch.empty_like(x)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    before = cuda_whitening.apply_launches
    with torch.cuda.graph(graph):
        cuda_whitening.whiten_apply(x, mean, w, out=out)
    assert cuda_whitening.apply_launches == before + 1
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
    with pytest.raises(ValueError, match="group size"):
        cuda_whitening.whiten_apply(x, mean, torch.eye(8, device=cuda_device)
                                    .repeat(3, 8, 1, 1))
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
