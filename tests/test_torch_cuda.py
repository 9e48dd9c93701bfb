"""The port's CUDA kernels on the card, and their CPU-side dispatch.

Tests marked ``cuda`` need a GPU and skip without one; run them on a
machine with the card (no JAX needed there)::

    python -m pytest tests/test_torch_cuda.py -q

The whitening-apply kernel is held to its plain PyTorch version on the
same device, ``rtol = atol = 1e-5`` (both sum 4 products per output, in
different orders).  The CPU-side tests check the dispatch rules: a CPU
tensor takes the plain version, any other device raises, and
``chip_smoke.py`` refuses to run without CUDA.
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
