"""Hand-written CUDA whitening apply — the port of ``dwt_tpu.ops.pallas_whitening``'s
``_apply_kernel`` (launched there by ``_apply_call``).

``whiten_apply(x2d, mean, w)`` computes ``y = (x − m) · W_bdᵀ`` with
``W_bd`` the block-diagonal expansion of ``w [G, 4, 4]`` — the eval-mode
apply at every whitened site.

* A CUDA tensor launches ``csrc/whiten_apply.cu`` (built with ``nvcc``
  at first use, loaded with ``ctypes``) on the current stream, or
  raises: wrong dtype, group size, layout or device, a failed build and
  a refused launch are errors, never a fallback.
* A CPU tensor takes :func:`whiten_apply_plain`, the same function in
  plain PyTorch — the JAX op's grouped einsum.

``apply_launches`` counts kernel launches, so a run can show that its
main path went through the kernel.  The kernel is bound by HBM bytes
(one read and one write of ``x``); see the note at the head of the
``.cu`` source for the design.
"""

from __future__ import annotations

import ctypes

import torch

from dwt_tpu_torch.ops import _build

GROUP_SIZE = 4  # the only group size the kernel takes (the reference's)

# Kernel launches since import (or since a caller reset it).
apply_launches = 0


def whiten_apply_plain(
    x2d: torch.Tensor, mean: torch.Tensor, w: torch.Tensor
) -> torch.Tensor:
    """``(x − m) · W_bdᵀ`` as the grouped einsum of
    ``dwt_tpu/ops/whitening.py:418-425``: ``x2d [M, C]``, ``mean [C]``,
    ``w [G, g, g]`` → ``[M, C]``."""
    num_groups, g = w.shape[0], w.shape[1]
    t = (x2d - mean).view(-1, num_groups, g)
    return torch.einsum("mgc,gdc->mgd", t, w).reshape(x2d.shape)


def _library() -> ctypes.CDLL:
    lib = _build.load("whiten_apply")
    if not getattr(lib, "_dwt_bound", False):
        lib.dwt_whiten_apply_f32.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_void_p,
        ]
        lib.dwt_whiten_apply_f32.restype = ctypes.c_int
        lib.dwt_whiten_apply_max_channels.argtypes = []
        lib.dwt_whiten_apply_max_channels.restype = ctypes.c_int
        lib.dwt_cuda_error_string.argtypes = [ctypes.c_int]
        lib.dwt_cuda_error_string.restype = ctypes.c_char_p
        lib._dwt_bound = True
    return lib


def _check_cuda_args(
    x2d: torch.Tensor, mean: torch.Tensor, w: torch.Tensor
) -> None:
    if x2d.dim() != 2:
        raise ValueError(f"whiten_apply: x2d must be [M, C], got {tuple(x2d.shape)}")
    m_rows, c = x2d.shape
    if w.dim() != 3 or w.shape[1] != w.shape[2]:
        raise ValueError(f"whiten_apply: w must be [G, g, g], got {tuple(w.shape)}")
    if w.shape[1] != GROUP_SIZE:
        raise ValueError(
            f"whiten_apply: the CUDA kernel takes group size {GROUP_SIZE}, "
            f"got {w.shape[1]}"
        )
    if w.shape[0] * GROUP_SIZE != c or tuple(mean.shape) != (c,):
        raise ValueError(
            f"whiten_apply: shapes disagree: x2d {tuple(x2d.shape)}, "
            f"mean {tuple(mean.shape)}, w {tuple(w.shape)}"
        )
    for name, t in (("x2d", x2d), ("mean", mean), ("w", w)):
        if t.dtype != torch.float32:
            raise TypeError(f"whiten_apply: {name} must be float32, got {t.dtype}")
        if t.device != x2d.device:
            raise ValueError(
                f"whiten_apply: {name} is on {t.device}, x2d on {x2d.device}"
            )
        if not t.is_contiguous():
            raise ValueError(f"whiten_apply: {name} must be contiguous")
    if x2d.data_ptr() % 16:
        raise ValueError("whiten_apply: x2d must be 16-byte aligned (float4 loads)")


def whiten_apply(
    x2d: torch.Tensor, mean: torch.Tensor, w: torch.Tensor
) -> torch.Tensor:
    """``(x − m) · W_bdᵀ``: the CUDA kernel for a CUDA ``x2d``, the plain
    version for a CPU one.  ``x2d [M, C]`` f32 contiguous, ``mean [C]``
    f32, ``w [C/4, 4, 4]`` f32, all on ``x2d``'s device."""
    global apply_launches
    if x2d.device.type == "cpu":
        return whiten_apply_plain(x2d, mean, w)
    if x2d.device.type != "cuda":
        raise ValueError(f"whiten_apply: unsupported device {x2d.device}")
    _check_cuda_args(x2d, mean, w)
    lib = _library()
    m_rows, c = x2d.shape
    if c > lib.dwt_whiten_apply_max_channels():
        raise ValueError(
            f"whiten_apply: C={c} exceeds the kernel's "
            f"{lib.dwt_whiten_apply_max_channels()} channels"
        )
    y = torch.empty_like(x2d)
    with torch.cuda.device(x2d.device):
        stream = torch.cuda.current_stream(x2d.device).cuda_stream
        rc = lib.dwt_whiten_apply_f32(
            x2d.data_ptr(), mean.data_ptr(), w.data_ptr(), y.data_ptr(),
            m_rows, c, stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"whiten_apply kernel failed: CUDA error {rc} "
            f"({lib.dwt_cuda_error_string(rc).decode()})"
        )
    apply_launches += 1
    return y
