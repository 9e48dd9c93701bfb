"""Hand-written CUDA whitening kernels — the port of ``dwt_tpu.ops.pallas_whitening``.

Two kernels, each in an f32 and a bf16 variant, each beside its plain
PyTorch version:

* ``whiten_moments(x, group_size)`` → per domain of ``x [D, M, C]``,
  ``(mean [D, C], cov [D, G, g, g])`` in f32, the biased batch moments of
  a whitened site's ``D`` domain branches in train mode, in one launch
  (``csrc/whiten_moments.cu``; replaces ``_moments_kernel``, launched by
  ``_moments_call``; ``x [M, C]`` gives ``[C]`` and ``[G, g, g]``), with
  ``g = min(C, group_size)`` as the op resolves it.  A bf16 ``x`` is
  widened to f32 as it is read, as ``_moments_kernel`` reads it.
* ``whiten_apply(x, mean, w)`` → ``y = (x − m) · W_bdᵀ`` with ``W_bd`` the
  block-diagonal expansion of ``w [G, g, g]``, for ``x [M, C]``, or per
  domain of ``x [D, M, C]`` with ``mean [D, C]`` and ``w [D, G, g, g]``,
  in one launch (``csrc/whiten_apply.cu``; replaces ``_apply_kernel``,
  launched by ``_apply_call``).  ``mean`` and ``w`` are f32; ``y`` has
  ``x``'s dtype.  For a bf16 ``x`` it rounds as ``_apply_kernel`` does:
  ``xn = bf16(f32(x) − m)``, ``w`` rounded to bf16, the products summed in
  f32 in the order ``c = 0, 1, …`` and rounded once to bf16.

Both take every group size ``g`` that divides C, up to C = 2048: ``g =
4`` through the kernels designed for it (one group per 16-byte chunk),
any other ``g`` through each source's general body (``*_group_*``
entries).

Dispatch, for both:

* A CUDA tensor launches the kernel of its dtype and group size (built
  with ``nvcc`` at first use, loaded with ``ctypes``) on the current
  stream, or raises: another dtype, a ``g`` that does not divide C, a C
  over the kernels' limit, a layout or device they do not take, a failed
  build and a refused launch are errors, never a fallback, and a bf16
  tensor is never widened to reach the f32 kernel.
* A CPU tensor takes the plain version of its dtype.

``moments_launches`` and ``apply_launches`` count kernel launches, so a run
can show that its main path went through the kernels.  Inside a CUDA graph
capture a wrapper records its launch and makes none: the count goes to the
open :func:`capture_launches` tally, and the graph's owner adds the tally
once per replay (:func:`count_replay`), where the kernels do launch.  At
``g = 4`` both kernels are bound by HBM bytes; at larger ``g`` their FMAs
grow with ``g``; see the notes in the ``.cu`` sources.

:class:`TrainWhiten` is the autograd seam of train mode, the counterpart of
the JAX package's ``_train_whiten`` custom VJP: the moments kernel once
for all domains of a site, the whitener's train matrix from the batch
covariance in its precision policy's dtype (in torch, outside any kernel,
batched over the domains), then the apply kernel once for all domains;
the backward recomputes the plain differentiable op
(:func:`dwt_tpu_torch.ops.whitening.group_whiten`) with the same whitener
and returns its gradient.  It looks both kernels up through this module
at call time, so a caller can swap in the plain versions.
:func:`cuda_group_whiten` is the drop-in counterpart of
``pallas_group_whiten`` and the one train-mode entry of the model's
whitening sites, for every whitener: SWBN, which the JAX package keeps off
its Pallas seam, runs through both kernels here (moments, the tracker's
step, the apply with the new matrix), the same function as its XLA op.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import threading
from typing import Dict, Iterator, Optional, Tuple

import torch

from dwt_tpu_torch.ops import _build, whitening

KERNEL_GROUP = 4  # the group size of the kernels designed for it
_STATS_PER_GROUP = 14  # their moments partials per group: 4 sums + 10 products

# Kernel launches since import (or since a caller reset them).  The
# serving dispatcher and the online adapter launch from two threads, so
# every increment holds _count_lock.
apply_launches = 0
moments_launches = 0
_count_lock = threading.Lock()
# The launches the open CUDA graph capture recorded, by kernel (None: no
# capture_launches block is open).
_recorded: Optional[Dict[str, int]] = None


def _count(kernel: str) -> None:
    """One launch of ``kernel`` (``"apply"`` or ``"moments"``), or, inside
    a graph capture, one recorded launch."""
    global apply_launches, moments_launches
    if torch.cuda.is_current_stream_capturing():
        if _recorded is not None:
            _recorded[kernel] += 1
        return
    with _count_lock:
        if kernel == "apply":
            apply_launches += 1
        else:
            moments_launches += 1


@contextlib.contextmanager
def capture_launches() -> Iterator[Dict[str, int]]:
    """Around a CUDA graph capture: yields the tally of the launches the
    capture records (``{"apply": n, "moments": n}``), filled on exit."""
    global _recorded
    _recorded = {"apply": 0, "moments": 0}
    try:
        yield _recorded
    finally:
        _recorded = None


def count_replay(recorded: Dict[str, int], replays: int = 1) -> None:
    """Count the launches of ``replays`` replays of a graph whose capture
    recorded ``recorded``."""
    global apply_launches, moments_launches
    with _count_lock:
        apply_launches += recorded["apply"] * replays
        moments_launches += recorded["moments"] * replays


# ------------------------------------------------------------------- apply

# The dtypes the kernels take for x: one library entry each.
KERNEL_DTYPES = (torch.float32, torch.bfloat16)
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


def _apply_low_plain(x: torch.Tensor, mean: torch.Tensor, w: torch.Tensor
                     ) -> torch.Tensor:
    """The bf16 apply of ``x [M, C]`` (any dtype below f32) with f32 ``mean
    [C]`` and ``w [G, g, g]``, at the bf16 kernel's rounding points:
    ``xn = bf16(f32(x) − m)``, ``bf16(w)``, the exact f32 products summed
    over ``c = 0, 1, …`` in that order, one rounding to ``x``'s dtype."""
    num_groups, g = w.shape[0], w.shape[1]
    xn = (x.float() - mean.float()).to(x.dtype).float().view(-1, num_groups, g)
    wb = w.to(x.dtype).float()  # [G, d, c]
    y = xn[..., 0:1] * wb[:, :, 0]
    for c in range(1, g):
        y = y + xn[..., c:c + 1] * wb[:, :, c]
    return y.to(x.dtype).reshape(x.shape)


def whiten_apply_plain(
    x: torch.Tensor, mean: torch.Tensor, w: torch.Tensor,
    out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``(x − m) · W_bdᵀ`` as the grouped einsum of
    ``dwt_tpu/ops/whitening.py:418-425``: ``x [M, C]``, ``mean [C]``,
    ``w [G, g, g]`` → ``[M, C]``; or per domain of ``x [D, M, C]`` with
    ``mean [D, C]``, ``w [D, G, g, g]`` → ``[D, M, C]`` (written into
    ``out`` when given).  A bf16 ``x`` takes the bf16 kernel's rounding
    points (:func:`_apply_low_plain`)."""
    if x.dim() == 3:
        y = torch.empty_like(x) if out is None else out
        for d in range(x.shape[0]):
            whiten_apply_plain(x[d], mean[d], w[d], out=y[d])
        return y
    if x.dtype.itemsize < 4:
        y = _apply_low_plain(x, mean, w)
    else:
        num_groups, g = w.shape[0], w.shape[1]
        t = (x - mean).view(-1, num_groups, g)
        y = torch.einsum("mgc,gdc->mgd", t, w).reshape(x.shape)
    if out is None:
        return y
    return out.copy_(y)


def _library(name: str) -> ctypes.CDLL:
    lib = _build.load(name)
    if getattr(lib, "_dwt_bound", False):
        return lib
    v, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    if name == "whiten_apply":
        for sfx in ("f32", "bf16"):
            entry = getattr(lib, f"dwt_whiten_apply_{sfx}")
            entry.argtypes = [v, v, v, v, i64, i64, i32, i32, v]
            entry.restype = i32
        for entry in (lib.dwt_whiten_apply_blocks, lib.dwt_whiten_apply_blocks_bf16):
            entry.argtypes = [i64, i64, i32]
            entry.restype = i32
        for sfx in ("f32", "bf16"):
            entry = getattr(lib, f"dwt_whiten_apply_group_{sfx}")
            entry.argtypes = [v, v, v, v, i64, i64, i32, i32, v]
            entry.restype = i32
        lib.dwt_whiten_apply_group_plan.argtypes = [
            i64, i64, i32, i32, i32, ctypes.POINTER(ctypes.c_longlong)]
        lib.dwt_whiten_apply_group_plan.restype = i32
        lib.dwt_whiten_apply_max_channels.argtypes = []
        lib.dwt_whiten_apply_max_channels.restype = i32
    else:
        for sfx in ("f32", "bf16"):
            entry = getattr(lib, f"dwt_whiten_moments_{sfx}")
            entry.argtypes = [v, v, v, v, v, i64, i64, i32, i32, v]
            entry.restype = i32
        for entry in (lib.dwt_whiten_moments_clusters,
                      lib.dwt_whiten_moments_clusters_bf16):
            entry.argtypes = [i64, i64, i32]
            entry.restype = i32
        lib.dwt_whiten_moments_max_channels.argtypes = []
        lib.dwt_whiten_moments_max_channels.restype = i32
        lib.dwt_whiten_moments_max_domains.argtypes = []
        lib.dwt_whiten_moments_max_domains.restype = i32
        for sfx in ("f32", "bf16"):
            entry = getattr(lib, f"dwt_whiten_moments_group_{sfx}")
            entry.argtypes = [v, v, v, v, v, i64, i64, i32, i32, i32, v]
            entry.restype = i32
        lib.dwt_whiten_moments_group_plan.argtypes = [
            i64, i64, i32, i32, i32, ctypes.POINTER(ctypes.c_longlong)]
        lib.dwt_whiten_moments_group_plan.restype = i32
        lib.dwt_whiten_moments_group_max_counters.argtypes = []
        lib.dwt_whiten_moments_group_max_counters.restype = i32
    lib.dwt_cuda_error_string.argtypes = [i32]
    lib.dwt_cuda_error_string.restype = ctypes.c_char_p
    lib._dwt_bound = True
    return lib


def _raise_on_error(lib: ctypes.CDLL, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(
            f"{what} kernel failed: CUDA error {rc} "
            f"({lib.dwt_cuda_error_string(rc).decode()})"
        )


def _check_kernel_dtype(what: str, x: torch.Tensor) -> None:
    if x.dtype not in KERNEL_DTYPES:
        raise TypeError(f"{what}: x must be float32 or bfloat16, got {x.dtype}")


def _check_apply_args(
    x: torch.Tensor, mean: torch.Tensor, w: torch.Tensor,
    out: Optional[torch.Tensor],
) -> None:
    """Raise unless the kernel takes these arguments: ``x [M, C]`` with
    ``mean [C]`` and ``w [C/g, g, g]``, or ``x [D, M, C]`` with ``mean
    [D, C]`` and ``w [D, C/g, g, g]``, for a ``g`` that divides C; ``out``
    shaped like ``x``; ``x`` and ``out`` float32 with C a multiple of 4,
    or bfloat16 with C a multiple of 8, ``mean`` and ``w`` float32; all
    dense (a ``[D, M, C]`` whose domains are not one contiguous block is
    refused, not copied), 16-byte aligned and on ``x``'s device."""
    shape, w_shape = x.shape, w.shape
    if len(shape) not in (2, 3):
        raise ValueError(
            f"whiten_apply: x must be [M, C] or [D, M, C], got {tuple(shape)}")
    lead, c = shape[:-2], shape[-1]
    if len(w_shape) != len(shape) + 1 or w_shape[-1] != w_shape[-2]:
        raise ValueError(f"whiten_apply: w must be [{'D, ' if lead else ''}G, g, g] "
                         f"for x {tuple(shape)}, got {tuple(w_shape)}")
    g = w_shape[-1]
    if g < 1 or c % g:
        raise ValueError(
            f"whiten_apply: group size {g} does not divide C={c}")
    if w_shape[:-2] != (*lead, c // g) or mean.shape != (*lead, c):
        raise ValueError(
            f"whiten_apply: shapes disagree: x {tuple(shape)}, "
            f"mean {tuple(mean.shape)}, w {tuple(w_shape)}"
        )
    if c > _apply_max_channels():
        raise ValueError(
            f"whiten_apply: C={c} exceeds the kernel's "
            f"{_apply_max_channels()} channels")
    if out is not None and out.shape != shape:
        raise ValueError(
            f"whiten_apply: out is {tuple(out.shape)}, x {tuple(shape)}")
    _check_kernel_dtype("whiten_apply", x)
    if c % 4:
        raise ValueError(f"whiten_apply: the kernels take C a multiple of 4 "
                         f"(16-byte chunks), got C={c}")
    if x.dtype is torch.bfloat16 and c % 8:
        raise ValueError(f"whiten_apply: the bf16 kernel takes C a multiple "
                         f"of 8 (16-byte chunks of 8 channels), got C={c}")
    # Dtype, device, density and alignment in one pass: this runs on every
    # launch, on the host's critical path.
    device = x.device
    for name, t, dtype in (("x", x, x.dtype), ("mean", mean, torch.float32),
                           ("w", w, torch.float32), ("out", out, x.dtype)):
        if t is None:
            continue
        if t.dtype is not dtype:
            raise TypeError(f"whiten_apply: {name} must be "
                            f"{str(dtype).split('.')[1]}, got {t.dtype}")
        if t.device != device:
            raise ValueError(f"whiten_apply: {name} is on {t.device}, x on {device}")
        if not t.is_contiguous():
            raise ValueError(f"whiten_apply: {name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError("whiten_apply: x, mean, w and out must be 16-byte "
                             "aligned (16-byte loads)")


@functools.lru_cache(maxsize=None)
def _apply_max_channels() -> int:
    return _library("whiten_apply").dwt_whiten_apply_max_channels()


@functools.lru_cache(maxsize=None)
def _apply_grid(device_index: int, domains: int, m_rows: int, c: int,
                dtype: torch.dtype = torch.float32) -> int:
    """Blocks per domain of the ``dtype`` kernel's launch for ``[domains,
    m_rows, c]`` on a device: an occupancy query, asked once per shape."""
    lib = _library("whiten_apply")
    query = (lib.dwt_whiten_apply_blocks if dtype is torch.float32
             else lib.dwt_whiten_apply_blocks_bf16)
    with torch.cuda.device(device_index):
        blocks = query(domains, m_rows, c)
    _raise_on_error(lib, -min(blocks, 0), "whiten_apply")
    return blocks


@functools.lru_cache(maxsize=None)
def _apply_launch(dtype: torch.dtype = torch.float32, general: bool = False):
    """The ``dtype`` kernel's bound C entry (loaded, and built if needed,
    once); ``general``: the entry of any group size but 4."""
    infix = "group_" if general else ""
    return getattr(_library("whiten_apply"),
                   f"dwt_whiten_apply_{infix}{_SUFFIX[dtype]}")


def _apply_group_plan(device_index: int, domains: int, m_rows: int, c: int,
                      g: int, dtype: torch.dtype) -> Tuple[int, ...]:
    """``(threads, shared-memory bytes, blocks, output channels per column
    tile, input channels per chunk, ring stages, transposed path, bytes
    per copy)`` of the tiled general
    apply's launch for ``[domains, m_rows, c]`` at a group size ``g`` that
    is a multiple of 4 from 8 up, on a device (the launcher asks the same
    itself; this is for reports)."""
    lib = _library("whiten_apply")
    out = (ctypes.c_longlong * 8)()
    with torch.cuda.device(device_index):
        rc = lib.dwt_whiten_apply_group_plan(
            domains, m_rows, c, g, int(dtype is torch.bfloat16), out)
    _raise_on_error(lib, rc, "whiten_apply")
    return tuple(out)


def whiten_apply(
    x: torch.Tensor, mean: torch.Tensor, w: torch.Tensor,
    out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``(x − m) · W_bdᵀ``: the CUDA kernel of ``x``'s dtype for a CUDA
    ``x``, the plain version for a CPU one.  ``x [M, C]`` with ``mean [C]``
    and ``w [C/g, g, g]`` (eval and serving: one site, one branch), or ``x
    [D, M, C]`` with ``mean [D, C]`` and ``w [D, C/g, g, g]`` (train mode:
    all D domains of a site, each with its own moments and matrix); ``x``
    f32 or bf16, ``mean`` and ``w`` f32, dense, 16-byte aligned, all on
    ``x``'s device.  One launch per call, whatever ``D``.  The result, in
    ``x``'s dtype, goes to ``out`` (shaped like ``x``) when given, else to
    a new tensor."""
    if x.device.type == "cpu":
        return whiten_apply_plain(x, mean, w, out)
    if x.device.type != "cuda":
        raise ValueError(f"whiten_apply: unsupported device {x.device}")
    _check_apply_args(x, mean, w, out)
    y = torch.empty_like(x) if out is None else out
    if x.numel() == 0:
        return y
    domains = x.shape[0] if x.dim() == 3 else 1
    m_rows, c = x.shape[-2:]
    index, g = x.device.index, w.shape[-1]
    # The g = 4 entry takes its blocks per domain; the general one takes g
    # (its grid follows from the shape).
    blocks_or_g = (_apply_grid(index, domains, m_rows, c, x.dtype)
                   if g == KERNEL_GROUP else g)
    args = (x.data_ptr(), mean.data_ptr(), w.data_ptr(), y.data_ptr(),
            domains, m_rows, c, blocks_or_g)
    launch = _apply_launch(x.dtype, g != KERNEL_GROUP)
    if index == torch.cuda.current_device():
        rc = launch(*args, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(index):
            rc = launch(*args, torch._C._cuda_getCurrentRawStream(index))
    if rc:
        _raise_on_error(_library("whiten_apply"), rc, "whiten_apply")
    _count("apply")
    return y


# ----------------------------------------------------------------- moments


def whiten_moments_plain(
    x: torch.Tensor, group_size: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The biased moments of ``x [D, M, C]`` per domain, ``(mean [D, C],
    cov [D, G, g, g])``, or of ``x [M, C]``, ``(mean [C], cov [G, g, g])``,
    in at least f32 (a bf16 ``x`` widened first, as the kernel reads it).
    Per domain: the mean, then
    :func:`~dwt_tpu_torch.ops.whitening.group_cov` of the centred input, as
    ``dwt_tpu/ops/whitening.py:693-698`` computes them."""
    if x.dim() == 3:
        means, covs = zip(*(whiten_moments_plain(xd, group_size) for xd in x))
        return torch.stack(means), torch.stack(covs)
    num_groups, g = whitening._resolve_groups(x.shape[-1], group_size)
    x = x.to(torch.promote_types(x.dtype, torch.float32))
    mean = x.mean(dim=0)
    return mean, whitening.group_cov(x - mean, num_groups, g)


def _check_moments_args(x: torch.Tensor, group_size: int) -> int:
    """Raise unless the kernel takes ``x`` at ``group_size``; returns the
    resolved ``g = min(C, group_size)``."""
    if x.dim() not in (2, 3):
        raise ValueError(
            f"whiten_moments: x must be [M, C] or [D, M, C], got {tuple(x.shape)}")
    m_rows, c = x.shape[-2:]
    if m_rows < 1 or x.numel() == 0:
        raise ValueError("whiten_moments: x has no rows")
    g = min(c, group_size)
    if g < 1 or c % g:
        raise ValueError(
            f"whiten_moments: group size {group_size} does not divide C={c}")
    _check_kernel_dtype("whiten_moments", x)
    # is_contiguous() of the whole tensor: a [D, M, C] whose domains lie
    # apart in memory (a strided view) is refused, not copied.
    if not x.is_contiguous():
        raise ValueError("whiten_moments: x must be contiguous")
    if x.data_ptr() % 16:
        raise ValueError("whiten_moments: x must be 16-byte aligned "
                         "(16-byte loads)")
    return g


@functools.lru_cache(maxsize=None)
def _moments_grid(device_index: int, domains: int, m_rows: int, c: int,
                  dtype: torch.dtype = torch.float32) -> Tuple[int, int]:
    """``(clusters per domain, float64 scratch elements)`` of the ``dtype``
    kernel's launch for ``[domains, m_rows, c]`` on a device: an occupancy
    query, asked once per shape.  Raises for a ``domains`` or ``c`` the
    kernel does not take."""
    lib = _library("whiten_moments")
    _check_moments_size(lib, domains, c)
    query = (lib.dwt_whiten_moments_clusters if dtype is torch.float32
             else lib.dwt_whiten_moments_clusters_bf16)
    with torch.cuda.device(device_index):
        clusters = query(domains, m_rows, c)
    _raise_on_error(lib, -min(clusters, 0), "whiten_moments")
    return clusters, domains * clusters * (c // KERNEL_GROUP) * _STATS_PER_GROUP


def _check_moments_size(lib: ctypes.CDLL, domains: int, c: int) -> None:
    if c > lib.dwt_whiten_moments_max_channels():
        raise ValueError(
            f"whiten_moments: C={c} exceeds the kernel's "
            f"{lib.dwt_whiten_moments_max_channels()} channels"
        )
    if domains > lib.dwt_whiten_moments_max_domains():
        raise ValueError(
            f"whiten_moments: D={domains} exceeds the kernel's "
            f"{lib.dwt_whiten_moments_max_domains()} domains"
        )


@functools.lru_cache(maxsize=None)
def _moments_group_plan(device_index: int, domains: int, m_rows: int, c: int,
                        g: int, dtype: torch.dtype) -> Tuple[int, int, int]:
    """``(clusters per domain and entry tile, float64 scratch elements,
    arrival counters)`` of the general kernel's launch for ``[domains,
    m_rows, c]`` at group size ``g`` on a device, asked once per shape."""
    lib = _library("whiten_moments")
    _check_moments_size(lib, domains, c)
    out = (ctypes.c_longlong * 3)()
    with torch.cuda.device(device_index):
        rc = lib.dwt_whiten_moments_group_plan(
            domains, m_rows, c, g, int(dtype is torch.bfloat16), out)
    _raise_on_error(lib, rc, "whiten_moments")
    return out[0], out[1], out[2]


_arrival_counters: Dict[Tuple[int, bool], torch.Tensor] = {}


def _arrival_counter(device: torch.device, general: bool = False) -> torch.Tensor:
    """The kernel's arrival counters on ``device``, zeroed once here; every
    launch leaves them zero.  The g = 4 kernel keeps one int32 per domain
    it takes, the general one (``general``) one per domain and entry
    tile."""
    counter = _arrival_counters.get((device.index, general))
    if counter is None:
        lib = _library("whiten_moments")
        size = (lib.dwt_whiten_moments_group_max_counters() if general
                else lib.dwt_whiten_moments_max_domains())
        counter = _arrival_counters[(device.index, general)] = torch.zeros(
            size, dtype=torch.int32, device=device)
    return counter


def whiten_moments(
    x: torch.Tensor, group_size: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The biased moments of ``x [D, M, C]`` per domain, ``(mean [D, C],
    cov [D, C/g, g, g])`` with ``g = min(C, group_size)`` (of ``x [M,
    C]``: ``(mean [C], cov [C/g, g, g])``), f32: the CUDA kernel of
    ``x``'s dtype for a CUDA ``x`` (f32 or bf16, one contiguous block, a
    ``g`` that divides C), the plain version for a CPU one.  One launch per
    call, whatever ``D``.

    Launches on the current stream.  Calls on two streams at once are not
    supported: all launches on a device share the arrival counters."""
    if x.device.type == "cpu":
        return whiten_moments_plain(x, group_size)
    if x.device.type != "cuda":
        raise ValueError(f"whiten_moments: unsupported device {x.device}")
    g = _check_moments_args(x, group_size)
    domains = x.shape[0] if x.dim() == 3 else 1
    m_rows, c = x.shape[-2:]
    groups, device = c // g, x.device
    general = g != KERNEL_GROUP
    if general:
        clusters, scratch_len, _ = _moments_group_plan(
            device.index, domains, m_rows, c, g, x.dtype)
    else:
        clusters, scratch_len = _moments_grid(device.index, domains, m_rows, c, x.dtype)
    lib = _library("whiten_moments")
    out = torch.empty(domains * (c + groups * g * g),
                      dtype=torch.float32, device=device)
    mean = out[: domains * c].view(domains, c)
    cov = out[domains * c:].view(domains, groups, g, g)
    scratch = torch.empty(scratch_len, dtype=torch.float64, device=device)
    counters = _arrival_counter(device, general).data_ptr()
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        if general:
            rc = getattr(lib, f"dwt_whiten_moments_group_{_SUFFIX[x.dtype]}")(
                x.data_ptr(), mean.data_ptr(), cov.data_ptr(), scratch.data_ptr(),
                counters, domains, m_rows, c, g, clusters, stream)
        else:
            rc = getattr(lib, f"dwt_whiten_moments_{_SUFFIX[x.dtype]}")(
                x.data_ptr(), mean.data_ptr(), cov.data_ptr(), scratch.data_ptr(),
                counters, domains, m_rows, c, clusters, stream)
    _raise_on_error(lib, rc, "whiten_moments")
    _count("moments")
    if x.dim() == 2:
        return mean[0], cov[0]
    return mean, cov


# ---------------------------------------------------- differentiable train path


def _pure_train_y(x2d: torch.Tensor, group_size: int, eps: float,
                  whitener=None, w_prev: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    """The plain op's train-mode output (``y`` only) — the recompute of
    the backward.  Train-mode ``y`` does not depend on the running mean
    and cov, so fresh ones stand in; SWBN's depends on its tracked matrix,
    ``w_prev``, the one the forward read."""
    whitener = whitening.get_whitener(whitener)
    stats = whitener.init_stats(x2d.shape[-1], group_size, device=x2d.device)
    if w_prev is not None:
        stats = stats._replace(w=w_prev)
    y, _ = whitening.group_whiten(
        x2d, stats, group_size=group_size, train=True, eps=eps,
        whitener=whitener,
    )
    return y


def _pure_train_y_group(x: torch.Tensor, group_size: int, eps: float, whitener,
                        w_prev: Optional[torch.Tensor], group) -> torch.Tensor:
    """The group-aware plain op's train-mode output for all ``D`` domains of
    ``x [D, M, C]`` (this rank's rows) — the recompute of the backward
    under a process group: each domain's mean averaged over the ranks, its
    centred covariance summed over them with the global count
    (``whitening.group_whiten(..., group=)``'s numerics, one differentiable
    all-reduce for all domains' means and one for their covariances), so
    its gradient is the global batch's."""
    whitener = whitening.get_whitener(whitener)
    d, _, c = x.shape
    groups, g = whitening._resolve_groups(c, group_size)
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    m = group.psum(xf.mean(dim=1)) / group.size
    xn = xf - m[:, None, :]
    t = xn.reshape(d, -1, groups, g)
    cov = group.psum(torch.stack([whitening.group_cov_sum(t[i]) for i in range(d)]))
    cov = cov / (t.shape[1] * group.size)
    stats = None if w_prev is None else whitening.SWBNStats(None, None, w_prev)
    w, _ = whitener.train_matrix(cov.to(whitener.precision_policy(x.dtype)), stats, eps)
    return torch.stack([whitening.apply_whitening(xn[i], w[i], compute_dtype=x.dtype)
                        for i in range(d)]).to(x.dtype)


def combine_moments(means: torch.Tensor, covs: torch.Tensor, group
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The global batch's moments from each rank's ``(means [D, C], covs
    [D, G, g, g])`` of an equal number of rows, in float64 with one
    all-reduce: ``μ = E_r[μ_r]`` and, per group block, ``Σ = E_r[Σ_r +
    μ_r μ_rᵀ] − μ μᵀ`` (Chan's combination); returned in f32."""
    d, c = means.shape
    groups, g = covs.shape[1], covs.shape[2]
    mu = means.double().view(d, groups, g)
    second = covs.double() + mu.unsqueeze(-1) * mu.unsqueeze(-2)
    buf = torch.cat([mu.reshape(-1), second.reshape(-1)])
    group.psum_(buf)
    buf /= group.size
    gmu = buf[: d * c].view(d, groups, g)
    gcov = buf[d * c:].view(d, groups, g, g) - gmu.unsqueeze(-1) * gmu.unsqueeze(-2)
    return gmu.reshape(d, c).float(), gcov.float()


class TrainWhiten(torch.autograd.Function):
    """Train-mode whitening of ``x [D, M, C]`` (f32 or bf16), each domain
    ``d`` with the batch moments of its own slice ``x[d]``.

    Forward: :func:`whiten_moments` once on the whole ``[D, M, C]`` (one
    launch per site), the whitener's ``train_matrix`` of the f32 batch
    covariances in its ``precision_policy(x.dtype)`` once over ``[D, G, g,
    g]`` (SWBN: the tracker's step from ``w_prev [D, G, g, g]``, the
    matrices its stats held), then :func:`whiten_apply` once on the whole
    ``[D, M, C]`` (one launch per site), each domain with its own moments
    and matrix.  Returns ``(y [D, M, C], means [D, C], covs [D, G, g,
    g])``, and for SWBN also the new tracked matrices ``[D, G, g, g]``;
    all but ``y`` are non-differentiable (the running-stat EMA is
    detached).

    Backward: like ``_train_whiten_bwd``, the plain train-mode op with the
    same whitener is recomputed on the saved ``x`` under
    ``torch.enable_grad()`` and its gradient returned; SWBN's recompute
    reads a copy of ``w_prev`` taken in the forward (the site overwrites
    its buffer in place after the forward).  The recompute never touches
    running stats, so they advance once per forward.

    Under a process ``group`` (a :class:`~dwt_tpu_torch.parallel.mesh.Mesh`)
    ``x`` is this rank's rows: the moments kernel runs on them, one launch
    as ever, and :func:`combine_moments` makes the global batch's moments
    of them with one float64 all-reduce per site; the train matrix and the
    apply kernel then use the global moments.  The backward recomputes the
    group-aware plain op (:func:`_pure_train_y_group`), whose gradient is
    the global batch's.
    """

    @staticmethod
    def forward(ctx, x: torch.Tensor, group_size: int, eps: float,
                whitener=None, w_prev: Optional[torch.Tensor] = None, group=None):
        whitener = whitening.get_whitener(whitener)
        ctx.group_size, ctx.eps, ctx.whitener = group_size, eps, whitener
        ctx.group = group
        ctx.w_prev = None if w_prev is None else w_prev.detach().clone()
        ctx.save_for_backward(x)
        y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
        # Grad mode is already off inside Function.forward; explicit here
        # because nothing below may record a graph.
        with torch.no_grad():
            means, covs = whiten_moments(x, group_size)
            if group is not None:
                means, covs = combine_moments(means, covs, group)
            # A train matrix reads no running stat but SWBN's tracked w.
            stats = (None if ctx.w_prev is None
                     else whitening.SWBNStats(None, None, ctx.w_prev))
            ws, aux = whitener.train_matrix(
                covs.to(whitener.precision_policy(x.dtype)), stats, eps)
            whiten_apply(x, means, ws.to(means.dtype), out=y)
        if aux is None:
            ctx.mark_non_differentiable(means, covs)
            return y, means, covs
        ctx.mark_non_differentiable(means, covs, aux)
        return y, means, covs, aux

    @staticmethod
    def backward(ctx, gy, *_grads_of_moments):
        (x,) = ctx.saved_tensors
        with torch.enable_grad():
            xr = x.detach().requires_grad_(True)
            if ctx.group is not None:
                ys = [_pure_train_y_group(xr, ctx.group_size, ctx.eps, ctx.whitener,
                                          ctx.w_prev, ctx.group)]
                gys = [gy.to(x.dtype)]
            else:
                ys = [_pure_train_y(xr[d], ctx.group_size, ctx.eps, ctx.whitener,
                                    None if ctx.w_prev is None else ctx.w_prev[d])
                      for d in range(x.shape[0])]
                gys = list(gy.to(x.dtype))
            (dx,) = torch.autograd.grad(ys, xr, gys)
        return dx, None, None, None, None, None


def cuda_group_whiten(
    x: torch.Tensor,
    stats,
    *,
    group_size: int,
    train: bool,
    momentum: float = 0.1,
    eps: float = 1e-3,
    whitener=None,
    group=None,
):
    """Drop-in for :func:`dwt_tpu_torch.ops.whitening.group_whiten` through
    the kernels (single device, any whitener) — ``pallas_group_whiten``'s
    counterpart.  ``x [..., C]`` (f32 or bf16) must be viewable as ``[M,
    C]`` without a copy.  Train mode returns the EMA-updated (new,
    detached) stats.

    Train mode also takes the ``D`` branches of a domain site at once:
    with ``stats`` stacked on a leading domain axis (``mean [D, C]``,
    ``cov [D, G, g, g]``), ``x [D, ..., C]`` is split on its leading axis
    and domain ``d`` is whitened with the batch moments of ``x[d]`` and
    advances branch ``d`` — what :class:`~dwt_tpu_torch.nn.norms.DomainWhiten`
    calls.  Eval mode applies the f32 eval matrix and the f32 running mean
    (the JAX kernel path's ``pallas_group_whiten``).  ``group`` (train
    mode): ``x`` is this rank's rows and the moments the global batch's
    (:class:`TrainWhiten`)."""
    c = x.shape[-1]
    _, g = whitening._resolve_groups(c, group_size)
    whitener = whitening.get_whitener(whitener)
    if train:
        stacked = stats.mean.dim() == 2
        w_prev = getattr(stats, "w", None)
        if w_prev is not None and not stacked:
            w_prev = w_prev[None]
        y, mean, cov, *aux = TrainWhiten.apply(
            x.view(x.shape[0] if stacked else 1, -1, c), g, eps, whitener, w_prev, group)
        aux = aux[0] if aux else None
        if not stacked:
            mean, cov = mean[0], cov[0]
            aux = None if aux is None else aux[0]
        return (y.view(x.shape),
                whitener.update_stats(stats, mean, cov, momentum, aux))
    dtype = torch.promote_types(x.dtype, torch.float32)
    w = whitener.eval_matrix(stats, eps, dtype)
    return whiten_apply(x.view(-1, c), stats.mean.to(dtype), w).view(x.shape), stats
