"""The input pipeline's native (C++) pixel passes — ``dwt_tpu.native``, copied, without its fallback.

``augment.cpp`` (the JAX package's source, byte for byte) fuses the
per-item tail of the OfficeHome transforms into one pass over the uint8
image: ``ToArray → Normalize`` (:func:`normalize_from_u8`) and
``ToArray → warpAffine → Normalize`` (:func:`warp_affine_normalize_from_u8`).
It is a host library called through ``ctypes``, which releases the GIL
for the call, so the loader's worker threads run it in parallel.

The library builds with ``g++ -O3 -shared -fPIC -std=c++17`` (the JAX
package's flags) at first use into ``build/native/`` at the root of the
checkout, a directory ``.gitignore`` lists; the file name carries a
digest of the source and the flags, so an edited source never loads a
stale library.  Each process builds to a file of its own and renames it
into place, so processes that build at once never load a half-written
file.  Unlike the JAX package, a failed build raises: the numpy path
rounds differently (by up to ~0.02 in normalized units on noisy images),
so a silent switch would make the numerics depend on the machine.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "augment.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib = None


def library_path() -> Path:
    digest = hashlib.sha256(
        SRC.read_bytes() + " ".join(GXX_FLAGS).encode()
    ).hexdigest()[:12]
    return BUILD_DIR / f"_dwtnative-{digest}.so"


def build() -> Path:
    """Compile ``augment.cpp`` unless it is built; returns the library's
    path.  Raises when there is no compiler or the build fails."""
    out = library_path()
    if out.exists():
        return out
    gxx = shutil.which("g++") or shutil.which("c++")
    if gxx is None:
        raise RuntimeError("no C++ compiler (g++ or c++) on PATH: the "
                           "native pixel passes of dwt_tpu_torch need one")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    try:
        proc = subprocess.run([gxx, *GXX_FLAGS, "-o", str(tmp), str(SRC)],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed for {SRC.name}:\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
    return out


def load() -> ctypes.CDLL:
    """The library's handle, built at the first call (under a lock, so
    worker threads that arrive together build it once)."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            f32p = ctypes.POINTER(ctypes.c_float)
            u8p = ctypes.POINTER(ctypes.c_uint8)
            lib.dwt_norm_u8.argtypes = [
                u8p, ctypes.c_longlong, ctypes.c_int, f32p, f32p, f32p]
            lib.dwt_norm_u8.restype = None
            lib.dwt_warp_affine_norm_u8.argtypes = [
                u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                f32p, f32p, f32p, f32p]
            lib.dwt_warp_affine_norm_u8.restype = None
            _lib = lib
    return _lib


def takes(a: np.ndarray) -> bool:
    """Whether the native passes take ``a``: a uint8 HWC image of 1 to 16
    channels (the C kernels bound their per-channel tables at 16)."""
    return a.dtype == np.uint8 and a.ndim == 3 and 1 <= a.shape[-1] <= 16


def _f32p(a):
    a = np.ascontiguousarray(a, dtype=np.float32)
    # Returning the array too keeps the buffer alive across the call.
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), a


def _per_channel(v, c: int):
    """mean/std as a length-``c`` f32 vector (numpy broadcast semantics:
    a scalar or length-1 value applies to every channel); the C kernel
    reads ``[0, c)``, so a short buffer would be read past its end."""
    return np.broadcast_to(np.asarray(v, np.float32).reshape(-1), (c,))


def _checked(a: np.ndarray) -> np.ndarray:
    if not takes(a):
        raise ValueError(f"native passes take uint8 HWC images of 1..16 "
                         f"channels, got {a.dtype} {a.shape}")
    return np.ascontiguousarray(a)


def normalize_from_u8(a: np.ndarray, mean, std) -> np.ndarray:
    """``(a/255 − mean)/std`` in one native pass; ``a`` uint8 HWC."""
    lib = load()
    a = _checked(a)
    h, w, c = a.shape
    out = np.empty((h, w, c), np.float32)
    (pm, _m), (ps, _s), (po, _o) = (
        _f32p(_per_channel(mean, c)), _f32p(_per_channel(std, c)), _f32p(out))
    lib.dwt_norm_u8(a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                    ctypes.c_longlong(h * w), ctypes.c_int(c), pm, ps, po)
    return out


def warp_affine_normalize_from_u8(a: np.ndarray, m: np.ndarray, mean, std) -> np.ndarray:
    """``cv2.warpAffine`` (default flags: bilinear, zero border) then /255
    and normalize, in one native pass; ``a`` uint8 HWC, ``m`` the forward
    2×3 float32 matrix as ``cv2.warpAffine`` would receive it."""
    lib = load()
    a = _checked(a)
    h, w, c = a.shape
    out = np.empty((h, w, c), np.float32)
    (pM, _M), (pm, _m), (ps, _s), (po, _o) = (
        _f32p(m), _f32p(_per_channel(mean, c)), _f32p(_per_channel(std, c)),
        _f32p(out))
    lib.dwt_warp_affine_norm_u8(
        a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_int(h), ctypes.c_int(w), ctypes.c_int(c), pM, pm, ps, po)
    return out
