"""Build the port's CUDA sources into plain-C shared libraries, at first use.

Each ``dwt_tpu_torch/csrc/<name>.cu`` compiles with ``nvcc`` for Hopper
(``sm_90a``) into ``build/kernels/lib<name>-<digest>.so`` at the root of
the checkout, a directory ``.gitignore`` lists.  The file name carries a
digest of the source and the flags, so an edited source never loads a
stale library.  The libraries have a plain C interface and are loaded
with ``ctypes`` — no PyTorch headers, so a build takes seconds.

Nothing here runs at import: the wrappers call :func:`load` when they
first launch a kernel, and ``chip_smoke.py`` calls :func:`build_all` to
compile every source in parallel (one ``nvcc`` per source) up front.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """``nvcc`` from ``PATH``, else the toolkit's default install."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError(
        "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels "
        "of dwt_tpu_torch build only on a machine with the CUDA toolkit"
    )


def library_path(name: str) -> Path:
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start(name: str):
    """Start ``nvcc`` for one source; returns ``(process, temp output)``."""
    out = library_path(name)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, tmp


def _finish(name: str, started) -> str:
    proc, tmp = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, library_path(name))  # atomic for a concurrent loader
    return log


def sources() -> List[str]:
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def build_all() -> Dict[str, str]:
    """Compile every source not yet built, all ``nvcc`` runs at once;
    returns each built source's compiler log (``-Xptxas -v`` resource
    usage).  Waits for every ``nvcc`` it started, then raises if any
    build failed."""
    with _lock:
        procs = {
            name: _start(name) for name in sources()
            if not library_path(name).exists()
        }
        logs, failures = {}, []
        for name, started in procs.items():
            try:
                logs[name] = _finish(name, started)
            except RuntimeError as e:
                failures.append(str(e))
        if failures:
            raise RuntimeError("\n".join(failures))
        return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            path = library_path(name)
            if not path.exists():
                _finish(name, _start(name))
            lib = _loaded[name] = ctypes.CDLL(str(path))
        return lib
