#!/usr/bin/env python3
"""The whitening-apply kernel per site of every path, L2 cold, with its
wrapper's host time; and the design without TMA beside it.

Run from the root of a checkout on a machine with the card::

    python3 tools/torch_apply_probe.py
    python3 tools/torch_apply_probe.py --package-root DIR

For each apply site of the port's paths — a ResNet50 train step (``[3,
M, C]`` at 18 images per stream and 224²: the stem, a stage-1 C=64 and a
stage-1 C=256 site), a bucket-128 ResNet50 forward (``[M, C]``), a
LeNet-DWT train step (``[2, M, C]`` at 32 images per stream: ``dn1``
C=32, ``dn2`` C=48) and LeNet-DWT forwards at buckets 1 and 128 — one
JSON line with:

* ``device_ms``: the device time of the site's apply (``torch.profiler``,
  cycling through buffers of 100 MB or more, as ``chip_smoke.py`` times
  it), and ``launches``;
* ``host_us``: the wrapper's host time for the site (host clock around
  200 sites' calls, no synchronisation inside);
* ``bound_ms`` (bytes over the card's memory rate), the device time of a
  D2D copy of the same bytes and of an empty launch.

Then one line per path with the sums over a step's or a forward's sites.

With ``--package-root DIR`` (a checkout of another version of the port,
e.g. one whose wrapper takes one ``[M, C]`` per call), ``DIR``'s
``whiten_apply`` is timed instead, once per domain at the train sites, as
that version's ``TrainWhiten`` called it.  Without it, also the design
without TMA (``tools/whiten_apply_ldg.cu``, built into a library of its
own) at every site: its device time and its largest difference from the
kernel's output.

Prints the card's name and power limit first.  Fails without CUDA.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (path, site, D or None, M, C, sites per step or forward)
SITES = (
    ("train", "stem_dn1", 3, 18 * 112 * 112, 64, 1),
    ("train", "stage1_c64", 3, 18 * 56 * 56, 64, 6),
    ("train", "stage1_c256", 3, 18 * 56 * 56, 256, 4),
    ("serve_b128", "stem_dn1", None, 128 * 112 * 112, 64, 1),
    ("serve_b128", "stage1_c64", None, 128 * 56 * 56, 64, 6),
    ("serve_b128", "stage1_c256", None, 128 * 56 * 56, 256, 4),
    ("digits_train", "dn1", 2, 32 * 28 * 28, 32, 1),
    ("digits_train", "dn2", 2, 32 * 14 * 14, 48, 1),
    ("digits_serve_b1", "dn1", None, 28 * 28, 32, 1),
    ("digits_serve_b1", "dn2", None, 14 * 14, 48, 1),
    ("digits_serve_b128", "dn1", None, 128 * 28 * 28, 32, 1),
    ("digits_serve_b128", "dn2", None, 128 * 14 * 14, 48, 1),
)


def load_chip_smoke():
    """This checkout's ``chip_smoke.py``, whatever ``sys.path`` says."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def ldg_library():
    """``tools/whiten_apply_ldg.cu`` built into ``build/kernels/``."""
    from dwt_tpu_torch.ops import _build

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path = _build.BUILD_DIR / "libwhiten_apply_ldg.so"
    out = subprocess.run(
        [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(path),
         os.path.join(ROOT, "tools", "whiten_apply_ldg.cu")],
        capture_output=True, text=True)
    if out.returncode:
        raise RuntimeError(f"nvcc failed for whiten_apply_ldg.cu:\n{out.stdout}{out.stderr}")
    lib = ctypes.CDLL(str(path))
    v, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.dwt_whiten_apply_ldg_f32.argtypes = [v, v, v, v, i64, i64, i32, i32, v]
    lib.dwt_whiten_apply_ldg_f32.restype = i32
    lib.dwt_whiten_apply_ldg_blocks.argtypes = [i64, i64, i32]
    lib.dwt_whiten_apply_ldg_blocks.restype = i32
    ptxas = [ln.strip() for ln in (out.stdout + out.stderr).splitlines() if "Used" in ln]
    return lib, ptxas


def ldg_call(torch, lib, mean, w, d, m, c):
    """A call of the design without TMA on ``[d, m, c]`` into ``y``."""
    blocks = lib.dwt_whiten_apply_ldg_blocks(d, m, c)
    if blocks < 1:
        raise RuntimeError(f"blocks query failed: CUDA error {-blocks}")

    def call(x, y):
        rc = lib.dwt_whiten_apply_ldg_f32(
            x.data_ptr(), mean.data_ptr(), w.data_ptr(), y.data_ptr(), d, m, c,
            blocks, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"apply without TMA failed: CUDA error {rc}")
        return y

    return call, blocks


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--package-root", default=None,
                   help="time this checkout's wrapper, one call per domain")
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_apply_probe: needs a CUDA GPU", file=sys.stderr)
        return 2
    cs = load_chip_smoke()
    sys.path.insert(0, os.path.abspath(args.package_root or ROOT))
    from dwt_tpu_torch.ops import cuda_whitening as cw

    print(cs.nvidia_smi(), flush=True)
    rate = cs.memory_rate(torch.cuda.get_device_name(0))
    floor = cs.launch_floor_ms(torch)
    ldg = None if args.package_root else ldg_library()
    gen = torch.Generator(device="cuda").manual_seed(0)
    cpu_gen = torch.Generator().manual_seed(0)
    totals = {}
    for path, site, d, m, c, n in SITES:
        x, mean, w = cs.site_inputs(torch, m, c, gen, cpu_gen, "cuda", d)
        if args.package_root is not None and d is not None:
            def kernel(xi, yi):
                for k in range(d):
                    cw.whiten_apply(xi[k], mean[k], w[k], out=yi[k])
        else:
            def kernel(xi, yi):
                cw.whiten_apply(xi, mean, w, out=yi)
        cold = cs.cold_rotation(torch, (x,), out_like=(x,))
        before = cw.apply_launches
        kernel(*cold[0])
        row = {"path": path, "site": site, "D": d, "M": m, "C": c, "per_path": n,
               "launches": cw.apply_launches - before,
               "bound_ms": 4 * (d or 1) * (2 * m * c + 5 * c) / rate * 1e3,
               "device_ms": cs.device_ms(torch, kernel, cs.APPLY_KERNELS, cold),
               "host_us": cs.host_us(torch, kernel, cold),
               "copy_device_ms": cs.device_ms(
                   torch, lambda xi, yi: yi.copy_(xi), None, cold,
                   cats=("kernel", "gpu_memcpy")),
               "launch_floor_ms": floor}
        row["bound_share"] = row["bound_ms"] / row["device_ms"]
        if ldg is not None:
            x3, m3, w3 = (x, mean, w) if d else (x[None], mean[None], w[None])
            call, blocks = ldg_call(torch, ldg[0], m3, w3, x3.shape[0], m, c)
            cold3 = [tuple(t.view(x3.shape) for t in pair) for pair in cold]
            y = call(*cold3[0])
            want = cw.whiten_apply(x3, m3, w3)
            torch.cuda.synchronize()
            ms = cs.device_ms(torch, call, ("ldg",), cold3)
            row["ldg"] = {"device_ms": ms, "bound_share": row["bound_ms"] / ms,
                          "blocks_per_domain": blocks,
                          "max_abs_diff": float((y - want).abs().max())}
            del y, want
        print(json.dumps(row), flush=True)
        tot = totals.setdefault(path, {"launches": 0, "device_ms": 0.0, "host_us": 0.0,
                                       "bound_ms": 0.0, "copy_device_ms": 0.0})
        for key in ("launches", "device_ms", "host_us", "bound_ms", "copy_device_ms"):
            tot[key] += row[key] * n
        if "ldg" in row:
            tot["ldg_device_ms"] = tot.get("ldg_device_ms", 0.0) + row["ldg"]["device_ms"] * n
        del x, cold
        torch.cuda.empty_cache()
    for path, tot in totals.items():
        tot["bound_share"] = tot["bound_ms"] / tot["device_ms"]
        print(json.dumps({"path": path, "per": "step" if "train" in path else "forward",
                          "package_root": args.package_root, "launch_floor_ms": floor,
                          "ldg_ptxas": ldg[1] if ldg else None, **tot}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
