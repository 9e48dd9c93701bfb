#!/usr/bin/env python3
"""Where the moments kernel's time goes, per ResNet50-DWT train site, L2 cold.

Run from the root of a checkout on a machine with the card::

    python3 tools/torch_moments_probe.py [--clusters 8,12,16,20,24]
    python3 tools/torch_moments_probe.py --package-root DIR

For each batched train site (``[3, M, C]``: the stem, a stage-1 C=64 and
a stage-1 C=256 site at 18 images per stream and 224²):

* the kernel's device time (``torch.profiler``, cycling through buffers
  of 100 MB or more, as ``chip_smoke.py`` times it) at the grid the
  wrapper picks and at the other cluster counts per domain given;
* the wrapper's host time per call (host clock around 200 calls, no
  synchronisation inside);
* from ``csrc/whiten_moments.cu`` built with its ``MOMENTS_PHASE(k)``
  markers stamping ``%globaltimer`` (a library of its own, timed apart
  from the kernels), the median over 8 launches of the microseconds from
  the first block's start to: each block's start, the end of its
  streaming read, its partial, its cluster's partial, the start of each
  domain's last cluster, its sums and the end (the first and the last
  block to pass each point).

With ``--package-root DIR`` (a checkout of another version of the port,
e.g. one whose wrapper takes one domain per call), only the device time
of every moments kernel that ``DIR``'s ``whiten_moments`` launches when
called once per domain, and that wrapper's host time for the D calls.

Prints one JSON line per site, after the card's name and power limit.
Fails without CUDA.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SITES = (("stem_dn1", 18 * 112 * 112, 64), ("stage1_c64", 18 * 56 * 56, 64),
         ("stage1_c256", 18 * 56 * 56, 256))
DOMAINS = 3
# The kernel's phase boundaries, in the order of its MOMENTS_PHASE(k) marks.
PHASES = ("start", "streamed", "block_partial", "cluster_partial",
          "last_cluster", "sums", "end")
STAMPS = '''__device__ unsigned long long probe_first[16], probe_last[16];
#define MOMENTS_PHASE(k) do { if (threadIdx.x == 0) {                         \\
  unsigned long long now_;                                                   \\
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now_));                   \\
  atomicMin(&probe_first[k], now_); atomicMax(&probe_last[k], now_); } } while (0)
extern "C" int probe_read(unsigned long long* out) {
  cudaMemcpyFromSymbol(out, probe_first, sizeof(probe_first));
  cudaMemcpyFromSymbol(out + 16, probe_last, sizeof(probe_last));
  unsigned long long first[16], last[16];
  for (int i = 0; i < 16; ++i) { first[i] = ~0ull; last[i] = 0; }
  cudaMemcpyToSymbol(probe_first, first, sizeof(first));
  return cudaMemcpyToSymbol(probe_last, last, sizeof(last));
}
#include "SOURCE"
'''


def stamped_library():
    """The kernel with its phase markers stamping the time, built into
    ``build/kernels/``."""
    from dwt_tpu_torch.ops import _build

    source = (_build.CSRC_DIR / "whiten_moments.cu").resolve()
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path = _build.BUILD_DIR / "whiten_moments_stamped.cu"
    path.write_text(STAMPS.replace("SOURCE", str(source)))
    lib_path = _build.BUILD_DIR / "libwhiten_moments_stamped.so"
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(lib_path),
                    str(path)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    v = ctypes.c_void_p
    lib.dwt_whiten_moments_f32.argtypes = [v, v, v, v, v, ctypes.c_longlong,
                                           ctypes.c_longlong, ctypes.c_int,
                                           ctypes.c_int, v]
    lib.probe_read.argtypes = [v]
    return lib


def launcher(torch, lib, counter, m, c, clusters):
    """A call of ``lib``'s kernel on ``[3, m, c]`` at ``clusters`` per
    domain, into its own outputs and scratch."""
    groups = c // 4
    mean = torch.empty(DOMAINS, c, device="cuda")
    cov = torch.empty(DOMAINS, groups, 4, 4, device="cuda")
    scratch = torch.empty(DOMAINS * clusters * groups * 14, dtype=torch.float64,
                          device="cuda")

    def call(x):
        rc = lib.dwt_whiten_moments_f32(
            x.data_ptr(), mean.data_ptr(), cov.data_ptr(), scratch.data_ptr(),
            counter.data_ptr(), DOMAINS, m, c, clusters,
            torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"moments kernel failed: CUDA error {rc}")
        return mean, cov

    return call


def load_chip_smoke():
    """This checkout's ``chip_smoke.py``, whatever ``sys.path`` says."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def per_domain(torch, cs, cw, row, x, cold) -> None:
    """``row`` gets the device ms and host µs of ``cw.whiten_moments``
    called once per domain of a ``[D, M, C]`` site."""
    def calls(xi):
        for d in range(xi.shape[0]):
            cw.whiten_moments(xi[d], 4)

    ms = cs.device_ms(torch, calls, ("moments",), cold)
    row["per_domain_ms"] = {"ms": ms, "bound_share": row["bound_ms"] / ms}
    row["per_domain_host_us"] = cs.host_us(torch, calls, cold)


def phases_us(torch, stamped, call, x, cold):
    """Per phase boundary, the medians over 8 launches of the first and
    the last block's µs after the first block's start."""
    unset = 2 ** 64 - 1
    out = (ctypes.c_ulonglong * 32)()
    call(x)
    torch.cuda.synchronize()
    stamped.probe_read(out)  # resets the stamps
    runs = []
    for i in range(8):
        call(cold[i % len(cold)][0])
        torch.cuda.synchronize()
        stamped.probe_read(out)
        if any(out[k] == unset for k in range(len(PHASES))):
            raise RuntimeError("a MOMENTS_PHASE mark of the kernel was not reached")
        runs.append([((out[k] - out[0]) / 1e3, (out[16 + k] - out[0]) / 1e3)
                     for k in range(len(PHASES))])
    return {name: [statistics.median(r[k][0] for r in runs),
                   statistics.median(r[k][1] for r in runs)]
            for k, name in enumerate(PHASES)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--clusters", default="8,12,16,20,24",
                   help="other cluster counts per domain to time")
    p.add_argument("--package-root", default=None,
                   help="time this checkout's wrapper, one call per domain")
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_moments_probe: needs a CUDA GPU", file=sys.stderr)
        return 2
    cs = load_chip_smoke()
    sys.path.insert(0, os.path.abspath(args.package_root or ROOT))
    from dwt_tpu_torch.ops import cuda_whitening as cw

    print(cs.nvidia_smi(), flush=True)
    rate = cs.memory_rate(torch.cuda.get_device_name(0))
    if args.package_root is None:
        lib = cw._library("whiten_moments")
        stamped = stamped_library()
        counter = cw._arrival_counter(torch.device("cuda", 0))
    for site, m, c in SITES:
        x = torch.randn(DOMAINS, m, c, device="cuda") * 1.5 + 0.5
        cold = cs.cold_rotation(torch, (x,))
        row = {"site": site, "D": DOMAINS, "M": m, "C": c,
               "bound_ms": DOMAINS * m * c * 4 / rate * 1e3}
        if args.package_root is not None:
            row["package_root"] = args.package_root
            per_domain(torch, cs, cw, row, x, cold)
            print(json.dumps(row), flush=True)
            continue
        chosen, _ = cw._moments_grid(0, DOMAINS, m, c)
        row.update(clusters_chosen=chosen, device_ms={})
        for clusters in sorted({chosen, *map(int, args.clusters.split(","))}):
            call = launcher(torch, lib, counter, m, c, clusters)
            ms = cs.device_ms(torch, call, cs.MOMENTS_KERNELS, cold)
            row["device_ms"][clusters] = {"ms": ms,
                                          "bound_share": row["bound_ms"] / ms}
        row["wrapper_host_us"] = cs.host_us(
            torch, lambda xi: cw.whiten_moments(xi, 4), cold)
        per_domain(torch, cs, cw, row, x, cold)
        row["phases_us"] = phases_us(
            torch, stamped, launcher(torch, stamped, counter, m, c, chosen),
            x, cold)
        print(json.dumps(row), flush=True)
        del x, cold
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
