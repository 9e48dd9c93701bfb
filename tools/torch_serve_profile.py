#!/usr/bin/env python3
"""Where a served forward's device time goes: ``torch.profiler`` over the
PyTorch port's bucketed ResNet50-DWT forward on a CUDA GPU.

Run from the root of a checkout on a machine with the card::

    python3 tools/torch_serve_profile.py [--bucket 128]

Builds the engine as the server does (``--model resnet50 --init_random
--seed 0``, 224², 65 classes), warms it, then profiles five
forwards of one bucket.  Prints one JSON line: the card (name and power
limit from ``nvidia-smi``), forward ms (CUDA events, profiler off), and
the profiled window's device time by kernel category and by kernel name,
with the device's busy and idle share of the window.  Fails without
CUDA.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

ITERS = 5   # profiled forwards
TOP = 12    # kernels listed by name
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# Kernel-name fragments → category, first match wins.
CATEGORIES = (
    ("whiten_apply", "whitening apply (hand kernel)"),
    ("ToNhwc", "layout transpose (cuDNN)"),
    ("ToNchw", "layout transpose (cuDNN)"),
    ("conv", "convolution"),
    ("xmma", "convolution"),
    ("implicit", "convolution"),
    ("gemm", "matmul"),
    ("max_pool", "max pool"),
    ("reduce", "reduction (mean pool)"),
    ("elementwise", "elementwise (BN, affine, ReLU, add)"),
    ("copy", "copy"),
    ("Memcpy", "copy"),
)


def category(name: str) -> str:
    low = name.lower()
    for key, cat in CATEGORIES:
        if key.lower() in low:
            return cat
    return "other"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--bucket", type=int, default=128)
    args = p.parse_args(argv)

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("torch_serve_profile: needs a CUDA GPU", file=sys.stderr)
        return 2
    from dwt_tpu_torch.serve import server

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    engine = server.build_engine(server.build_parser().parse_args([
        "--model", "resnet50", "--init_random", "--seed", "0",
        "--buckets", str(args.bucket),
    ]))
    b = args.bucket
    x = engine.stage(np.random.default_rng(0).normal(
        size=(b,) + engine.input_shape).astype(np.float32))
    for _ in range(3):
        engine.forward(x, b)
    torch.cuda.synchronize()

    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(ITERS):
        engine.forward(x, b)
    end.record()
    torch.cuda.synchronize()
    forward_ms = start.elapsed_time(end) / ITERS

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(ITERS):
            engine.forward(x, b)
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3

    # Device activity from the trace itself: kernels, copies and memsets
    # (the "cat" Kineto gives them); CPU ops and runtime markers excluded.
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    by_name, by_cat, launches = {}, {}, 0
    for ev in trace.get("traceEvents", []):
        if ev.get("cat") not in DEVICE_CATS or "dur" not in ev:
            continue
        launches += 1
        ms = ev["dur"] / 1e3 / ITERS
        by_name[ev["name"]] = by_name.get(ev["name"], 0.0) + ms
        cat = category(ev["name"])
        by_cat[cat] = by_cat.get(cat, 0.0) + ms
    busy_ms = sum(by_cat.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[: TOP]
    print(json.dumps({
        "card": smi,
        "device": torch.cuda.get_device_name(0),
        "bucket": b,
        "forward_ms": forward_ms,
        "profiled_window_ms_per_forward": window_ms / ITERS,
        "device_busy_ms_per_forward": busy_ms,
        "device_ops_per_forward": launches / ITERS,
        "device_idle_share": 1.0 - busy_ms / (window_ms / ITERS),
        "by_category_ms": dict(sorted(by_cat.items(), key=lambda kv: -kv[1])),
        "top_kernels_ms": [{"name": n[:120], "ms": ms} for n, ms in top],
    }), flush=True)
    if busy_ms <= 0:
        raise RuntimeError("the profiler recorded no device time")
    return 0


if __name__ == "__main__":
    sys.exit(main())
