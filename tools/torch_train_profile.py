#!/usr/bin/env python3
"""Where a train step's device time goes: ``torch.profiler`` over the
PyTorch port's ResNet50-DWT OfficeHome train step (or LeNet-DWT digits
train step) on a CUDA GPU.

Run from the root of a checkout on a machine with the card::

    python3 tools/torch_train_profile.py [--images 18] [--size 224]
    python3 tools/torch_train_profile.py --model lenet [--images 32]
    python3 tools/torch_train_profile.py --package-root DIR

Builds the model as the trainer does (``build_model``: seed 1, 65
classes, momentum 0.1; ``--model lenet``: ``build_digits_model``, seed
1, group size 4, Adam), takes two warm-up steps on one synthetic batch
of three streams (two for LeNet-DWT), times five steps with CUDA events
(profiler off; twenty for LeNet-DWT, whose step is short), then
profiles three.  Prints one JSON line: the card (name and power limit
from ``nvidia-smi``), step ms, and the profiled window's device time by
kernel category and by kernel name, with the device's busy and idle
share of the window.  With ``--package-root DIR`` (a checkout of another
version of the port) that version's package is driven instead, so that
two versions are compared by one tool in one session.  Fails without
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

ITERS = 3   # profiled steps
TOP = 15    # kernels listed by name
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# Kernel-name fragments → category, first match wins.
CATEGORIES = (
    ("moments_", "whitening moments (hand kernel)"),
    ("whiten_apply", "whitening apply (hand kernel)"),
    ("ToNhwc", "layout transpose (cuDNN)"),
    ("ToNchw", "layout transpose (cuDNN)"),
    ("wgrad", "convolution"),
    ("dgrad", "convolution"),
    ("conv", "convolution"),
    ("xmma", "convolution"),
    ("implicit", "convolution"),
    ("potrf", "factorization (torch.linalg)"),
    ("trsm", "factorization (torch.linalg)"),
    ("trsv", "factorization (torch.linalg)"),
    ("cholesky", "factorization (torch.linalg)"),
    ("gemm", "matmul (einsum, block-diagonal apply, head)"),
    ("gemv", "matmul (einsum, block-diagonal apply, head)"),
    ("max_pool", "max pool"),
    ("reduce", "reduction (moments of BN, mean pool, norms)"),
    ("foreach", "optimizer (foreach SGD, grad norm)"),
    ("elementwise", "elementwise (BN, affine, ReLU, add, backward)"),
    ("copy", "copy"),
    ("Memcpy", "copy"),
    ("Memset", "memset"),
)


def category(name: str) -> str:
    low = name.lower()
    for key, cat in CATEGORIES:
        if key.lower() in low:
            return cat
    return "other"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model", choices=("resnet50", "lenet"), default="resnet50")
    p.add_argument("--images", type=int, default=None,
                   help="images per stream (default 18; LeNet-DWT 32)")
    p.add_argument("--size", type=int, default=224, help="ResNet50 image size")
    p.add_argument("--package-root", default=None,
                   help="drive this checkout's dwt_tpu_torch")
    args = p.parse_args(argv)
    if args.package_root is not None:
        sys.path.insert(0, os.path.abspath(args.package_root))
    lenet = args.model == "lenet"
    images = args.images or (32 if lenet else 18)

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("torch_train_profile: needs a CUDA GPU", file=sys.stderr)
        return 2
    from dwt_tpu_torch.config import DigitsConfig, OfficeHomeConfig
    from dwt_tpu_torch.train import loop
    from dwt_tpu_torch.train.optim import digits_tx, officehome_tx
    from dwt_tpu_torch.train.state import TrainState
    from dwt_tpu_torch.train.steps import (
        make_digits_train_step,
        make_officehome_train_step,
    )

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    if lenet:
        cfg = DigitsConfig(seed=1, group_size=4, source_batch_size=images)
        model = loop.build_digits_model(cfg)
        optimizer, schedules = digits_tx(model, cfg, 256 // images)
        step = make_digits_train_step(model, cfg.lambda_entropy_loss)
        shape, classes, streams = (28, 28, 1), 10, 2
    else:
        cfg = OfficeHomeConfig(img_crop_size=args.size, source_batch_size=images)
        model = loop.build_model(cfg)
        optimizer, schedules = officehome_tx(model, cfg)
        step = make_officehome_train_step(model, cfg.lambda_mec_loss)
        shape, classes, streams = (args.size, args.size, 3), cfg.num_classes, 3
    model.to(device, memory_format=torch.channels_last)
    state = TrainState(model, optimizer, schedules)
    arrays = [loop._synthetic_classification_arrays(
        images, shape, classes, cfg.seed + i, 0.5 * (i > 0)) for i in range(streams)]
    to = lambda a: torch.from_numpy(a).to(device)
    batch = {"source_x": to(arrays[0][0]), "source_y": to(arrays[0][1]),
             "target_x": to(arrays[1][0])}
    if not lenet:
        batch["target_aug_x"] = to(arrays[2][0])
    for _ in range(2):
        step(state, batch)
    torch.cuda.synchronize()

    timed = 20 if lenet else 5
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(timed):
        step(state, batch)
    end.record()
    torch.cuda.synchronize()
    step_ms = start.elapsed_time(end) / timed

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(ITERS):
            step(state, batch)
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    by_name, by_cat, launches, calls = {}, {}, 0, {}
    for ev in trace.get("traceEvents", []):
        if ev.get("cat") not in DEVICE_CATS or "dur" not in ev:
            continue
        launches += 1
        ms = ev["dur"] / 1e3 / ITERS
        by_name[ev["name"]] = by_name.get(ev["name"], 0.0) + ms
        calls[ev["name"]] = calls.get(ev["name"], 0) + 1
        cat = category(ev["name"])
        by_cat[cat] = by_cat.get(cat, 0.0) + ms
    busy_ms = sum(by_cat.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[: TOP]
    print(json.dumps({
        "card": smi,
        "device": torch.cuda.get_device_name(0),
        "model": args.model,
        "package_root": args.package_root,
        "images_per_step": streams * images,
        "size": shape[0],
        "step_ms": step_ms,
        "profiled_window_ms_per_step": window_ms / ITERS,
        "device_busy_ms_per_step": busy_ms,
        "device_ops_per_step": launches / ITERS,
        "device_idle_share": 1.0 - busy_ms / (window_ms / ITERS),
        "by_category_ms": dict(sorted(by_cat.items(), key=lambda kv: -kv[1])),
        "top_kernels_ms": [{"name": n[:120], "ms": ms} for n, ms in top],
        # The hand kernels: device ms and launches per step.
        "hand_kernels": [
            {"name": n[:120], "ms": ms, "launches": calls[n] / ITERS}
            for n, ms in sorted(by_name.items())
            if "moments_" in n or "whiten_apply" in n],
    }), flush=True)
    if busy_ms <= 0:
        raise RuntimeError("the profiler recorded no device time")
    return 0


if __name__ == "__main__":
    sys.exit(main())
