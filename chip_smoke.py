#!/usr/bin/env python3
"""On-GPU smoke of the PyTorch/CUDA port (``dwt_tpu_torch``): build, check, train, serve.

Run from the root of a checkout, on a machine with one CUDA GPU::

    python3 chip_smoke.py

Phases, each printed as one JSON line; any failure raises and the
script exits non-zero without the final line:

1. ``env``      — torch/CUDA versions, the card's name and power limit
                  (``nvidia-smi``), both TF32 flags, PIL's version, the
                  host's CPU count and ``g++ --version``.
2. ``build``    — ``nvcc`` builds every ``dwt_tpu_torch/csrc/*.cu`` (in
                  parallel) into ``build/kernels/``, then ``g++`` the data
                  path's native pixel passes (``dwt_tpu_torch/native/``)
                  into ``build/native/``.
3. ``parity``   — the whitening-apply kernel against its plain PyTorch
                  version, both on the card, at the three site shapes of a
                  bucket-128 ResNet50 forward at 224² (``x [M, C]``) and at
                  a ragged M = 1000; in its domain-batched form (``x [D, M,
                  C]``, one launch for the D domains) at the three site
                  shapes of a ResNet50 train step (D = 3, 18 images per
                  stream), at D = 1 and at ragged M = 1, 7 and 1000;
                  ``rtol = atol = 1e-5``.  At the train shapes also: in a
                  profiler trace of ten calls the kernel and no other
                  device operation, at most once per call; a second call
                  bitwise equal to the first, and two replays of a CUDA
                  graph that captured a call bitwise equal to it.
4. ``timing``   — per shape: kernel (``device_ms``: its device time in a
                  ``torch.profiler`` trace; ``kernel_ms``: CUDA events
                  around back-to-back wrapper calls, host time included;
                  ``host_us``: the wrapper's host time per call), plain
                  version and one-call library yardstick (``torch.addmm``
                  with the block-diagonal matrix; ``torch.baddbmm`` for D
                  domains) in milliseconds, beside the bound (bytes moved
                  over the card's memory rate), a D2D copy of the same
                  bytes (``copy_ms``, ``copy_device_ms``) and the device
                  time of an empty launch (``launch_floor_ms``, the card's
                  per-launch floor).  Every timing here and in phase 6
                  cycles through distinct input (and output) buffers of
                  ``COLD_BYTES`` (100 MB) or more in all, so that L2 is
                  cold for each call, as in a train step or a forward.
5. ``moments_parity`` — the moments kernel against its plain version on
                  the card and against a float64 two-pass reference of
                  each domain, at the three batched site shapes of a
                  ResNet50 train step (``[3, M, C]``, 18 images per
                  stream, 224²), at D = 1 and D = 2, at a ragged M = 1000
                  and on an input with a channel-mean offset of 4; mean
                  ``rtol = atol = 1e-6``, cov ``rtol = 1e-4, atol = 1e-5``.
                  One launch per call, and one kernel and no other device
                  operation in a profiler trace of a call; a second call
                  is bitwise equal to the first, and at the three train
                  shapes so are two replays of a CUDA graph that captured
                  a call.  At each shape also the apply kernel against its
                  plain version on all domains in one launch, whitening
                  each with its own moments (``rtol = atol = 1e-5`` per
                  element).
6. ``moments_timing`` — per train site: the moments kernel (one launch for
                  the site's 3 domains; also its wrapper's host µs per
                  call), its plain version and the library
                  yardstick ``torch.cov`` once per domain (the full C×C
                  covariance, whose diagonal 4×4 blocks are the kernel's
                  ``cov``), and the apply kernel on the site's 3 domains
                  (one launch), beside their bounds.
7. ``train``    — the port's trainer through its CLI entry
                  (``build_parser``/``run_officehome``): ResNet50-DWT,
                  65 classes, 224², 3 streams × 18 images, 6 steps, an
                  eval every 3, one stat-collection pass and the final
                  eval, on synthetic data from seed 1.  ``--log_interval
                  1`` so that every step's losses are read.  Checks:
                  finite losses and grad norms, every parameter and
                  every whitening site's running cov moved, 11 moments
                  launches and 11 apply launches (one each per site, for
                  its 3 domains) per train step and per collection
                  forward, 11 apply launches per eval forward, an
                  accuracy.
8. ``train_reference`` — one ResNet50 train step through the kernels
                  against the same step with both kernels swapped for
                  their plain versions and against a float64 step of the
                  plain versions, all on the card, from the same weights
                  and batch; then one tiny-model step on the card against
                  the same step on the CPU.  Metrics and stats as a whole,
                  and each parameter's gradient and update on its own
                  (tolerances and their readings at ``TRAIN_TOL``).
9. ``train_throughput`` — steady-state train step time (CUDA events,
                  after 2 warm-up steps), images per second, the time of
                  a stat-collection forward and of an eval forward at the
                  test batch, and peak device memory.
10. ``data_plane`` — on two OfficeHome-shaped image folders written from
                  seed 1 (``Art/`` and ``Clipart/`` under ``build/``, 65
                  classes × 3 JPEGs, sides 300–800 px, quality 90): the
                  source and target streams' batch ids equal the seekable
                  sampler's order across the epoch boundary, a stream
                  opened at cursor 4 yields bitwise the suffix of one
                  opened at 0, 1 and 4 loader threads give bitwise the same
                  batches, and a batch prefetched to the card equals its
                  numpy source bitwise; then images per second of the
                  target stream (both views) and of the source stream at
                  1, 2, 4 and 8 threads, and the host-to-device time of a
                  batch (CUDA events from pinned memory, and wall clock
                  through ``prefetch_to_device``).
11. ``folder_train`` — phase 7 on the folders: ``run_officehome`` through
                  the CLI flags ``--s_dset_path …/Art --t_dset_path
                  …/Clipart --num_workers 4 --num_iters 12
                  --check_acc_step 6 --stat_collection_passes 1
                  --log_interval 1`` (ResNet50, 65 classes, 224², 3 × 18;
                  12 steps cross the 10-batch epoch), with phase 7's
                  checks; phases 7 and 11 also report the median step
                  (batch to batch) and the loop's mean wait for a batch.
                  ``folder_profile``: the card's idle share over a
                  profiled window of folder steps; ``folder_vs_synthetic``
                  sets the two paths' steps side by side.
12. ``serve``   — the port's server on 127.0.0.1 (``build_engine`` from
                  the CLI flags ``--model resnet50 --num_classes 65
                  --image_size 224 --buckets 1,8,32,128 --init_random
                  --seed 0``) answers requests of 1, 5, 32 and 128 images;
                  every response is checked (shape, finite, equal to
                  ``engine.infer``), the kernel must have launched 11
                  times per forward, a bucket-8 forward through the kernel
                  is held to the same forward through the plain apply and
                  a bucket-1 forward to the model on the CPU; then forward
                  time per bucket and peak device memory.
13. ``digits_parity`` / ``digits_timing`` — both kernels at LeNet-DWT's
                  whitened sites (``dn1`` C = 32, ``dn2`` C = 48): the
                  moments kernel against its plain version and a float64
                  two-pass reference at the train shapes ``[2, M, C]`` (32
                  images per stream), the apply kernel against its plain
                  version there (one launch for both domains; also at D =
                  1 and at ragged M = 1, 7 and 1000, and at the train
                  shapes one kernel per call, bitwise repeats and graph
                  replays) and at the eval (test batch 100) and serve
                  (buckets 1 and 128) shapes, tolerances as above; times
                  with L2 cold beside the bound, the plain version, the
                  library yardsticks, the D2D copy and the launch floor.
14. ``digits_train`` — the digits trainer through its CLI entry
                  (``build_parser``/``run_digits``): LeNet-DWT, 32 images per
                  stream, 2 epochs of 8 steps on synthetic data, an eval
                  after each.  Checks: finite losses and grad norms, every
                  parameter and both sites' running covs moved, 2 moments
                  and 2 apply launches per step, 2 apply launches per eval
                  forward, the record sequence, an accuracy.
15. ``digits_reference`` — one LeNet-DWT step through the kernels against
                  the plain-kernel step and a float64 step on the card
                  (limits and readings at ``DIGITS_LEAF_TOL``).
16. ``digits_throughput`` — steady-state digits step and eval forward
                  (batch 100), images per second, peak memory, and the
                  card's idle share from a profiled window of steps.
17. ``digits_serve`` — phase 12 for ``--model lenet`` (2 apply launches
                  per forward).
18. ``kernels`` — the contract line: per kernel and path its TPU
                  counterpart, launches on that path's run, error and
                  times (``ms`` is the kernel's device time).

The last two lines are the card's ``nvidia-smi`` name/power limit and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import copy
import functools
import itertools
import json
import os
import subprocess
import sys
import tempfile
import time

RESNET50_SITES = (  # (site, M at bucket 128 and 224², C, sites per forward)
    ("stem_dn1", 128 * 112 * 112, 64, 1),
    ("stage1_c64", 128 * 56 * 56, 64, 6),
    ("stage1_c256", 128 * 56 * 56, 256, 4),
)
TRAIN_SITES = (  # (site, M per domain at 18 images and 224², C, sites per step)
    ("stem_dn1", 18 * 112 * 112, 64, 1),
    ("stage1_c64", 18 * 56 * 56, 64, 6),
    ("stage1_c256", 18 * 56 * 56, 256, 4),
)
DOMAINS = 3  # domain branches of a train site: one moments and one apply launch
RAGGED_M = 1000
APPLY_RAGGED_M = (1, 7, 1000)  # ragged rows of the batched apply's parity
TRACED_CALLS = 10  # calls in the trace that shows what one call puts on the card
APPLY_KERNELS = ("whiten_apply_f32_kernel",)
APPLY_EXTRA = ("host_us", "copy_device_ms")  # apply timings summed per step
MOMENTS_EXTRA = ("host_us",)  # moments timings summed per step
MOMENTS_KERNELS = ("whiten_moments_f32_kernel",)
# Kernel timings cycle through distinct buffers of at least this many
# bytes in all, more than the H100's 50 MB L2, so no reading comes from L2.
COLD_BYTES = 100_000_000
MEAN_TOL = 1e-6                   # moments: mean rtol = atol
COV_RTOL, COV_ATOL = 1e-4, 1e-5   # moments: cov
TRAIN_FLAGS = [
    "--synthetic", "--arch", "resnet50", "--num_classes", "65",
    "--img_crop_size", "224", "--source_batch_size", "18", "--num_iters", "6",
    "--check_acc_step", "3", "--stat_collection_passes", "1", "--seed", "1",
    "--log_interval", "1",
]
# The image-folder path: two OfficeHome-shaped folders written from seed 1
# (65 classes of 3 JPEGs per domain, sides drawn from 300-800 px, quality
# 90), trained Art → Clipart through the CLI entry with 4 loader threads;
# 12 steps cross the 10-batch epoch (195 images at 18 per batch).
FOLDER_DOMAINS = ("Art", "Clipart")
FOLDER_CLASSES, FOLDER_PER_CLASS, FOLDER_SIDES = 65, 3, (300, 800)
FOLDER_TRAIN_FLAGS = [
    "--num_workers", "4", "--num_iters", "12", "--check_acc_step", "6",
    "--stat_collection_passes", "1", "--log_interval", "1",
    "--arch", "resnet50", "--num_classes", "65", "--img_crop_size", "224",
    "--source_batch_size", "18", "--seed", "1",
]
WORKER_COUNTS = (1, 2, 4, 8)  # loader threads at which the streams are timed
RATE_BATCHES = 4  # batches per stream and worker count in the image rates
PROFILED_STEPS = 4  # folder steps in the profiled window of the idle share
WHITENED_SITES = 11  # ResNet50-DWT: the stem and the 10 norm sites of stage 1
# The ResNet50 step held to its plain-kernel twin: images per stream, size.
REFERENCE_STEP = (18, 224)
TOL = 1e-5            # kernel vs plain, per element: rtol = atol = 1e-5
FORWARD_TOL = 1e-4    # whole forwards: max |a − b| / max |b|
# Train steps against their references (the kernel step against the plain
# step and against a float64 step, the tiny model's card step against the
# CPU's), by relative error: losses and running stats (max |a − b| /
# max |b| per stat tensor) at TRAIN_TOL, the gradient norm at
# TRAIN_GRAD_TOL, and per parameter (compare_steps) its gradient and its
# update, less one float32 spacing of the stored value per element.
# The per-parameter limits come from tools/torch_step_sensitivity.py on
# the H100 over 5 seeds (PERF.md, PR 2).  A fresh ResNet50-DWT step is
# ill-conditioned in its backbone gradients: moving every input pixel by
# one f32 rounding unit moves the float64 step's backbone gradients by
# 0.08-0.64%, and every backbone leaf of an f32 step (kernels or plain
# versions) sits 0.6-2.8% from float64, the head's ≤ 1.3e-5.  So each
# backbone leaf is held at 5e-2 and the head at 1e-4, and the kernel
# step's gradient over all parameters may be no further from float64
# than F64_RATIO_TOL times the plain step's (readings 0.87-1.04).  The
# tiny model has no such sensitivity (card vs CPU ≤ 2.2e-4 per leaf).
TRAIN_TOL = 5e-4
TRAIN_GRAD_TOL = 2e-3
RESNET50_LEAF_TOL = (5e-2, 1e-4)  # (backbone, head)
F64_RATIO_TOL = 1.25
TINY_LEAF_TOL = 2e-3
STEP_METRICS = ("loss", "cls_loss", "mec_loss", "entropy_loss", "grad_norm")
FP32_PEAK = 67e12     # H100 SXM f32 outside the tensor cores (data sheet)

# The digits slice: LeNet-DWT, 2 domain branches, whitened sites in groups of 4.
DIGITS_SITES = (("dn1", 32, 28 * 28), ("dn2", 48, 14 * 14))  # (site, C, rows per image)
DIGITS_STREAM = 32  # images per stream: the reference recipe
DIGITS_APPLY_BATCHES = (("eval", 100), ("serve_b1", 1), ("serve_b128", 128))
DIGITS_TRAIN_FLAGS = [
    "--synthetic", "--group_size", "4", "--synthetic_size", "256", "--epochs", "2",
    "--seed", "1", "--log_interval", "1",
]
DIGITS_STEPS_PER_EPOCH = 256 // DIGITS_STREAM
# Biases that feed a normalization site: the batch mean removes them, so
# their exact gradient is zero and every step computes rounding noise,
# which Adam's first step (lr·g/(|g| + 1e-8)) turns into ±lr.  They are
# held to be noise (at most DIGITS_NOISE_TOL of the step's gradient norm)
# instead of leaf by leaf.
DIGITS_NORMALIZED_BIASES = ("conv1.bias", "conv2.bias", "fc3.bias", "fc4.bias",
                            "fc5.bias")
DIGITS_NOISE_TOL = 1e-6  # readings on the H100: 5.6e-8 (f32), 9.2e-17 (float64)
# Every other parameter's gradient and update (beyond rounding) against
# the plain step and the float64 step.  Readings on the H100: gradients
# ≤ 1.1e-6 per parameter, updates ≤ 4.8e-6 (fc3.weight: Adam divides by
# |g| + 1e-8, so its smallest gradients reach the update); loss ≤ 1.6e-7,
# stats ≤ 4.8e-7 (held at TRAIN_TOL).
DIGITS_LEAF_TOL = 1e-4


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def memory_rate(name: str) -> float:
    """Bytes/s of the card's memory, from the published table (NVIDIA's
    data sheets), by the device name CUDA reports."""
    table = (("H200", 4.8e12), ("H100 NVL", 3.9e12), ("H100 PCIe", 2.0e12),
             ("H100", 3.35e12))
    for key, rate in table:
        if key in name:
            return rate
    raise RuntimeError(f"no published memory rate for {name!r}")


def cuda_ms(torch, fn, rotation=((),), iters: int = 50, warmup: int = 5) -> float:
    """Milliseconds per call of ``fn(*rotation[i % len(rotation)])`` by
    CUDA events around back-to-back calls (host time included)."""
    for i in range(warmup):
        fn(*rotation[i % len(rotation)])
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*rotation[i % len(rotation)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def trace_events(torch, fn, iters: int = 1, cats=DEVICE_CATS, attempts: int = 3):
    """The events of categories ``cats`` (by default the device's: kernels,
    copies, memsets) of ``iters`` calls of ``fn()`` in a ``torch.profiler``
    trace, in order.  The profiler on the H100's machine now and then
    delivers a trace without a device event: such a trace is taken again,
    up to ``attempts`` times in all."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(attempts):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                trace = json.load(f)
        events = [ev for ev in trace.get("traceEvents", [])
                  if ev.get("cat") in cats and "dur" in ev]
        if any(ev["cat"] in DEVICE_CATS for ev in events):
            break
    return events


def device_ms(torch, fn, names, rotation=((),), iters: int = 20,
              cats=("kernel",)) -> float:
    """Device time per call of the kernels whose names contain one of
    ``names`` (``None``: every kernel; ``cats`` also ``"gpu_memcpy"``:
    copies too), from a ``torch.profiler`` trace of ``iters`` calls of
    ``fn(*rotation[i % len(rotation)])``: the kernels' own time, without
    the host time around them (which exceeds the kernel at the small train
    shapes).  The profiler has been seen to drop some of a trace's device
    events, so per kernel name the mean duration is taken, times its
    launches per call (its count over ``iters``, rounded)."""
    for args in rotation:
        fn(*args)
    calls = itertools.count()
    events = trace_events(
        torch, lambda: fn(*rotation[next(calls) % len(rotation)]), iters)
    by_name = {}
    for ev in events:
        if ev["cat"] in cats and (names is None or any(n in ev["name"] for n in names)):
            by_name.setdefault(ev["name"], []).append(ev["dur"])
    if not by_name:
        raise RuntimeError(f"the profiler recorded no {names} kernel")
    return sum(sum(d) / len(d) * max(1, round(len(d) / iters))
               for d in by_name.values()) / 1e3


def cold_rotation(torch, tensors, out_like=()):
    """Argument tuples over distinct buffers, so that timing a kernel by
    cycling through them finds L2 cold: ``tensors`` and their copies, with
    fresh ``out_like``-shaped outputs, ``COLD_BYTES`` or more in all and at
    least two sets."""
    per_set = sum(t.numel() * t.element_size() for t in (*tensors, *out_like))
    sets = max(2, -(-COLD_BYTES // per_set))
    first = (*tensors, *(torch.empty_like(t) for t in out_like))
    return [first] + [(*(t.clone() for t in tensors),
                       *(torch.empty_like(t) for t in out_like))
                      for _ in range(sets - 1)]


def norm_err(a, b) -> float:
    """``max |a − b| / max |b|`` (logits of fresh-init stats are large)."""
    return float((a.double() - b.double()).abs().max() / b.double().abs().max())


def site_inputs(torch, m, c, gen, cpu_gen, device, d=None):
    """``x [m, c]``, ``mean [c]`` and ``w [c/4, 4, 4]`` of an apply site;
    with ``d``, ``x [d, m, c]``, ``mean [d, c]`` and ``w [d, c/4, 4, 4]``,
    each domain its own draw."""
    from dwt_tpu_torch.ops.whitening import _shrink, whitening_matrix

    if d is not None:
        parts = [site_inputs(torch, m, c, gen, cpu_gen, device) for _ in range(d)]
        return tuple(torch.stack(ts) for ts in zip(*parts))
    x = torch.randn(m, c, generator=gen, device=device) * 2.0 + 1.0
    mean = torch.randn(c, generator=gen, device=device) * 0.5
    a = torch.randn(c // 4, 4, 4, dtype=torch.float64, generator=cpu_gen)
    cov = a @ a.transpose(-1, -2) / 4 + 0.5 * torch.eye(4, dtype=torch.float64)
    w = whitening_matrix(_shrink(cov.float(), 1e-3)).to(device).contiguous()
    return x, mean, w


HOST_CALLS = 200  # wrapper calls per host-time reading


def host_us(torch, fn, rotation) -> float:
    """Host microseconds per ``fn`` call, over ``HOST_CALLS`` calls
    through ``rotation`` with no synchronisation inside (the launches
    queue up; the host never waits for the device)."""
    for args in rotation:
        fn(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(HOST_CALLS):
        fn(*rotation[i % len(rotation)])
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return elapsed / HOST_CALLS * 1e6


@functools.lru_cache(maxsize=None)
def launch_floor_ms(torch) -> float:
    """Device time of an empty launch (``torch.cuda._sleep(0)``: one
    thread that returns at once), the card's per-launch floor; measured
    once per run."""
    return device_ms(torch, lambda: torch.cuda._sleep(0), None, iters=50)


def time_apply(torch, cw, x, mean, w, rate):
    """Times of the apply kernel on ``x [M, C]`` or, for the D domains of
    a train site, ``x [D, M, C]`` (one launch) with L2 cold: its device
    time (``device_ms``; ``kernel_ms`` by CUDA events, host time
    included), the wrapper's host µs per call, its plain version's time,
    the library yardstick's (``torch.addmm`` with the block-diagonal
    matrix, ``torch.baddbmm`` over the domains; ``library_ms`` by CUDA
    events, ``library_device_ms`` its kernels' device time), a D2D copy's
    of the same bytes (``copy_ms`` by CUDA events, ``copy_device_ms``) and
    the launch floor, beside its bound."""
    batched = x.dim() == 3
    d, (m, c) = (x.shape[0] if batched else 1), x.shape[-2:]
    w3, mean3 = (w, mean) if batched else (w[None], mean[None])
    w_t = torch.stack([torch.block_diag(*wd).t() for wd in w3]).contiguous()
    bias = -(mean3[:, None, :] @ w_t)  # [D, 1, C]
    if batched:
        library = lambda xi, yi: torch.baddbmm(bias, xi, w_t, out=yi)
    else:
        library = lambda xi, yi: torch.addmm(bias[0, 0], xi, w_t[0], out=yi)
    lib_err = float((library(x, torch.empty_like(x))
                     - cw.whiten_apply_plain(x, mean, w)).abs().max())
    nbytes = 4 * d * (2 * m * c + 5 * c)  # read x, mean, w; write y
    flops = d * m * c * 9  # per 4 channels: 4 subtracts + 16 FMAs
    bytes_ms, ops_ms = nbytes / rate * 1e3, flops / FP32_PEAK * 1e3
    cold = cold_rotation(torch, (x,), out_like=(x,))  # (x_i, y_i)
    kernel = lambda xi, yi: cw.whiten_apply(xi, mean, w, out=yi)
    copy = lambda xi, yi: yi.copy_(xi)
    row = {
        "D": d if batched else None, "M": m, "C": c, "bytes": nbytes,
        "rotation_buffers": len(cold),
        "kernel_ms": cuda_ms(torch, kernel, cold),
        "device_ms": device_ms(torch, kernel, APPLY_KERNELS, cold),
        "host_us": host_us(torch, kernel, cold),
        "plain_ms": cuda_ms(
            torch, lambda xi, yi: cw.whiten_apply_plain(xi, mean, w, out=yi),
            cold, iters=10),
        "library_ms": cuda_ms(torch, library, cold),
        "library_device_ms": device_ms(torch, library, None, cold),
        "copy_ms": cuda_ms(torch, copy, cold),
        "copy_device_ms": device_ms(torch, copy, None, cold,
                                    cats=("kernel", "gpu_memcpy")),
        "launch_floor_ms": launch_floor_ms(torch),
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_max_abs_err": lib_err,
    }
    row["kernel_GBps"] = nbytes / row["device_ms"] / 1e6
    row["bound_share"] = row["bound_ms"] / row["device_ms"]
    row["copy_bound_share"] = row["bound_ms"] / row["copy_device_ms"]
    return row


def time_moments(torch, cw, x, rate):
    """Times of the moments kernel on ``x [D, M, C]`` (one launch for its D
    domains) with L2 cold, beside its plain version's, the library
    yardstick's (``torch.cov`` once per domain: the full C×C covariance,
    whose diagonal 4×4 blocks are the kernel's ``cov``) and its bound."""
    d, m, c = x.shape
    groups = c // 4
    cov = cw.whiten_moments(x, 4)[1]
    gi = torch.arange(groups, device=x.device)
    lib = torch.cov(x[0].t(), correction=0).view(groups, 4, groups, 4)[gi, :, gi, :]
    lib_err = float((lib - cov[0]).abs().max())
    nbytes = d * m * c * 4 + d * (c + groups * 16) * 4
    flops = d * m * c * 6  # per 4 channels: 4 adds, 10 FMAs
    bytes_ms, ops_ms = nbytes / rate * 1e3, flops / FP32_PEAK * 1e3
    cold = cold_rotation(torch, (x,))
    kernel = lambda xi: cw.whiten_moments(xi, 4)
    library = lambda xi: [torch.cov(xi[k].t(), correction=0) for k in range(d)]
    row = {
        "D": d, "M": m, "C": c, "bytes": nbytes, "rotation_buffers": len(cold),
        "kernel_ms": cuda_ms(torch, kernel, cold),
        "device_ms": device_ms(torch, kernel, MOMENTS_KERNELS, cold),
        "host_us": host_us(torch, kernel, cold),
        "plain_ms": cuda_ms(torch, lambda xi: cw.whiten_moments_plain(xi, 4),
                            cold, iters=10),
        "library_ms": cuda_ms(torch, library, cold, iters=10),
        "library_device_ms": device_ms(torch, library, None, cold, iters=10),
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_max_abs_err": lib_err,
    }
    row["kernel_GBps"] = nbytes / row["device_ms"] / 1e6
    row["bound_share"] = row["bound_ms"] / row["device_ms"]
    return row


def apply_graph_replays(torch, cw, x, mean, w, eager):
    """Capture one apply launch in a CUDA graph, replay it twice over a
    zeroed output: is every replay bitwise the eager result?"""
    out = torch.empty_like(x)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        cw.whiten_apply(x, mean, w, out=out)
    same = []
    for _ in range(2):
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        same.append(torch.equal(out, eager))
    del graph, out
    return all(same)


def apply_parity(torch, cw, name, x, mean, w, full=False):
    """The apply kernel against its plain version on ``x [M, C]`` or ``x
    [D, M, C]``: one launch, within ``rtol = atol = TOL`` per element.
    With ``full``, also: one kernel per call and no other device operation
    in a profiler trace of calls, a second call bitwise equal to the
    first, and two graph replays bitwise equal to it."""
    before = cw.apply_launches
    y = cw.whiten_apply(x, mean, w)
    launches = cw.apply_launches - before
    ref = cw.whiten_apply_plain(x, mean, w)
    torch.cuda.synchronize()
    diff = (y - ref).abs()
    row = {"shape": name, "D": x.shape[0] if x.dim() == 3 else None,
           "M": x.shape[-2], "C": x.shape[-1], "launches": launches,
           "max_abs_err": float(diff.max()),
           "max_rel_err": float((diff / ref.abs().clamp_min(1e-30)).max()),
           "rtol": TOL, "atol": TOL}
    ok = bool((diff <= TOL + TOL * ref.abs()).all()) and launches == 1
    del ref, diff
    if full:
        again = cw.whiten_apply(x, mean, w)
        torch.cuda.synchronize()
        row["repeat_bitwise"] = torch.equal(again, y)
        del again
        row["graph_replay_bitwise"] = apply_graph_replays(torch, cw, x, mean, w, y)
        # A trace of TRACED_CALLS calls: every device operation in it is the
        # kernel, at most one per call.  (A trace of one short call can
        # come back empty after the serve phase; the profiler drops device
        # events now and then, so fewer than one per call may be recorded.)
        ops = [ev["name"][:80] for ev in trace_events(
            torch, lambda: cw.whiten_apply(x, mean, w), iters=TRACED_CALLS)]
        row["device_ops_per_call"] = sorted(set(ops))
        row["device_ops_in_trace"] = len(ops)
        ok = (ok and row["repeat_bitwise"] and row["graph_replay_bitwise"]
              and 1 <= len(ops) <= TRACED_CALLS
              and all(any(n in op for n in APPLY_KERNELS) for op in ops))
    row["ok"] = ok
    return row


def check_kernel(torch, cw, device, rate):
    """Parity at every shape (serve ``[M, C]``, train ``[D, M, C]``),
    timing at the bucket-128 shapes."""
    gen = torch.Generator(device=device).manual_seed(0)
    cpu_gen = torch.Generator().manual_seed(0)
    shapes = [(name, None, m, c) for name, m, c, _ in RESNET50_SITES]
    shapes += [("ragged_c64", None, RAGGED_M, 64), ("ragged_c256", None, RAGGED_M, 256)]
    shapes += [(f"train_{name}", DOMAINS, m, c) for name, m, c, _ in TRAIN_SITES]
    shapes += [("train_d1_c256", 1, 18 * 56 * 56, 256)]
    shapes += [(f"train_ragged_m{m}_c{c}", DOMAINS, m, c)
               for m in APPLY_RAGGED_M for c in (64, 256)]
    train_shapes = {f"train_{name}" for name, *_ in TRAIN_SITES}
    parity, timing = [], {}
    for name, d, m, c in shapes:
        x, mean, w = site_inputs(torch, m, c, gen, cpu_gen, device, d)
        row = apply_parity(torch, cw, name, x, mean, w, full=name in train_shapes)
        parity.append(row)
        emit({"phase": "parity", **row})
        if not row["ok"]:
            raise AssertionError(f"kernel disagrees with plain at {name}: {row}")
        if d is not None or m == RAGGED_M:
            continue
        row = {"shape": name, **time_apply(torch, cw, x, mean, w, rate)}
        timing[name] = row
        emit({"phase": "timing", **row})
        del x
        torch.cuda.empty_cache()
    return parity, timing


SERVED = {  # per served model: flags, image shape, classes, whitened
    # sites per forward, and the names of its phases
    "resnet50": dict(
        flags=["--model", "resnet50", "--num_classes", "65", "--image_size", "224"],
        shape=(224, 224, 3), classes=65, sites=11,
        phases=("engine", "serve", "reference", "throughput")),
    "lenet": dict(
        flags=["--model", "lenet"], shape=(28, 28, 1), classes=10, sites=2,
        phases=("digits_engine", "digits_serve", "digits_serve_reference",
                "digits_serve_throughput")),
}


def serve(torch, cw, server, model="resnet50"):
    """A main path: the port's HTTP server on ResNet50-DWT at 224² (or
    LeNet-DWT at 28×28); returns the apply kernel's launches on it."""
    import numpy as np

    spec = SERVED[model]
    shape, classes, sites = spec["shape"], spec["classes"], spec["sites"]
    engine_phase, serve_phase, reference_phase, throughput_phase = spec["phases"]
    args = server.build_parser().parse_args(spec["flags"] + [
        "--buckets", "1,8,32,128", "--init_random", "--seed", "0",
        "--host", "127.0.0.1", "--port", "0",
    ])
    t0 = time.perf_counter()
    engine = server.build_engine(args)
    build_s = time.perf_counter() - t0
    emit({"phase": engine_phase, "build_s": build_s, "warmup_s": engine.warmup_s,
          "device": str(engine.device),
          "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
          "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32})
    if torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("the engine must run f32 convs/matmuls without TF32")

    rng = np.random.default_rng(0)
    sizes = (1, 5, 32, 128)
    inputs = [rng.normal(size=(n,) + shape).astype(np.float32) for n in sizes]
    client = server.ServeClient(engine, max_batch_delay_ms=args.max_batch_delay_ms,
                                max_queue_items=args.max_queue)
    front = server.HttpFront(client, args.host, args.port)
    http = server.HttpServeClient(args.host, front.port, timeout=300)
    try:
        status, health = http.healthz()
        if status != 200 or not health["ok"]:
            raise AssertionError(f"/healthz: {status} {health}")
        cw.apply_launches = 0
        torch.cuda.reset_peak_memory_stats()
        responses, e2e_ms = [], []
        for x in inputs:
            t = time.perf_counter()
            responses.append(http.infer(x, binary=x.shape[0] >= 32))
            e2e_ms.append((time.perf_counter() - t) * 1e3)
        launches = cw.apply_launches
        batches = client.batches
        stats = http.stats()
    finally:
        http.close()
        front.close()
    forwards = sum(batches.values())
    emit({"phase": serve_phase, "model": model, "requests": list(sizes),
          "e2e_ms": e2e_ms, "batches_by_bucket": batches,
          "apply_launches": launches, "stats": stats})
    if batches != {1: 1, 8: 1, 32: 1, 128: 1}:
        raise AssertionError(f"expected one batch per bucket, got {batches}")
    if launches != sites * forwards:
        raise AssertionError(
            f"{launches} kernel launches for {forwards} forwards, not {sites} each")

    worst = 0.0
    for x, out in zip(inputs, responses):
        if out.shape != (x.shape[0], classes) or not np.isfinite(out).all():
            raise AssertionError(f"bad response {out.shape} for {x.shape[0]} images")
        err = norm_err(torch.from_numpy(out), torch.from_numpy(engine.infer(x)))
        worst = max(worst, err)
    if worst > TOL:
        raise AssertionError(f"HTTP logits differ from engine.infer by {worst}")

    # Kernel vs plain apply in the same bucket-8 forward, both on the card.
    x8 = engine.stage(inputs[1][:5].repeat(2, axis=0)[:8])
    with torch.inference_mode():
        kernel_logits = engine.forward(x8, 8).clone()
        kernel_fn = cw.whiten_apply
        cw.whiten_apply = cw.whiten_apply_plain
        try:
            plain_logits = engine.forward(x8, 8)
        finally:
            cw.whiten_apply = kernel_fn
    kernel_vs_plain = norm_err(kernel_logits, plain_logits)
    # The card's forward vs the same model on the CPU, one image.
    cpu_model = copy.deepcopy(engine.model).cpu()
    with torch.inference_mode():
        cpu_logits = cpu_model(torch.from_numpy(inputs[0]))
    gpu_vs_cpu = norm_err(torch.from_numpy(responses[0]), cpu_logits)
    emit({"phase": reference_phase, "http_vs_infer": worst,
          "kernel_vs_plain_bucket8": kernel_vs_plain,
          "gpu_vs_cpu_bucket1": gpu_vs_cpu, "tolerance": FORWARD_TOL,
          "logits_max_abs": float(np.abs(responses[-1]).max())})
    if kernel_vs_plain > FORWARD_TOL or gpu_vs_cpu > FORWARD_TOL:
        raise AssertionError("forward disagrees with its reference")

    per_bucket = {}
    for b in engine.buckets:
        xb = engine.stage(np.zeros((b,) + shape, np.float32))
        ms = cuda_ms(torch, lambda: engine.forward(xb, b), iters=10, warmup=2)
        per_bucket[b] = {"forward_ms": ms, "imgs_per_s": b / ms * 1e3}
    emit({"phase": throughput_phase, "per_bucket": per_bucket,
          "max_memory_allocated": torch.cuda.max_memory_allocated()})
    return launches


# ----------------------------------------------------------------- moments


def moments_input(torch, d, m, c, gen, device, offset=0.0):
    """``[d, m, c]``, each domain its own draw: channels correlated within
    a group, spread ~1.5, mean ``offset``."""
    x = torch.randn(d, m, c, generator=gen, device=device) * 1.5
    return x + 0.5 * x.roll(1, dims=2) + offset


def two_pass_f64(torch, x):
    """Per domain of ``x [D, M, C]``: mean and biased group cov in float64,
    the cov from the centred input."""
    xd = x.double()
    mean = xd.mean(dim=1)
    t = (xd - mean[:, None]).view(*x.shape[:2], -1, 4)
    return mean, torch.einsum("kmgc,kmgd->kgcd", t, t) / x.shape[1]


def moments_errors(torch, mean, cov, ref_mean, ref_cov):
    dm = (mean.double() - ref_mean.double()).abs()
    dc = (cov.double() - ref_cov.double()).abs()
    ok = bool((dm <= MEAN_TOL + MEAN_TOL * ref_mean.double().abs()).all()
              and (dc <= COV_ATOL + COV_RTOL * ref_cov.double().abs()).all())
    return float(dm.max()), float(dc.max()), ok


def graph_replays(torch, cw, x, eager):
    """Capture one moments launch in a CUDA graph, replay it twice over
    zeroed outputs: is every replay bitwise the eager result?  (The
    arrival counter must be zero again after each launch.)"""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = cw.whiten_moments(x, 4)
    same = []
    for _ in range(2):
        for t in captured:
            t.zero_()
        graph.replay()
        torch.cuda.synchronize()
        same.append(all(torch.equal(a, b) for a, b in zip(captured, eager)))
    del graph, captured
    return all(same)


def check_moments(torch, cw, device, rate):
    """Moments parity at every shape; moments and apply timing (one
    launch each per site, all domains) at the train shapes."""
    from dwt_tpu_torch.ops.whitening import _shrink, whitening_matrix

    gen = torch.Generator(device=device).manual_seed(1)
    shapes = [(name, DOMAINS, m, c, 0.0) for name, m, c, _ in TRAIN_SITES]
    shapes += [("d1_c256", 1, 18 * 56 * 56, 256, 0.0),
               ("d2_c64", 2, 18 * 56 * 56, 64, 0.0),
               ("ragged_c64", DOMAINS, RAGGED_M, 64, 0.0),
               ("ragged_c256", DOMAINS, RAGGED_M, 256, 0.0),
               ("offset_c256", DOMAINS, 18 * 56 * 56, 256, 4.0)]
    train_shapes = {name for name, *_ in TRAIN_SITES}
    parity, timing = [], {}
    for name, d, m, c, offset in shapes:
        x = moments_input(torch, d, m, c, gen, device, offset)
        before = cw.moments_launches
        mean, cov = cw.whiten_moments(x, 4)
        launches = cw.moments_launches - before
        again = cw.whiten_moments(x, 4)
        torch.cuda.synchronize()
        repeat_bitwise = torch.equal(again[0], mean) and torch.equal(again[1], cov)
        replay_bitwise = (graph_replays(torch, cw, x, (mean, cov))
                          if name in train_shapes else None)
        # What one call puts on the device: one kernel, nothing else.
        device_ops = [ev["name"][:80] for ev in
                      trace_events(torch, lambda: cw.whiten_moments(x, 4))]
        p_mean, p_cov = cw.whiten_moments_plain(x, 4)
        r_mean, r_cov = two_pass_f64(torch, x)
        # The apply kernel on all domains in one launch, each whitened with
        # its own moments as a train step whitens it.
        w = whitening_matrix(_shrink(cov, 1e-3))
        a_row = apply_parity(torch, cw, name, x, mean, w)
        a_err, a_ok = a_row["max_abs_err"], a_row["ok"]
        pm, pc, p_ok = moments_errors(torch, mean, cov, p_mean, p_cov)
        rm, rc, r_ok = moments_errors(torch, mean, cov, r_mean, r_cov)
        row = {"shape": name, "D": d, "M": m, "C": c, "mean_offset": offset,
               "launches": launches, "device_ops_per_call": device_ops,
               "repeat_bitwise": repeat_bitwise,
               "graph_replay_bitwise": replay_bitwise,
               "vs_plain": {"mean_max_abs_err": pm, "cov_max_abs_err": pc},
               "vs_f64_two_pass": {"mean_max_abs_err": rm, "cov_max_abs_err": rc},
               "plain_vs_f64_cov_max_abs_err":
                   moments_errors(torch, p_mean, p_cov, r_mean, r_cov)[1],
               "mean_tol": MEAN_TOL, "cov_rtol": COV_RTOL, "cov_atol": COV_ATOL,
               "apply_vs_plain": {"max_abs_err": a_err,
                                  "rtol": TOL, "atol": TOL, "ok": a_ok}}
        one_kernel = (len(device_ops) == 1
                      and any(n in device_ops[0] for n in MOMENTS_KERNELS))
        row["ok"] = (p_ok and r_ok and a_ok and launches == 1 and one_kernel
                     and repeat_bitwise and replay_bitwise is not False)
        parity.append(row)
        emit({"phase": "moments_parity", **row})
        if not row["ok"]:
            raise AssertionError(f"moments or apply kernel disagrees at {name}: {row}")
        if name not in train_shapes:
            continue
        row = {
            "shape": name, "D": d, "M": m, "C": c,
            "moments": {"per": f"one site: {d} domains, one launch",
                        **time_moments(torch, cw, x, rate)},
            "apply": {"per": f"one site: {d} domains, one launch",
                      **time_apply(torch, cw, x, mean, w, rate)},
        }
        timing[name] = row
        emit({"phase": "moments_timing", **row})
        del x
        torch.cuda.empty_cache()
    return parity, timing


# ------------------------------------------------------------------- train


def run_counted(torch, cw, run, phase):
    """Drive a train path: zero both kernels' launch counts, call
    ``run(logger)``, which trains through the loop with ``logger``; every
    record carries the counts at its emission.  Returns ``(result,
    records, launches over the run, seconds)``."""
    records = []

    def logger(kind, step, **fields):
        records.append({"kind": kind, "step": step,
                        "moments_launches": cw.moments_launches,
                        "apply_launches": cw.apply_launches, **fields})

    cw.moments_launches = cw.apply_launches = 0
    t0 = time.perf_counter()
    result = run(logger)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {"moments": cw.moments_launches, "apply": cw.apply_launches}
    for r in records:
        emit({"phase": phase, **r})
    return result, records, launches, seconds


def check_record_launches(records, launches, want):
    """Raise unless the launches between each record and the one before
    are ``want(record)`` (``{"moments": n, "apply": n}``) and no launch
    follows the last record."""
    prev = {"moments": 0, "apply": 0}
    for r in records:
        got = {k: r[f"{k}_launches"] - prev[k] for k in prev}
        prev = {k: r[f"{k}_launches"] for k in prev}
        if got != want(r):
            raise AssertionError(f"{r['kind']} at step {r['step']}: launches "
                                 f"{got}, expected {want(r)}")
    if prev != launches:
        raise AssertionError(f"launches after the last record: {launches} vs {prev}")


def expected_kinds(cfg):
    """The record sequence of ``run_officehome`` under ``cfg``."""
    kinds = []
    for it in range(cfg.num_iters):
        if it % cfg.log_interval == 0:
            kinds.append("train")
        if (it + 1) % cfg.check_acc_step == 0:
            kinds.append("test")
    return kinds + ["stat_collection"] * cfg.stat_collection_passes + ["final_test"]


class TimedBatches:
    """Replaces the trainer's ``prefetch_to_device`` for one run with a
    wrapper that stamps, per train step, the host clock when the loop
    asks for the step's batch and when it gets it.  With ``--log_interval
    1`` the loop reads every step's losses, so the time from one batch to
    the next is a step, the wait for its batch included."""

    def __init__(self, loop):
        self.loop = loop
        self.stamps = []  # (asked, got) per step

    def __enter__(self):
        inner = self.inner = self.loop.prefetch_to_device
        stamps = self.stamps

        def timed(*args, **kwargs):
            it = inner(*args, **kwargs)

            def gen():
                try:
                    while True:
                        asked = time.perf_counter()
                        try:
                            batch = next(it)
                        except StopIteration:
                            return
                        stamps.append((asked, time.perf_counter()))
                        yield batch
                finally:
                    it.close()

            return gen()

        self.loop.prefetch_to_device = timed
        return self

    def __exit__(self, *exc):
        self.loop.prefetch_to_device = self.inner

    def summary(self):
        """Median step (batch to batch, the steps after the first; an eval
        between two steps lands in one interval and not in the median),
        and the mean wait for a batch of those steps and of the first."""
        import statistics

        got = [g for _, g in self.stamps]
        periods = [(b - a) * 1e3 for a, b in zip(got, got[1:])]
        waits = [(g - a) * 1e3 for a, g in self.stamps]
        return {"step_ms_median": statistics.median(periods) if periods else None,
                "step_ms_all": periods,
                "batch_wait_ms_mean": (statistics.fmean(waits[1:])
                                       if len(waits) > 1 else None),
                "batch_wait_ms_first": waits[0] if waits else None,
                "batch_wait_ms_max": max(waits[1:]) if len(waits) > 1 else None}


def train(torch, cw, officehome, loop, flags=TRAIN_FLAGS, phase="train"):
    """A train path through the CLI entry (by default the main synthetic
    one); returns the kernels' launches on it and its step timing."""
    import math

    cfg = officehome.config_from_args(officehome.build_parser().parse_args(flags))
    model = loop.build_model(cfg)
    init = {k: v.detach().clone() for k, v in model.state_dict().items()}
    with TimedBatches(loop) as timed:
        acc, records, launches, seconds = run_counted(
            torch, cw, lambda logger: loop.run_officehome(cfg, logger, model=model),
            f"{phase}_record")

    # Launches per record, against what each phase must launch.
    def want(r):
        n = r.get("forwards", 1)
        return {
            "train": {"moments": WHITENED_SITES, "apply": WHITENED_SITES},
            "stat_collection": {"moments": WHITENED_SITES * n,
                                "apply": WHITENED_SITES * n},
            "test": {"moments": 0, "apply": WHITENED_SITES * n},
            "final_test": {"moments": 0, "apply": WHITENED_SITES * n},
        }[r["kind"]]

    check_record_launches(records, launches, want)
    kinds = [r["kind"] for r in records]
    if kinds != expected_kinds(cfg):
        raise AssertionError(f"unexpected record sequence {kinds}")
    for r in records:
        if r["kind"] == "train":
            bad = [k for k in ("loss", "cls_loss", "mec_loss", "grad_norm")
                   if not math.isfinite(r[k])]
            if bad:
                raise AssertionError(f"non-finite {bad} at step {r['step']}")
    if not (math.isfinite(acc) and 0.0 <= acc <= 100.0
            and acc == records[-1]["accuracy"]):
        raise AssertionError(f"bad accuracy {acc}")
    state = model.state_dict()
    unmoved = [k for k, p in model.named_parameters()
               if torch.equal(p.detach().cpu(), init[k])]
    covs = [k for k in state if k.endswith(".cov") or k == "dn1.cov"]
    cov_unmoved = [f"{k}[{d}]" for k in covs for d in range(state[k].shape[0])
                   if torch.equal(state[k][d].cpu(), torch.ones_like(init[k][d]))]
    timing = timed.summary()
    emit({"phase": phase, "flags": flags, "seconds": seconds,
          "accuracy": acc, "launches": launches,
          "whitening_sites": len(covs), "unmoved_params": unmoved,
          "unmoved_covs": cov_unmoved, **timing})
    if unmoved or cov_unmoved or len(covs) != WHITENED_SITES:
        raise AssertionError("training left parameters or stats unmoved")
    return launches, timing


def synthetic_batch(torch, loop, n, size, classes, seed, device):
    """One train batch (three streams) from the trainer's synthetic data."""
    shape = (size, size, 3)
    arrays = [loop._synthetic_classification_arrays(n, shape, classes, seed + i,
                                                    0.5 * (i > 0))
              for i in range(3)]
    to = lambda a: torch.from_numpy(a).to(device)
    return {"source_x": to(arrays[0][0]), "source_y": to(arrays[0][1]),
            "target_x": to(arrays[1][0]), "target_aug_x": to(arrays[2][0])}


def one_step(torch, cfg, model, batch, device):
    from dwt_tpu_torch.train.optim import officehome_tx
    from dwt_tpu_torch.train.state import TrainState
    from dwt_tpu_torch.train.steps import make_officehome_train_step

    model.to(device, memory_format=torch.channels_last)
    optimizer, schedules = officehome_tx(model, cfg)
    state = TrainState(model, optimizer, schedules)
    metrics = make_officehome_train_step(model, cfg.lambda_mec_loss)(
        state, {k: v.to(device) for k, v in batch.items()})
    if device.type == "cuda":
        torch.cuda.synchronize()
    return {k: float(v) for k, v in metrics.items()}, model


def float64_model(torch, model):
    """``model`` in float64, for a reference step.  The card's float64
    convolutions return NCHW-contiguous activations; a pre-hook on every
    norm site gives them the channels_last layout whose domain split is
    a view (``apply_domain_norm`` takes no other)."""
    from dwt_tpu_torch.nn.norms import DomainBatchNorm, DomainWhiten

    def channels_last(_site, args):
        x = args[0]
        if x.dim() != 4:
            return None
        return (x.contiguous(memory_format=torch.channels_last),)

    for site in model.modules():
        if isinstance(site, (DomainWhiten, DomainBatchNorm)):
            site.register_forward_pre_hook(channels_last)
    return model.double()


def f32_ulp(torch, v):
    """The spacing of float32 values at ``v`` (a float64 tensor)."""
    a = v.float().abs()
    return (torch.nextafter(a, torch.full_like(a, float("inf"))) - a).double()


def compare_steps(torch, a, b, init):
    """Two train steps from the same ``init`` state, ``b`` the reference.

    Relative errors of the metrics and of every running stat (max |a − b|
    / max |b| per stat tensor, the worst in ``stats``), and per parameter
    (``by_leaf``), with the worst leaf of each in ``*_worst``:

    * ``grad``: ‖g_a − g_b‖ / ‖g_b‖ of the step's gradient (the optimizer
      keeps it in ``.grad``);
    * ``update``: ‖Δa − Δb‖ / ‖Δb‖ with Δ = post − pre, as stored;
    * ``update_beyond_rounding``: the same after forgiving each element
      one float32 spacing of its stored value, ‖max(|a − b| − ulp, 0)‖ /
      ‖Δb‖.  A step moves a norm's γ ≈ 1 by ~1e-6 at the backbone's lr,
      and storing γ + Δ in float32 rounds Δ by up to 6e-8: percent of Δ
      that no computation of the step can remove.

    ``update`` and ``grad`` are also given over all parameters at once.
    """
    (ma, model_a), (mb, model_b) = a, b
    out = {k: abs(ma[k] - mb[k]) / max(abs(mb[k]), 1e-30)
           for k in STEP_METRICS if k in mb}
    sa, sb = model_a.state_dict(), model_b.state_dict()
    grads_a = {k: p.grad for k, p in model_a.named_parameters()}
    grads_b = {k: p.grad for k, p in model_b.named_parameters()}
    sums = {"update": [0.0, 0.0], "grad": [0.0, 0.0]}
    worst = (0.0, "")
    leaves = {}
    for k, ref in sb.items():
        ref, got = ref.detach().double().cpu(), sa[k].detach().double().cpu()
        if k not in grads_b:
            err = float((got - ref).abs().max() / max(float(ref.abs().max()), 1e-30))
            worst = max(worst, (err, k))
            continue
        step = float((ref - init[k].double()).norm())
        diff = (got - ref).abs()
        ga, gb = grads_a[k].double().cpu(), grads_b[k].double().cpu()
        g_diff, g_norm = float((ga - gb).norm()), float(gb.norm())
        leaves[k] = {
            "update": float(diff.norm()) / max(step, 1e-300),
            "update_beyond_rounding": float(
                (diff - f32_ulp(torch, ref)).clamp_min(0).norm()) / max(step, 1e-300),
            "grad": g_diff / max(g_norm, 1e-300),
        }
        sums["update"][0] += float(diff.square().sum())
        sums["update"][1] += step ** 2
        sums["grad"][0] += g_diff ** 2
        sums["grad"][1] += g_norm ** 2
    out["stats"], out["stats_worst"] = worst
    for key, (num, den) in sums.items():
        out[key] = (num / den) ** 0.5
    for key in ("update", "update_beyond_rounding", "grad"):
        leaf = max(leaves, key=lambda k: leaves[k][key])
        out[f"{key}_worst"] = {"leaf": leaf, "err": leaves[leaf][key]}
    out["by_leaf"] = leaves
    return out


def leaf_summary(errs):
    """``compare_steps``'s result without its per-leaf table."""
    return {k: v for k, v in errs.items() if k != "by_leaf"}


def check_step(name, errs, leaf_tol, head_tol=None, skip=()):
    """Raise unless the metrics and stats are within ``TRAIN_TOL`` (the
    grad norm ``TRAIN_GRAD_TOL``) and every parameter's gradient and
    update (beyond rounding) within ``leaf_tol`` — the head's
    (``fc_out.*``) within ``head_tol`` when given; the leaves in ``skip``
    are checked by the caller."""
    tols = {"grad_norm": TRAIN_GRAD_TOL}
    bad = {k: errs[k] for k in (*STEP_METRICS, "stats")
           if k in errs and errs[k] > tols.get(k, TRAIN_TOL)}
    for leaf, e in errs["by_leaf"].items():
        if leaf in skip:
            continue
        tol = head_tol if head_tol is not None and leaf.startswith("fc_out.") else leaf_tol
        for key in ("grad", "update_beyond_rounding"):
            if e[key] > tol:
                bad[f"{leaf} {key}"] = e[key]
    if bad:
        worst = sorted(bad.items(), key=lambda kv: -kv[1])[:8]
        raise AssertionError(f"{name}: {len(bad)} errors over their limits; "
                             f"the largest: {worst}")


def train_reference(torch, cw, loop, device):
    from dwt_tpu_torch.config import OfficeHomeConfig

    # Kernels vs their plain versions, both on the card, ResNet50 at 224².
    n, size = REFERENCE_STEP
    cfg = OfficeHomeConfig(seed=2, img_crop_size=size, source_batch_size=n)
    batch = synthetic_batch(torch, loop, n, size, 65, 5, device)
    base = loop.build_model(cfg)
    init = {k: v.detach().clone() for k, v in base.state_dict().items()}
    kernels = (cw.whiten_moments, cw.whiten_apply)
    before = (cw.moments_launches, cw.apply_launches)
    kernel_step = one_step(torch, cfg, copy.deepcopy(base), batch, device)
    kernel_launches = (cw.moments_launches - before[0],
                       cw.apply_launches - before[1])
    cw.whiten_moments, cw.whiten_apply = cw.whiten_moments_plain, cw.whiten_apply_plain
    try:
        plain_step = one_step(torch, cfg, copy.deepcopy(base), batch, device)
        f64_step = one_step(torch, cfg, float64_model(torch, base), {
            k: v.double() if v.is_floating_point() else v
            for k, v in batch.items()}, device)
    finally:
        cw.whiten_moments, cw.whiten_apply = kernels
    vs_plain = compare_steps(torch, kernel_step, plain_step, init)
    vs_f64 = compare_steps(torch, kernel_step, f64_step, init)
    plain_vs_f64 = compare_steps(torch, plain_step, f64_step, init)
    del kernel_step, plain_step, f64_step, base
    torch.cuda.empty_cache()

    # The tiny model's step on the card vs on the CPU (8 images per
    # stream: fewer make its stage-4 BN ill-conditioned).
    tiny = OfficeHomeConfig(arch="tiny", num_classes=5, img_crop_size=32, seed=3)
    batch = synthetic_batch(torch, loop, 8, 32, 5, 7, torch.device("cpu"))
    base = loop.build_model(tiny)
    init = {k: v.detach().clone() for k, v in base.state_dict().items()}
    card = one_step(torch, tiny, copy.deepcopy(base), batch, device)
    cpu = one_step(torch, tiny, base, batch, torch.device("cpu"))
    vs_cpu = compare_steps(torch, card, cpu, init)
    emit({"phase": "train_reference",
          "kernel_vs_plain_resnet50": leaf_summary(vs_plain),
          "kernel_vs_f64_resnet50": leaf_summary(vs_f64),
          "plain_vs_f64_resnet50": leaf_summary(plain_vs_f64),
          "kernel_launches": kernel_launches,
          "card_vs_cpu_tiny": leaf_summary(vs_cpu),
          "tolerance": TRAIN_TOL, "grad_tolerance": TRAIN_GRAD_TOL,
          "resnet50_leaf_tolerance": dict(zip(("backbone", "head"), RESNET50_LEAF_TOL)),
          "f64_ratio_tolerance": F64_RATIO_TOL,
          "tiny_leaf_tolerance": TINY_LEAF_TOL,
          "why": "sums in other orders (kernel vs plain, f32 vs float64, "
                 "card vs CPU); each stored parameter's own float32 "
                 "rounding is forgiven"})
    if kernel_launches != (WHITENED_SITES, WHITENED_SITES):
        raise AssertionError(f"kernel step launched {kernel_launches}")
    for what, errs in (("kernels vs plain", vs_plain), ("kernels vs float64", vs_f64)):
        check_step(f"{what} (ResNet50)", errs, *RESNET50_LEAF_TOL)
    if vs_f64["grad"] > F64_RATIO_TOL * plain_vs_f64["grad"]:
        raise AssertionError(
            f"the kernel step's gradient is {vs_f64['grad']} from float64, "
            f"over {F64_RATIO_TOL} times the plain step's {plain_vs_f64['grad']}")
    check_step("card vs CPU (tiny)", vs_cpu, TINY_LEAF_TOL)


def train_throughput(torch, loop, device):
    from dwt_tpu_torch.config import OfficeHomeConfig
    from dwt_tpu_torch.train.evalpipe import install_whiten_cache, make_whiten_cache
    from dwt_tpu_torch.train.optim import officehome_tx
    from dwt_tpu_torch.train.state import TrainState
    from dwt_tpu_torch.train.steps import (
        eval_counters,
        make_accum_eval_step,
        make_officehome_train_step,
        make_stat_collection_step,
    )

    n, size = REFERENCE_STEP
    cfg = OfficeHomeConfig(seed=4, img_crop_size=size, source_batch_size=n)
    model = loop.build_model(cfg).to(device, memory_format=torch.channels_last)
    optimizer, schedules = officehome_tx(model, cfg)
    state = TrainState(model, optimizer, schedules)
    step = make_officehome_train_step(model, cfg.lambda_mec_loss)
    batch = synthetic_batch(torch, loop, n, size, 65, 11, device)
    torch.cuda.reset_peak_memory_stats()
    step_ms = cuda_ms(torch, lambda: step(state, batch), iters=5, warmup=2)
    peak = torch.cuda.max_memory_allocated()
    x = batch["target_x"][: cfg.test_batch_size]
    y = batch["source_y"][: cfg.test_batch_size]
    mask = torch.ones_like(y, dtype=torch.bool)
    collect = make_stat_collection_step(model, 3)
    collect_ms = cuda_ms(torch, lambda: collect(state, x), iters=5, warmup=1)
    install_whiten_cache(model, make_whiten_cache(model))
    accum = make_accum_eval_step(model)
    counters = eval_counters(device)
    eval_ms = cuda_ms(torch, lambda: accum(counters, x, y, mask), iters=5, warmup=1)
    install_whiten_cache(model, None)
    images = 3 * cfg.source_batch_size
    row = {"phase": "train_throughput", "images_per_step": images,
           "step_ms": step_ms, "imgs_per_s": images / step_ms * 1e3,
           "stat_collection_forward_ms": collect_ms,
           "eval_forward_ms": eval_ms, "test_batch": cfg.test_batch_size,
           "max_memory_allocated": peak}
    emit(row)
    del model, optimizer, state, batch
    torch.cuda.empty_cache()
    return row


# --------------------------------------------------------- the folder path


def folder_flags(root):
    return ["--s_dset_path", os.path.join(root, FOLDER_DOMAINS[0]),
            "--t_dset_path", os.path.join(root, FOLDER_DOMAINS[1]),
            *FOLDER_TRAIN_FLAGS]


def write_folders(root):
    """The two OfficeHome-shaped folders: smooth random images (a coarse
    6×6 draw resized bilinear, plus N(0, 8) noise), all from seed 1.
    Returns the JPEG bytes written."""
    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(1)
    written = 0
    for domain in FOLDER_DOMAINS:
        for k in range(FOLDER_CLASSES):
            d = os.path.join(root, domain, f"class_{k:02d}")
            os.makedirs(d)
            for i in range(FOLDER_PER_CLASS):
                w, h = (int(v) for v in rng.integers(FOLDER_SIDES[0],
                                                     FOLDER_SIDES[1] + 1, size=2))
                coarse = rng.integers(0, 256, size=(6, 6, 3), dtype=np.uint8)
                img = np.asarray(Image.fromarray(coarse).resize((w, h), Image.BILINEAR),
                                 np.float32) + rng.normal(0, 8, size=(h, w, 3))
                path = os.path.join(d, f"{i}.jpg")
                Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(
                    path, quality=90)
                written += os.path.getsize(path)
    return written


class Indexed:
    """A dataset whose items carry their index as a last field, so that a
    batch names the items it holds."""

    def __init__(self, dataset):
        self.dataset = dataset

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, i):
        return (*self.dataset[i], i)


def same_batches(a, b) -> bool:
    import numpy as np

    return len(a) == len(b) and all(
        len(x) == len(y) and all(np.asarray(u).dtype == np.asarray(v).dtype
                                 and np.array_equal(u, v) for u, v in zip(x, y))
        for x, y in zip(a, b))


def data_plane(torch, officehome, loop, device, root):
    """The data plane on the folders: the streams' batch ids against the
    seekable sampler, a stream opened at cursor 4 against the suffix of
    one opened at 0, 1 against 4 loader threads, a prefetched batch on the
    card against its numpy source (all bitwise); then images per second of
    each stream per thread count and the host-to-device time of a batch."""
    import numpy as np

    from dwt_tpu_torch.data.loader import prefetch_to_device
    from dwt_tpu_torch.data.sampler import SeekableSampler

    cfg = officehome.config_from_args(officehome.build_parser().parse_args(
        folder_flags(root)))
    source_ds, target_ds, _ = loop._officehome_datasets(cfg)
    bs = cfg.source_batch_size
    data = {"source": Indexed(source_ds), "target": Indexed(target_ds)}
    plane = loop.officehome_plane(cfg, source_ds, target_ds)
    steps = 12  # crosses the epoch boundary at 10
    whole = {}
    for role, ds in data.items():
        pos = plane.streams[role]
        stream = plane.stream(ds, role, bs)
        whole[role] = [next(stream) for _ in range(steps)]
        stream.close()
        order = np.concatenate([SeekableSampler(len(ds), pos.seed, e).positions()[
            : pos.epoch_len * bs] for e in range(2)])
        ids = [b[-1].tolist() for b in whole[role]]
        if ids != [order[k * bs:(k + 1) * bs].tolist() for k in range(steps)]:
            raise AssertionError(f"{role} batch ids differ from the sampler's")
    resumed = loop.officehome_plane(cfg, source_ds, target_ds)
    resumed.seek_step(4)
    stream = resumed.stream(data["target"], "target", bs)
    suffix = [next(stream) for _ in range(steps - 4)]
    stream.close()
    if not same_batches(suffix, whole["target"][4:]):
        raise AssertionError("a stream opened at cursor 4 is not the suffix")
    one = loop.officehome_plane(cfg, source_ds, target_ds)
    one.num_workers = 1
    stream = one.stream(data["target"], "target", bs)
    single = [next(stream) for _ in range(3)]
    stream.close()
    if not same_batches(single, whole["target"][:3]):
        raise AssertionError("1 and 4 loader threads give other batches")
    host = list(loop.officehome_batches(
        loop.officehome_plane(cfg, source_ds, target_ds), source_ds, target_ds,
        bs, 2))
    staged = list(prefetch_to_device(iter(host), device=device))
    torch.cuda.synchronize()
    for a, b in zip(staged, host):
        if not all(a[k].device == device and np.array_equal(a[k].cpu().numpy(), v)
                   for k, v in b.items()):
            raise AssertionError("a prefetched batch differs from its source")

    rates = {}
    epoch = 2
    for workers in WORKER_COUNTS:
        plane.num_workers = workers
        for role, ds in data.items():
            epoch += 1
            t0 = time.perf_counter()
            it = plane.epoch_iterator(ds, role, bs, epoch=epoch, start_batch=0)
            for _ in range(RATE_BATCHES):
                next(it)
            seconds = time.perf_counter() - t0
            it.close()
            views = 2 if role == "target" else 1
            rates[f"{role}_w{workers}"] = {
                "items_per_s": RATE_BATCHES * bs / seconds,
                "images_per_s": RATE_BATCHES * bs * views / seconds}
    # Host-to-device: the batch's bytes from pinned memory on a side stream
    # (CUDA events), and a batch through prefetch_to_device from numpy
    # (host copy into the pinned ring included; wall clock).
    batch = host[0]
    nbytes = sum(v.nbytes for v in batch.values())
    pinned = {k: torch.from_numpy(v).pin_memory() for k, v in batch.items()}
    dev = {k: torch.empty_like(v, device=device) for k, v in pinned.items()}
    side = torch.cuda.Stream(device)
    with torch.cuda.stream(side):
        h2d_ms = cuda_ms(torch, lambda: [dev[k].copy_(v, non_blocking=True)
                                         for k, v in pinned.items()], iters=10, warmup=2)
    reps = 10
    t0 = time.perf_counter()
    for b in prefetch_to_device(iter([batch] * reps), device=device):
        pass
    torch.cuda.synchronize()
    prefetch_ms = (time.perf_counter() - t0) / reps * 1e3
    row = {"phase": "data_plane", "images": {r: len(d) for r, d in data.items()},
           "epoch_len": {r: plane.streams[r].epoch_len for r in data},
           "ids_checked_batches": steps, "suffix_from_cursor": 4,
           "workers_compared": [1, cfg.num_workers], "rates": rates,
           "batch_bytes": nbytes, "h2d_ms_per_batch": h2d_ms,
           "h2d_GBps": nbytes / h2d_ms / 1e6,
           "prefetch_ms_per_batch_wall": prefetch_ms,
           "cpu_count": os.cpu_count()}
    emit(row)
    return row


def folder_profile(torch, officehome, loop, device, root, step_ms):
    """The card's idle share over ``PROFILED_STEPS`` folder steps (after 2
    warm-up steps): device busy time in a profiler trace against the
    traced span, and against the unprofiled step ``step_ms``."""
    from dwt_tpu_torch.train.optim import officehome_tx
    from dwt_tpu_torch.train.state import TrainState
    from dwt_tpu_torch.train.steps import make_officehome_train_step

    cfg = officehome.config_from_args(officehome.build_parser().parse_args(
        folder_flags(root)))
    source_ds, target_ds, _ = loop._officehome_datasets(cfg)
    plane = loop.officehome_plane(cfg, source_ds, target_ds)
    model = loop.build_model(cfg).to(device, memory_format=torch.channels_last)
    optimizer, schedules = officehome_tx(model, cfg)
    state = TrainState(model, optimizer, schedules)
    step = make_officehome_train_step(model, cfg.lambda_mec_loss)
    produce = loop.officehome_batches(plane, source_ds, target_ds,
                                      cfg.source_batch_size, 2 + 3 * PROFILED_STEPS)
    batches = loop.prefetch_to_device(produce, device=device)

    def one():
        step(state, next(batches))
        plane.advance(1)

    try:
        for _ in range(2):
            one()
        events = trace_events(torch, one, iters=PROFILED_STEPS)
    finally:
        batches.close()
        produce.close()
    busy_ms = sum(ev["dur"] for ev in events) / 1e3 / PROFILED_STEPS
    span_ms = (max(ev["ts"] + ev["dur"] for ev in events)
               - min(ev["ts"] for ev in events)) / 1e3 / PROFILED_STEPS
    row = {"phase": "folder_profile", "steps": PROFILED_STEPS,
           "device_ops_per_step": len(events) / PROFILED_STEPS,
           "device_busy_ms_per_step": busy_ms,
           "profiled_span_ms_per_step": span_ms,
           "idle_share_in_profile": 1.0 - busy_ms / span_ms,
           "idle_share": 1.0 - busy_ms / step_ms}
    emit(row)
    del model, optimizer, state
    torch.cuda.empty_cache()
    return row


# ------------------------------------------------------------------ digits


def check_digits_kernels(torch, cw, device, rate):
    """Both kernels at LeNet-DWT's two whitened sites (``dn1`` C = 32, ``dn2``
    C = 48, groups of 4): parity with the plain versions (the moments also
    with a float64 two-pass reference) and times, L2 cold, at the train
    shapes (``[2, M, C]``, 32 images per stream; the apply in one launch
    for both domains, also at D = 1 and at ragged M), the eval shapes
    (test batch 100) and the serve shapes of buckets 1 and 128."""
    from dwt_tpu_torch.ops.whitening import _shrink, whitening_matrix

    gen = torch.Generator(device=device).manual_seed(2)
    cpu_gen = torch.Generator().manual_seed(2)
    apply_errs, moments_errs, timing = {}, {}, {}
    for site, c, hw in DIGITS_SITES:
        m = DIGITS_STREAM * hw
        x = moments_input(torch, 2, m, c, gen, device)
        before = cw.moments_launches
        mean, cov = cw.whiten_moments(x, 4)
        launches = cw.moments_launches - before
        again = cw.whiten_moments(x, 4)
        torch.cuda.synchronize()
        repeat_bitwise = torch.equal(again[0], mean) and torch.equal(again[1], cov)
        pm, pc, p_ok = moments_errors(torch, mean, cov, *cw.whiten_moments_plain(x, 4))
        rm, rc, r_ok = moments_errors(torch, mean, cov, *two_pass_f64(torch, x))
        w = whitening_matrix(_shrink(cov, 1e-3))
        a_row = apply_parity(torch, cw, f"train_{site}", x, mean, w, full=True)
        moments_errs[site] = max(pm, pc)
        apply_errs[("train", site)] = a_row["max_abs_err"]
        row = {"shape": f"train_{site}", "D": 2, "M": m, "C": c,
               "launches": launches, "repeat_bitwise": repeat_bitwise,
               "vs_plain": {"mean_max_abs_err": pm, "cov_max_abs_err": pc},
               "vs_f64_two_pass": {"mean_max_abs_err": rm, "cov_max_abs_err": rc},
               "mean_tol": MEAN_TOL, "cov_rtol": COV_RTOL, "cov_atol": COV_ATOL,
               "apply_vs_plain": a_row,
               "ok": (p_ok and r_ok and a_row["ok"] and launches == 1
                      and repeat_bitwise)}
        emit({"phase": "digits_parity", **row})
        if not row["ok"]:
            raise AssertionError(f"digits kernels disagree at train_{site}: {row}")
        timing[("train", site)] = {"moments": time_moments(torch, cw, x, rate),
                                   "apply": time_apply(torch, cw, x, mean, w, rate)}
        emit({"phase": "digits_timing", "shape": f"train_{site}",
              **timing[("train", site)]})
        del x, again
        # The batched apply at one domain and at ragged M.
        for d, rows in ((1, m), *((2, r) for r in APPLY_RAGGED_M)):
            name = f"train_d{d}_m{rows}_{site}"
            a_row = apply_parity(torch, cw, name,
                                 *site_inputs(torch, rows, c, gen, cpu_gen, device, d))
            apply_errs[("train", name)] = a_row["max_abs_err"]
            emit({"phase": "digits_parity", **a_row})
            if not a_row["ok"]:
                raise AssertionError(f"apply kernel disagrees at {name}: {a_row}")
        for path, n in DIGITS_APPLY_BATCHES:
            xa, ma, wa = site_inputs(torch, n * hw, c, gen, cpu_gen, device)
            a_row = apply_parity(torch, cw, f"{path}_{site}", xa, ma, wa)
            apply_errs[(path, site)] = a_row["max_abs_err"]
            emit({"phase": "digits_parity", **a_row})
            if not a_row["ok"]:
                raise AssertionError(f"apply kernel disagrees at {path}_{site}")
            timing[(path, site)] = {"apply": time_apply(torch, cw, xa, ma, wa, rate)}
            emit({"phase": "digits_timing", "shape": f"{path}_{site}",
                  **timing[(path, site)]})
        torch.cuda.empty_cache()
    return apply_errs, moments_errs, timing


def digits_train(torch, cw, usps_mnist, loop):
    """The digits main path, through the trainer's CLI entry: LeNet-DWT,
    32 images per stream, 2 epochs of 8 steps, an eval after each; returns
    the kernels' launches on it."""
    import math

    cfg = usps_mnist.config_from_args(usps_mnist.build_parser().parse_args(
        DIGITS_TRAIN_FLAGS))
    model = loop.build_digits_model(cfg)
    init = {k: v.detach().clone() for k, v in model.state_dict().items()}
    acc, records, launches, seconds = run_counted(
        torch, cw, lambda logger: loop.run_digits(cfg, logger, model=model),
        "digits_train_record")
    sites = len(DIGITS_SITES)
    check_record_launches(records, launches, lambda r: {
        "train": {"moments": sites, "apply": sites},
        "test": {"moments": 0, "apply": sites * r.get("forwards", 0)},
    }[r["kind"]])
    kinds = [r["kind"] for r in records]
    if kinds != (["train"] * 8 + ["test"]) * 2:
        raise AssertionError(f"unexpected record sequence {kinds}")
    for r in records:
        if r["kind"] == "train":
            bad = [k for k in ("loss", "cls_loss", "entropy_loss", "grad_norm")
                   if not math.isfinite(r[k])]
            if bad:
                raise AssertionError(f"non-finite {bad} at step {r['step']}")
        elif r["forwards"] != 2 or r["count"] != 128:
            raise AssertionError(f"eval of {r['count']} images in {r['forwards']} "
                                 "forwards, not 128 in 2")
    if not (math.isfinite(acc) and 0.0 <= acc <= 100.0
            and acc == records[-1]["accuracy"]):
        raise AssertionError(f"bad accuracy {acc}")
    state = model.state_dict()
    unmoved = [k for k, p in model.named_parameters()
               if torch.equal(p.detach().cpu(), init[k])]
    cov_unmoved = [f"{site}.cov[{d}]" for site, _, _ in DIGITS_SITES for d in range(2)
                   if torch.equal(state[f"{site}.cov"][d].cpu(), init[f"{site}.cov"][d])]
    emit({"phase": "digits_train", "flags": DIGITS_TRAIN_FLAGS, "seconds": seconds,
          "accuracy": acc, "launches": launches, "unmoved_params": unmoved,
          "unmoved_covs": cov_unmoved})
    if unmoved or cov_unmoved:
        raise AssertionError("training left parameters or stats unmoved")
    return launches


def digits_batch(torch, loop, seed, device, dtype=None):
    """One digits train batch (two streams of ``DIGITS_STREAM`` images) from
    the trainer's synthetic data."""
    arrays = [loop._synthetic_classification_arrays(
        DIGITS_STREAM, (28, 28, 1), 10, seed + i, 0.5 * i) for i in range(2)]
    to = lambda a: torch.from_numpy(a).to(device)
    batch = {"source_x": to(arrays[0][0]), "source_y": to(arrays[0][1]),
             "target_x": to(arrays[1][0])}
    if dtype is not None:
        batch = {k: v.to(dtype) if v.is_floating_point() else v
                 for k, v in batch.items()}
    return batch


def digits_step(torch, cfg, model, batch, device):
    """One digits train step of ``model`` on ``device``; returns its
    metrics as floats and the model (its ``.grad`` the step's gradient)."""
    from dwt_tpu_torch.train.optim import digits_tx
    from dwt_tpu_torch.train.state import TrainState
    from dwt_tpu_torch.train.steps import make_digits_train_step

    model.to(device, memory_format=torch.channels_last)
    optimizer, schedules = digits_tx(model, cfg, DIGITS_STEPS_PER_EPOCH)
    state = TrainState(model, optimizer, schedules)
    metrics = make_digits_train_step(model, cfg.lambda_entropy_loss)(
        state, {k: v.to(device) for k, v in batch.items()})
    torch.cuda.synchronize()
    return {k: float(v) for k, v in metrics.items()}, model


def noise_share(torch, step):
    """The largest gradient of the biases that feed a normalization site
    (their exact gradient is zero), relative to the step's gradient norm."""
    metrics, model = step
    grads = dict((k, p.grad) for k, p in model.named_parameters())
    return max(float(grads[k].norm()) for k in DIGITS_NORMALIZED_BIASES) / metrics["grad_norm"]


def digits_reference(torch, cw, loop, device):
    """One LeNet-DWT step through the kernels against the same step with
    both kernels swapped for their plain versions and against a float64
    step of the plain versions, all on the card, from the same weights and
    batch (tolerances and their readings at ``DIGITS_LEAF_TOL``)."""
    from dwt_tpu_torch.config import DigitsConfig

    cfg = DigitsConfig(seed=2, group_size=4)
    batch = digits_batch(torch, loop, 5, device)
    base = loop.build_digits_model(cfg)
    init = {k: v.detach().clone() for k, v in base.state_dict().items()}
    kernels = (cw.whiten_moments, cw.whiten_apply)
    before = (cw.moments_launches, cw.apply_launches)
    kernel_step = digits_step(torch, cfg, copy.deepcopy(base), batch, device)
    launches = (cw.moments_launches - before[0], cw.apply_launches - before[1])
    cw.whiten_moments, cw.whiten_apply = cw.whiten_moments_plain, cw.whiten_apply_plain
    try:
        plain_step = digits_step(torch, cfg, copy.deepcopy(base), batch, device)
        f64_step = digits_step(torch, cfg, float64_model(torch, base),
                               digits_batch(torch, loop, 5, device, torch.float64),
                               device)
    finally:
        cw.whiten_moments, cw.whiten_apply = kernels
    vs_plain = compare_steps(torch, kernel_step, plain_step, init)
    vs_f64 = compare_steps(torch, kernel_step, f64_step, init)
    plain_vs_f64 = compare_steps(torch, plain_step, f64_step, init)
    noise = {name: noise_share(torch, st) for name, st in (
        ("kernel", kernel_step), ("plain", plain_step), ("float64", f64_step))}
    emit({"phase": "digits_reference",
          "kernel_vs_plain": leaf_summary(vs_plain),
          "kernel_vs_f64": leaf_summary(vs_f64),
          "plain_vs_f64": leaf_summary(plain_vs_f64),
          "kernel_launches": launches,
          "normalized_bias_grad_share": noise,
          "tolerance": TRAIN_TOL, "grad_tolerance": TRAIN_GRAD_TOL,
          "leaf_tolerance": DIGITS_LEAF_TOL, "f64_ratio_tolerance": F64_RATIO_TOL,
          "noise_tolerance": DIGITS_NOISE_TOL,
          "by_leaf_kernel_vs_f64": vs_f64["by_leaf"]})
    if launches != (len(DIGITS_SITES), len(DIGITS_SITES)):
        raise AssertionError(f"kernel step launched {launches}")
    for what, errs in (("kernels vs plain", vs_plain), ("kernels vs float64", vs_f64)):
        check_step(f"{what} (LeNet-DWT)", errs, DIGITS_LEAF_TOL,
                   skip=DIGITS_NORMALIZED_BIASES)
    if vs_f64["grad"] > F64_RATIO_TOL * plain_vs_f64["grad"]:
        raise AssertionError(
            f"the kernel step's gradient is {vs_f64['grad']} from float64, "
            f"over {F64_RATIO_TOL} times the plain step's {plain_vs_f64['grad']}")
    if max(noise.values()) > DIGITS_NOISE_TOL:
        raise AssertionError(f"normalized biases' gradients are not noise: {noise}")


def digits_throughput(torch, loop, device):
    """Steady-state LeNet-DWT train step and eval forward; the card's idle
    share from a profiled window of steps."""
    from dwt_tpu_torch.config import DigitsConfig
    from dwt_tpu_torch.train.evalpipe import install_whiten_cache, make_whiten_cache
    from dwt_tpu_torch.train.optim import digits_tx
    from dwt_tpu_torch.train.state import TrainState
    from dwt_tpu_torch.train.steps import (
        eval_counters,
        make_accum_eval_step,
        make_digits_train_step,
    )

    cfg = DigitsConfig(seed=4, group_size=4)
    model = loop.build_digits_model(cfg).to(device, memory_format=torch.channels_last)
    optimizer, schedules = digits_tx(model, cfg, DIGITS_STEPS_PER_EPOCH)
    state = TrainState(model, optimizer, schedules)
    step = make_digits_train_step(model, cfg.lambda_entropy_loss)
    batch = digits_batch(torch, loop, 11, device)
    torch.cuda.reset_peak_memory_stats()
    step_ms = cuda_ms(torch, lambda: step(state, batch), iters=20, warmup=3)
    peak = torch.cuda.max_memory_allocated()
    window = 5
    traced = trace_events(torch, lambda: step(state, batch), iters=window,
                          cats=DEVICE_CATS + ("cpu_op", "cuda_runtime"))
    events = [ev for ev in traced if ev["cat"] in DEVICE_CATS]
    busy_ms = sum(ev["dur"] for ev in events) / 1e3 / window
    span_ms = (max(ev["ts"] + ev["dur"] for ev in events)
               - min(ev["ts"] for ev in events)) / 1e3 / window
    # Where the host's time goes: the outermost PyTorch operators by host
    # time (profiled, so stretched), and the runtime calls that wait.
    host, ends = {}, {}
    for ev in sorted((ev for ev in traced if ev["cat"] == "cpu_op"),
                     key=lambda ev: (ev.get("tid"), ev["ts"], -ev["dur"])):
        if ev["ts"] >= ends.get(ev.get("tid"), float("-inf")):
            ends[ev.get("tid")] = ev["ts"] + ev["dur"]
            host[ev["name"]] = host.get(ev["name"], 0.0) + ev["dur"] / 1e3 / window
    syncs = [ev["name"] for ev in traced if ev["cat"] == "cuda_runtime"
             and "ynchronize" in ev["name"]]
    by_kernel = {}
    for ev in events:
        name = ev["name"][:60]
        by_kernel[name] = by_kernel.get(name, 0.0) + ev["dur"] / 1e3 / window
    x = torch.cat([batch["target_x"]] * 4)[: cfg.test_batch_size]
    y = torch.cat([batch["source_y"]] * 4)[: cfg.test_batch_size]
    mask = torch.ones_like(y, dtype=torch.bool)
    install_whiten_cache(model, make_whiten_cache(model))
    accum = make_accum_eval_step(model)
    counters = eval_counters(device)
    eval_ms = cuda_ms(torch, lambda: accum(counters, x, y, mask), iters=20, warmup=2)
    install_whiten_cache(model, None)
    images = 2 * DIGITS_STREAM
    row = {"phase": "digits_throughput", "images_per_step": images,
           "step_ms": step_ms, "imgs_per_s": images / step_ms * 1e3,
           "device_ops_per_step": len(events) / window,
           "device_busy_ms_per_step": busy_ms,
           "idle_share": 1.0 - busy_ms / step_ms,
           "profiled_span_ms_per_step": span_ms,
           "idle_share_in_profile": 1.0 - busy_ms / span_ms,
           "host_top_ops_ms_per_step_profiled": dict(sorted(
               host.items(), key=lambda kv: -kv[1])[:12]),
           "device_top_ms_per_step": dict(sorted(
               by_kernel.items(), key=lambda kv: -kv[1])[:12]),
           "host_syncs_per_step": len(syncs) / window,
           "host_sync_calls": sorted(set(syncs)),
           "eval_forward_ms": eval_ms, "test_batch": cfg.test_batch_size,
           "max_memory_allocated": peak}
    emit(row)
    return row


def bound_by(rows):
    return ("bytes" if all(r["bound_by"] == "bytes" for r in rows)
            else "operations")


def digits_row(timing, path, part):
    """The kernels line's times of ``part`` (``"apply"`` or ``"moments"``)
    on a digits path: the sum over one train step's (or one bucket-128
    forward's) launches, one per site, each site's times from
    ``check_digits_kernels``."""
    rows = [timing[(path, site)][part] for site, _, _ in DIGITS_SITES]
    total = lambda key: sum(r[key] for r in rows)
    keys = ("plain_ms", "bound_ms", "library_ms", "library_device_ms")
    keys += APPLY_EXTRA if part == "apply" else MOMENTS_EXTRA
    return {"ms": total("device_ms"), "bound_by": bound_by(rows),
            **{k: total(k) for k in keys}}


def kernels_line(torch, r):
    """The contract line's rows: per kernel and path, its launches on that
    path's run, its largest error against its plain version, and its
    times per serve forward or train step, from the phases' results
    ``r``."""
    timing, m_timing, d_timing = r["timing"], r["m_timing"], r["d_timing"]
    d_apply_errs = r["d_apply_errs"]

    def per_forward(key):  # the 11 sites of one bucket-128 forward
        return sum(timing[s][key] * n for s, _, _, n in RESNET50_SITES)

    def per_step(part, key):  # one train step: 11 sites, one launch each
        return sum(m_timing[s][part][key] * n for s, _, _, n in TRAIN_SITES)

    train_per = {
        "moments": "the 11 whitened sites of one ResNet50 train step, one "
                   "launch per site for its 3 domains, 18 images per stream "
                   "at 224²",
        "apply": "the 11 whitened sites of one ResNet50 train step, one "
                 "launch per site for its 3 domains, 18 images per stream "
                 "at 224²",
    }
    # The apply rows also carry, summed over the same launches, the
    # wrapper's host time and a D2D copy of the same bytes, and the card's
    # per-launch floor (one empty launch).
    floor = {"launch_floor_ms": launch_floor_ms(torch)}
    train_rows = {
        part: {"ms": per_step(part, "device_ms"),
               "plain_ms": per_step(part, "plain_ms"),
               "bound_ms": per_step(part, "bound_ms"),
               "bound_by": bound_by([row[part] for row in m_timing.values()]),
               "library_ms": per_step(part, "library_ms"),
               "library_device_ms": per_step(part, "library_device_ms"),
               "path": "train", "per": train_per[part]}
        for part in ("moments", "apply")
    }
    train_rows["apply"].update(floor, **{k: per_step("apply", k) for k in APPLY_EXTRA})
    train_rows["moments"].update({k: per_step("moments", k) for k in MOMENTS_EXTRA})
    rows = [
        {
            "name": "whiten_apply",
            "route": "cuda",
            "source": "dwt_tpu_torch/csrc/whiten_apply.cu",
            "replaces": "dwt_tpu/ops/pallas_whitening.py:143",
            "launches": r["serve_launches"],
            "max_abs_err": max(p["max_abs_err"] for p in r["parity"]
                               if p["D"] is None),
            "ms": per_forward("device_ms"),
            "plain_ms": per_forward("plain_ms"),
            "bound_ms": per_forward("bound_ms"),
            "bound_by": bound_by(timing.values()),
            "library_ms": per_forward("library_ms"),
            "library_device_ms": per_forward("library_device_ms"),
            **{k: per_forward(k) for k in APPLY_EXTRA}, **floor,
            "path": "serve",
            "per": "the 11 whitened sites of one bucket-128 ResNet50 forward at 224²",
        },
        {
            "name": "whiten_apply",
            "route": "cuda",
            "source": "dwt_tpu_torch/csrc/whiten_apply.cu",
            "replaces": "dwt_tpu/ops/pallas_whitening.py:143",
            "launches": r["train_launches"]["apply"],
            "max_abs_err": max(
                [p["apply_vs_plain"]["max_abs_err"] for p in r["m_parity"]]
                + [p["max_abs_err"] for p in r["parity"] if p["D"] is not None]),
            **train_rows["apply"],
        },
        {
            "name": "whiten_moments",
            "route": "cuda",
            "source": "dwt_tpu_torch/csrc/whiten_moments.cu",
            "replaces": "dwt_tpu/ops/pallas_whitening.py:68",
            "launches": r["train_launches"]["moments"],
            "max_abs_err": max(max(p["vs_plain"].values()) for p in r["m_parity"]),
            **train_rows["moments"],
        },
        {
            "name": "whiten_apply",
            "route": "cuda",
            "source": "dwt_tpu_torch/csrc/whiten_apply.cu",
            "replaces": "dwt_tpu/ops/pallas_whitening.py:143",
            "launches": r["digits_train_launches"]["apply"],
            "max_abs_err": max(e for (path, _), e in d_apply_errs.items()
                               if path == "train"),
            **digits_row(d_timing, "train", "apply"), **floor,
            "path": "digits_train",
            "per": "the 2 whitened sites of one LeNet-DWT train step, one launch "
                   "per site for its 2 domains, 32 images per stream at 28²",
        },
        {
            "name": "whiten_moments",
            "route": "cuda",
            "source": "dwt_tpu_torch/csrc/whiten_moments.cu",
            "replaces": "dwt_tpu/ops/pallas_whitening.py:68",
            "launches": r["digits_train_launches"]["moments"],
            "max_abs_err": max(r["d_moments_errs"].values()),
            **digits_row(d_timing, "train", "moments"),
            "path": "digits_train",
            "per": "the 2 whitened sites of one LeNet-DWT train step, one launch "
                   "per site for its 2 domains, 32 images per stream at 28²",
        },
        {
            "name": "whiten_apply",
            "route": "cuda",
            "source": "dwt_tpu_torch/csrc/whiten_apply.cu",
            "replaces": "dwt_tpu/ops/pallas_whitening.py:143",
            "launches": r["digits_serve_launches"],
            "max_abs_err": max(e for (path, _), e in d_apply_errs.items()
                               if path.startswith("serve")),
            **digits_row(d_timing, "serve_b128", "apply"), **floor,
            "path": "digits_serve",
            "per": "the 2 whitened sites of one bucket-128 LeNet-DWT forward at 28²",
        },
    ]
    # The image-folder path runs the train path's shapes: its launches, the
    # train rows' times.
    folder = [{**row, "launches": r["folder_launches"][row["name"].split("_")[1]],
               "path": "officehome_folder_train",
               "per": row["per"] + ", the images decoded from JPEG folders"}
              for row in rows if row["path"] == "train"]
    return rows[:3] + folder + rows[3:]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "runs only on a CUDA GPU", file=sys.stderr)
        return 2
    from dwt_tpu_torch import native
    from dwt_tpu_torch.cli import officehome, usps_mnist
    from dwt_tpu_torch.ops import _build, cuda_whitening as cw
    from dwt_tpu_torch.serve import server
    from dwt_tpu_torch.train import loop

    tf32_defaults = {"cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
                     "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32}
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    import PIL

    smi = nvidia_smi()
    name = torch.cuda.get_device_name(0)
    rate = memory_rate(name)
    props = torch.cuda.get_device_properties(0)
    # Double data rate: clock (kHz) × 2 transfers × bus width in bytes.
    reported = (getattr(props, "memory_clock_rate", 0) * 1e3 * 2
                * getattr(props, "memory_bus_width", 0) / 8) or None
    emit({"phase": "env", "python": sys.version.split()[0],
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": name, "count": torch.cuda.device_count(),
          "nvidia_smi": smi, "memory_rate_Bps": rate,
          "memory_rate_from_clock_Bps": reported,
          "pil": PIL.__version__, "cpu_count": os.cpu_count(),
          "gxx": subprocess.run(["g++", "--version"], capture_output=True, text=True,
                                check=True, timeout=60).stdout.splitlines()[0],
          "tf32_defaults": tf32_defaults,
          "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
          "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32})

    t0 = time.perf_counter()
    logs = _build.build_all()
    seconds = time.perf_counter() - t0
    t0 = time.perf_counter()
    native.load()
    emit({"phase": "build", "seconds": seconds,
          "native_seconds": time.perf_counter() - t0,
          "native_library": os.path.relpath(native.library_path()),
          "built": sorted(logs),
          "ptxas": {k: [ln.strip() for ln in v.splitlines() if "Used" in ln]
                    for k, v in logs.items()}})

    device = torch.device("cuda", 0)
    r = {}
    r["parity"], r["timing"] = check_kernel(torch, cw, device, rate)
    r["m_parity"], r["m_timing"] = check_moments(torch, cw, device, rate)
    r["train_launches"], synthetic_timing = train(torch, cw, officehome, loop)
    train_reference(torch, cw, loop, device)
    train_throughput(torch, loop, device)
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build, exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="folders-", dir=build) as root:
        emit({"phase": "folders", "jpeg_bytes": write_folders(root)})
        data_plane(torch, officehome, loop, device, root)
        r["folder_launches"], folder_timing = train(
            torch, cw, officehome, loop, folder_flags(root), "folder_train")
        profiled = folder_profile(torch, officehome, loop, device, root,
                                  folder_timing["step_ms_median"])
    emit({"phase": "folder_vs_synthetic",
          "folder_step_ms_median": folder_timing["step_ms_median"],
          "synthetic_step_ms_median": synthetic_timing["step_ms_median"],
          "folder_batch_wait_ms_mean": folder_timing["batch_wait_ms_mean"],
          "synthetic_batch_wait_ms_mean": synthetic_timing["batch_wait_ms_mean"],
          "folder_idle_share": profiled["idle_share"]})
    r["serve_launches"] = serve(torch, cw, server)
    r["d_apply_errs"], r["d_moments_errs"], r["d_timing"] = check_digits_kernels(
        torch, cw, device, rate)
    r["digits_train_launches"] = digits_train(torch, cw, usps_mnist, loop)
    digits_reference(torch, cw, loop, device)
    digits_throughput(torch, loop, device)
    r["digits_serve_launches"] = serve(torch, cw, server, "lenet")
    emit({"kernels": kernels_line(torch, r)})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
