#!/usr/bin/env python3
"""On-GPU smoke of the PyTorch/CUDA port (``dwt_tpu_torch``): build, check, serve.

Run from the root of a checkout, on a machine with one CUDA GPU::

    python3 chip_smoke.py

Phases, each printed as one JSON line; any failure raises and the
script exits non-zero without the final line:

1. ``env``     — torch/CUDA versions, the card's name and power limit
                 (``nvidia-smi``), both TF32 flags.
2. ``build``   — ``nvcc`` builds every ``dwt_tpu_torch/csrc/*.cu`` (in
                 parallel) into ``build/kernels/``.
3. ``parity``  — the whitening-apply kernel against its plain PyTorch
                 version, both on the card, at the three site shapes of a
                 bucket-128 ResNet50 forward at 224² and at a ragged
                 M = 1000; ``rtol = atol = 1e-5``.
4. ``timing``  — per shape: kernel, plain version and one-call library
                 yardstick (``torch.addmm`` with the block-diagonal
                 matrix) in CUDA-event milliseconds, beside the bound
                 (bytes moved over the card's memory rate).
5. ``serve``   — the port's server on 127.0.0.1 (``build_engine`` from
                 the CLI flags ``--model resnet50 --num_classes 65
                 --image_size 224 --buckets 1,8,32,128 --init_random
                 --seed 0``) answers requests of 1, 5, 32 and 128 images;
                 every response is checked (shape, finite, equal to
                 ``engine.infer``), the kernel must have launched 11
                 times per forward, a bucket-8 forward through the kernel
                 is held to the same forward through the plain apply and
                 a bucket-1 forward to the model on the CPU; then forward
                 time per bucket and peak device memory.
6. ``kernels`` — the contract line: per kernel its TPU counterpart,
                 launches on the serving run, error and times.

The last two lines are the card's ``nvidia-smi`` name/power limit and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import copy
import json
import subprocess
import sys
import time

RESNET50_SITES = (  # (site, M at bucket 128 and 224², C, sites per forward)
    ("stem_dn1", 128 * 112 * 112, 64, 1),
    ("stage1_c64", 128 * 56 * 56, 64, 6),
    ("stage1_c256", 128 * 56 * 56, 256, 4),
)
RAGGED_M = 1000
TOL = 1e-5            # kernel vs plain, per element: rtol = atol = 1e-5
FORWARD_TOL = 1e-4    # whole forwards: max |a − b| / max |b|
FP32_PEAK = 67e12     # H100 SXM f32 outside the tensor cores (data sheet)


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


def cuda_ms(torch, fn, iters: int = 50, warmup: int = 5) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def norm_err(a, b) -> float:
    """``max |a − b| / max |b|`` (logits of fresh-init stats are large)."""
    return float((a.double() - b.double()).abs().max() / b.double().abs().max())


def site_inputs(torch, m, c, gen, cpu_gen, device):
    from dwt_tpu_torch.ops.whitening import _shrink, whitening_matrix

    x = torch.randn(m, c, generator=gen, device=device) * 2.0 + 1.0
    mean = torch.randn(c, generator=gen, device=device) * 0.5
    a = torch.randn(c // 4, 4, 4, dtype=torch.float64, generator=cpu_gen)
    cov = a @ a.transpose(-1, -2) / 4 + 0.5 * torch.eye(4, dtype=torch.float64)
    w = whitening_matrix(_shrink(cov.float(), 1e-3)).to(device).contiguous()
    return x, mean, w


def check_kernel(torch, cw, device, rate):
    """Parity at every shape, timing at the bucket-128 shapes."""
    gen = torch.Generator(device=device).manual_seed(0)
    cpu_gen = torch.Generator().manual_seed(0)
    shapes = [(name, m, c) for name, m, c, _ in RESNET50_SITES]
    shapes += [("ragged_c64", RAGGED_M, 64), ("ragged_c256", RAGGED_M, 256)]
    parity, timing = [], {}
    for name, m, c in shapes:
        x, mean, w = site_inputs(torch, m, c, gen, cpu_gen, device)
        y = cw.whiten_apply(x, mean, w)
        ref = cw.whiten_apply_plain(x, mean, w)
        torch.cuda.synchronize()
        diff = (y - ref).abs()
        ok = bool((diff <= TOL + TOL * ref.abs()).all())
        row = {"shape": name, "M": m, "C": c,
               "max_abs_err": float(diff.max()),
               "max_rel_err": float((diff / ref.abs().clamp_min(1e-30)).max()),
               "rtol": TOL, "atol": TOL, "ok": ok}
        parity.append(row)
        emit({"phase": "parity", **row})
        if not ok:
            raise AssertionError(f"kernel disagrees with plain at {name}: {row}")
        if m == RAGGED_M:
            continue
        w_bd = torch.block_diag(*w)                  # [C, C]
        w_t = w_bd.t().contiguous()
        bias = -(mean @ w_t)
        lib_y = torch.addmm(bias, x, w_t)
        torch.cuda.synchronize()
        lib_err = float((lib_y - ref).abs().max())
        nbytes = 2 * m * c * 4
        flops = m * c * 9  # per 4 channels: 4 subtracts + 16 FMAs
        bytes_ms, ops_ms = nbytes / rate * 1e3, flops / FP32_PEAK * 1e3
        row = {
            "shape": name, "M": m, "C": c, "bytes": nbytes,
            "kernel_ms": cuda_ms(torch, lambda: cw.whiten_apply(x, mean, w)),
            "plain_ms": cuda_ms(torch, lambda: cw.whiten_apply_plain(x, mean, w),
                                iters=10),
            "library_ms": cuda_ms(torch, lambda: torch.addmm(bias, x, w_t)),
            "copy_ms": cuda_ms(torch, lambda: y.copy_(x)),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_max_abs_err": lib_err,
        }
        row["kernel_GBps"] = nbytes / row["kernel_ms"] / 1e6
        row["bound_share"] = row["bound_ms"] / row["kernel_ms"]
        timing[name] = row
        emit({"phase": "timing", **row})
        del x, y, ref, lib_y, diff
        torch.cuda.empty_cache()
    return parity, timing


def serve(torch, cw, server):
    """The main path: the port's HTTP server on ResNet50-DWT at 224²."""
    import numpy as np

    args = server.build_parser().parse_args([
        "--model", "resnet50", "--num_classes", "65", "--image_size", "224",
        "--buckets", "1,8,32,128", "--init_random", "--seed", "0",
        "--host", "127.0.0.1", "--port", "0",
    ])
    t0 = time.perf_counter()
    engine = server.build_engine(args)
    build_s = time.perf_counter() - t0
    emit({"phase": "engine", "build_s": build_s, "warmup_s": engine.warmup_s,
          "device": str(engine.device),
          "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
          "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32})
    if torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("the engine must run f32 convs/matmuls without TF32")

    rng = np.random.default_rng(0)
    sizes = (1, 5, 32, 128)
    inputs = [rng.normal(size=(n, 224, 224, 3)).astype(np.float32) for n in sizes]
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
    emit({"phase": "serve", "requests": list(sizes), "e2e_ms": e2e_ms,
          "batches_by_bucket": batches, "apply_launches": launches,
          "stats": stats})
    if batches != {1: 1, 8: 1, 32: 1, 128: 1}:
        raise AssertionError(f"expected one batch per bucket, got {batches}")
    if launches != 11 * forwards:
        raise AssertionError(
            f"{launches} kernel launches for {forwards} forwards, not 11 each")

    worst = 0.0
    for x, out in zip(inputs, responses):
        if out.shape != (x.shape[0], 65) or not np.isfinite(out).all():
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
    emit({"phase": "reference", "http_vs_infer": worst,
          "kernel_vs_plain_bucket8": kernel_vs_plain,
          "gpu_vs_cpu_bucket1": gpu_vs_cpu, "tolerance": FORWARD_TOL,
          "logits_max_abs": float(np.abs(responses[-1]).max())})
    if kernel_vs_plain > FORWARD_TOL or gpu_vs_cpu > FORWARD_TOL:
        raise AssertionError("forward disagrees with its reference")

    per_bucket = {}
    for b in engine.buckets:
        xb = engine.stage(np.zeros((b, 224, 224, 3), np.float32))
        ms = cuda_ms(torch, lambda: engine.forward(xb, b), iters=10, warmup=2)
        per_bucket[b] = {"forward_ms": ms, "imgs_per_s": b / ms * 1e3}
    emit({"phase": "throughput", "per_bucket": per_bucket,
          "max_memory_allocated": torch.cuda.max_memory_allocated()})
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "runs only on a CUDA GPU", file=sys.stderr)
        return 2
    from dwt_tpu_torch.ops import _build, cuda_whitening as cw
    from dwt_tpu_torch.serve import server

    tf32_defaults = {"cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
                     "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32}
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
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
          "tf32_defaults": tf32_defaults,
          "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
          "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32})

    t0 = time.perf_counter()
    logs = _build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "built": sorted(logs),
          "ptxas": {k: [ln.strip() for ln in v.splitlines() if "Used" in ln]
                    for k, v in logs.items()}})

    device = torch.device("cuda", 0)
    parity, timing = check_kernel(torch, cw, device, rate)
    launches = serve(torch, cw, server)

    def per_forward(key):  # the 11 sites of one bucket-128 forward
        return sum(timing[s][key] * n for s, _, _, n in RESNET50_SITES)

    emit({"kernels": [{
        "name": "whiten_apply",
        "route": "cuda",
        "source": "dwt_tpu_torch/csrc/whiten_apply.cu",
        "replaces": "dwt_tpu/ops/pallas_whitening.py:143",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in parity),
        "ms": per_forward("kernel_ms"),
        "plain_ms": per_forward("plain_ms"),
        "bound_ms": per_forward("bound_ms"),
        "bound_by": ("bytes" if all(r["bound_by"] == "bytes"
                                    for r in timing.values()) else "operations"),
        "library_ms": per_forward("library_ms"),
        "per": "the 11 whitened sites of one bucket-128 ResNet50 forward at 224²",
    }]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
