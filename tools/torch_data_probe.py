#!/usr/bin/env python3
"""The OfficeHome image-folder train step against the loader's thread count.

Writes ``chip_smoke.py``'s two OfficeHome-shaped JPEG folders (65 classes
× 3 images per domain from seed 1, unless cut down by the flags) under
``build/``, then times ResNet50-DWT MEC train steps fed by the port's data
plane (``officehome_plane`` → ``officehome_batches`` →
``prefetch_to_device``), one setting after another in one process:

* ``preloaded`` — the same batches decoded beforehand, so no loader
  thread runs during the steps (the step without data work beside it);
* ``workers=N`` for each ``--workers`` value — the loop's own path, N
  loader threads per stream (0: items load one by one on the prefetch
  thread).

With ``--switch_ms``, every ``workers`` setting runs again at each of
those interpreter switch intervals (``sys.setswitchinterval``; the
default is 5 ms): a thread that waits for the GIL gets it after at most
that long, so a step that shortens with the interval waits on the GIL.

Each step reads its loss back, as the trainer does at ``--log_interval
1``.  Per setting: the median step (batch to batch, after ``--warmup``
steps), the mean wait for a batch, and the step's host CPU time spent on
the calling thread (``time.thread_time``).  One JSON line per setting,
each with the card's name and power limit.

    python3 tools/torch_data_probe.py                       # on the card
    python3 tools/torch_data_probe.py --device cpu --arch tiny --size 32 \\
        --resize 36 --batch 2 --classes 4 --workers 0,2 --steps 3
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workers", default="0,1,2,4,8")
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--warmup", type=int, default=2)
    p.add_argument("--arch", default="resnet50")
    p.add_argument("--size", type=int, default=224)
    p.add_argument("--resize", type=int, default=256)
    p.add_argument("--batch", type=int, default=18)
    p.add_argument("--classes", type=int, default=chip_smoke.FOLDER_CLASSES)
    p.add_argument("--switch_ms", default="",
                   help="comma-separated switch intervals to run each "
                        "workers setting at as well")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    import torch

    from dwt_tpu_torch.cli import officehome
    from dwt_tpu_torch.serve.engine import resolve_device
    from dwt_tpu_torch.train import loop
    from dwt_tpu_torch.train.optim import officehome_tx
    from dwt_tpu_torch.train.state import TrainState
    from dwt_tpu_torch.train.steps import make_officehome_train_step

    device = resolve_device(args.device)
    card = chip_smoke.nvidia_smi() if device.type == "cuda" else "cpu"
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    chip_smoke.FOLDER_CLASSES = args.classes
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    total = args.warmup + args.steps
    build = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "build")
    os.makedirs(build, exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="folders-", dir=build) as root:
        jpeg_bytes = chip_smoke.write_folders(root)
        flags = chip_smoke.folder_flags(root) + [
            "--arch", args.arch, "--num_classes", str(args.classes),
            "--img_crop_size", str(args.size), "--img_resize", str(args.resize),
            "--source_batch_size", str(args.batch), "--device", args.device]
        cfg = officehome.config_from_args(officehome.build_parser().parse_args(flags))
        source_ds, target_ds, _ = loop._officehome_datasets(cfg)
        model = loop.build_model(cfg).to(device, memory_format=torch.channels_last)
        optimizer, schedules = officehome_tx(model, cfg)
        state = TrainState(model, optimizer, schedules)
        step = make_officehome_train_step(model, cfg.lambda_mec_loss)

        def run(setting, produce, switch_ms=None):
            default = sys.getswitchinterval()
            if switch_ms is not None:
                sys.setswitchinterval(switch_ms / 1e3)
            try:
                row = timed(produce)
            finally:
                sys.setswitchinterval(default)
            row.update(setting=setting, switch_ms=sys.getswitchinterval() * 1e3
                       if switch_ms is None else switch_ms)
            print(json.dumps(row), flush=True)

        def timed(produce):
            stamps, cpu = [], []
            batches = loop.prefetch_to_device(produce, device=device)
            try:
                for _ in range(total):
                    asked = time.perf_counter()
                    batch = next(batches)
                    got = time.perf_counter()
                    c0 = time.thread_time()
                    float(step(state, batch)["loss"])
                    cpu.append((time.thread_time() - c0) * 1e3)
                    stamps.append((asked, got))
            finally:
                batches.close()
                produce.close()
            sync()
            got = [g for _, g in stamps[args.warmup:]]
            periods = [(b - a) * 1e3 for a, b in zip(got, got[1:])]
            return {"tool": "torch_data_probe",
                   "step_ms_median": statistics.median(periods),
                   "step_ms_all": periods,
                   "batch_wait_ms_mean": statistics.fmean(
                       (g - a) * 1e3 for a, g in stamps[args.warmup:]),
                   "main_thread_cpu_ms_median": statistics.median(cpu[args.warmup:]),
                   "images_per_step": 3 * args.batch, "cpu_count": os.cpu_count(),
                   "jpeg_bytes": jpeg_bytes, "device": card}

        def plane(workers):
            cfg.num_workers = workers
            return loop.officehome_plane(cfg, source_ds, target_ds)

        preloaded = list(loop.officehome_batches(plane(8), source_ds, target_ds,
                                                 cfg.source_batch_size, total))
        run("preloaded", (b for b in preloaded))
        switches = [None] + [float(v) for v in args.switch_ms.split(",") if v]
        for workers in (int(w) for w in args.workers.split(",")):
            for switch_ms in switches:
                run(f"workers={workers}", loop.officehome_batches(
                    plane(workers), source_ds, target_ds, cfg.source_batch_size,
                    total), switch_ms)
    return 0


if __name__ == "__main__":
    sys.exit(main())
