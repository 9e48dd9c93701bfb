#!/usr/bin/env python3
"""How far two uninterrupted runs of the port's main train path drift
apart on a CUDA GPU, under cuDNN's default and deterministic algorithms.

Runs ``chip_smoke.py``'s ``ckpt_resume`` configuration (ResNet50-DWT
OfficeHome on synthetic data, 3 streams × 18 images of 224², 6 steps,
evals every 3, one collection pass, a checkpoint every 3 steps under
``build/``) four times through the trainer's loop: D1 and D2 under
cuDNN's default algorithms, then A1 and A2 under its deterministic ones.
Prints one JSON line with the card (name and power limit from
``nvidia-smi``) and, for the pairs D1–D2, A1–A2 and A1–D1, the relative
errors ``chip_smoke`` holds a resumed run to: train losses from step 4 on
and the last eval loss (``|a − b| / |b|``), each parameter and running
stat tensor (``max |a − b| / max |b|``), and whether the steps and BN
counts agree.  ``chip_smoke.py`` holds its resumed runs bitwise under the
deterministic algorithms; this measures why it does not run the default
ones.

    python3 tools/torch_resume_spread.py                    # on the card
    python3 tools/torch_resume_spread.py --device cpu --arch tiny --size 32 \\
        --batch 2 --classes 4                                # rehearsal
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--arch", default="resnet50")
    p.add_argument("--size", type=int, default=224)
    p.add_argument("--batch", type=int, default=18)
    p.add_argument("--classes", type=int, default=65)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    import torch

    from dwt_tpu_torch.cli import officehome
    from dwt_tpu_torch.serve.engine import resolve_device
    from dwt_tpu_torch.train import loop

    device = resolve_device(args.device)
    card = chip_smoke.nvidia_smi() if device.type == "cuda" else "cpu"
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    build = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "build")
    os.makedirs(build, exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="resume-spread-", dir=build) as root:
        def cfg(name):
            return officehome.config_from_args(officehome.build_parser().parse_args(
                chip_smoke.CKPT_FLAGS + [
                    "--ckpt_dir", os.path.join(root, name), "--arch", args.arch,
                    "--img_crop_size", str(args.size), "--source_batch_size",
                    str(args.batch), "--num_classes", str(args.classes),
                    "--device", args.device]))

        records = {}
        for name, deterministic in (("D1", False), ("D2", False),
                                    ("A1", True), ("A2", True)):
            before = torch.backends.cudnn.deterministic
            torch.backends.cudnn.deterministic = deterministic
            try:
                runs = records[name] = []
                loop.run_officehome(
                    cfg(name), lambda kind, step, **f: runs.append(
                        {"kind": kind, "step": step, **f}))
            finally:
                torch.backends.cudnn.deterministic = before
        c = cfg("A1")
        model = loop.build_model(c)
        steps = range(chip_smoke.CKPT_CUT, c.num_iters + 1)
        pairs = {}
        for a, b in (("D1", "D2"), ("A1", "A2"), ("A1", "D1")):
            pairs[f"{a}_vs_{b}"] = {
                **chip_smoke.record_errs(records[a], records[b], steps),
                **chip_smoke.state_errs(torch, model, os.path.join(root, a),
                                        os.path.join(root, b))}
    print(json.dumps({"tool": "torch_resume_spread", "card": card,
                      "device": str(device), "arch": args.arch, "size": args.size,
                      "batch": args.batch, "pairs": pairs}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
