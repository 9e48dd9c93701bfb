"""Per-rank state bytes of the port's sharding plans: replicated against ``model`` and ``fsdp``.

The port of ``tools/shard_bench.py``'s fsdp arm.  For one backbone of the
registry (``--backbone resnet50|resnet152``, 65 classes, the head padded
to the model axis, as ``--pad_classes_to``), with the OfficeHome
optimizer (two-group SGD: one momentum buffer a parameter):

* **analytic** — each rank's parameter-plus-momentum bytes under the
  ``dp``, ``model`` and ``fsdp`` rules at mesh ``(1, 1, M)``: every
  leaf's bytes over the product of the axes its spec shards, from the
  port's key paths and rules (the backbone built on the ``meta`` device);
* **measured** — ``M`` gloo ranks (``--device cpu|cuda``; on one card the
  ranks share it), each placing the backbone under ``fsdp`` and taking one
  train step (``--size`` ², ``--images`` a stream), so the momentum
  exists: the bytes of the parameters and momentum each rank holds, its
  blocks against its rules, and, on the card, the rank's
  ``torch.cuda.memory_allocated`` after the step.

Prints one JSON object (``kind: torch_shard_bench``)::

    python3 tools/torch_shard_bench.py --backbone resnet152 --device cuda
    python3 tools/torch_shard_bench.py --backbone resnet50 --device cpu \\
        --size 32 --images 2

``--rank`` is the internal per-process entry.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import socket
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

RULES = ("dp", "model", "fsdp")


def _state(backbone: str, model_axis: int, device: str):
    from dwt_tpu_torch.config import OfficeHomeConfig
    from dwt_tpu_torch.nn.registry import build_backbone
    from dwt_tpu_torch.train.optim import officehome_tx
    from dwt_tpu_torch.train.state import TrainState

    with torch.device(device):
        model = build_backbone(backbone, num_classes=65, pad_classes_to=model_axis)
    if device != "meta":
        model = model.to(memory_format=torch.channels_last)
    optimizer, schedules = officehome_tx(model, OfficeHomeConfig())
    return TrainState(model, optimizer, schedules)


def analytic(backbone: str, model_axis: int) -> dict:
    """Each rank's parameter-plus-momentum bytes under every rule table."""
    from dwt_tpu_torch import parallel
    from dwt_tpu_torch.parallel.paths import state_leaves

    state = _state(backbone, model_axis, "meta")
    mesh = parallel.make_plan_mesh((1, 1, model_axis), world=model_axis)
    sizes = dict(mesh.shape)
    leaves = [leaf for leaf in state_leaves(state.model, state.optimizer)
              if leaf.keystr.startswith(".params") or leaf.opt_key == "momentum_buffer"]
    out = {}
    for rules in RULES:
        specs = parallel.match_partition_rules(parallel.PRESETS[rules], state, mesh=mesh,
                                               what=f"{backbone} {rules}")
        total = 0
        for leaf in leaves:
            shards = math.prod(sizes[a] for part in specs[leaf.keystr] if part is not None
                               for a in ((part,) if isinstance(part, str) else part))
            total += math.prod(leaf.shape) * 4 // shards
        out[f"{rules}_param_momentum_bytes"] = total
    out["fsdp_share_of_dp"] = out["fsdp_param_momentum_bytes"] / out["dp_param_momentum_bytes"]
    out["model_share_of_dp"] = out["model_param_momentum_bytes"] / out["dp_param_momentum_bytes"]
    return out


def _rank(args) -> None:
    """One measured rank: place under fsdp, one train step, the bytes."""
    from dwt_tpu_torch import parallel
    from dwt_tpu_torch.nn.norms import set_group
    from dwt_tpu_torch.parallel import gspmd
    from dwt_tpu_torch.train.steps import make_officehome_train_step

    torch.set_num_threads(2)
    info = parallel.initialize_distributed(f"127.0.0.1:{args.port}", args.model_axis,
                                           args.rank, device=args.device)
    device = torch.device(info.device)
    plan = parallel.plan_from_flags(mesh_shape=f"1,1,{args.model_axis}",
                                    sharding_rules="fsdp", distributed=True,
                                    local_devices=0 if args.device == "cpu" else None)
    torch.manual_seed(0)
    state = _state(args.backbone, args.model_axis, str(device))
    set_group(state.model, plan.group)
    plan.place(state)
    gen = torch.Generator().manual_seed(1)
    img = lambda: torch.randn((args.images, args.size, args.size, 3), generator=gen).to(device)
    batch = {"source_x": img(), "target_x": img(), "target_aug_x": img(),
             "source_y": torch.randint(0, 65, (args.images,), generator=gen).to(device)}
    step = plan.make_train_step(make_officehome_train_step(state.model, 0.1, group=plan.group))
    t0 = time.perf_counter()
    loss = float(step(state, batch)["loss"])
    seconds = time.perf_counter() - t0
    layout = gspmd.layout_of(state.model)
    params = dict(state.model.named_parameters())
    moments = [(n, buf["momentum_buffer"]) for n, p in params.items()
               for buf in [state.optimizer.state.get(p, {})] if "momentum_buffer" in buf]
    block = lambda n: tuple(layout.block_shape(layout.leaves[n]))
    out = {"rank": args.rank, "coords": list(layout.mesh.coords), "loss": loss,
           "step_s": seconds,
           "param_bytes": sum(p.numel() * p.element_size() for p in params.values()),
           "momentum_bytes": sum(v.numel() * v.element_size() for _, v in moments),
           "moments": len(moments), "params": len(params),
           "blocks_ok": all(tuple(p.shape) == block(n) for n, p in params.items())
                        and all(tuple(v.shape) == block(n) for n, v in moments)}
    if device.type == "cuda":
        torch.cuda.synchronize()
        out["memory_allocated"] = torch.cuda.memory_allocated()
        out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    with open(args.out, "w") as f:
        json.dump(out, f)
    parallel.shutdown_distributed()


def measured(args) -> list:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {k: v for k, v in os.environ.items() if not k.startswith(("DWT_", "MASTER_"))}
    env.setdefault("OMP_NUM_THREADS", "2")
    with tempfile.TemporaryDirectory() as tmp:
        procs = []
        for rank in range(args.model_axis):
            out = os.path.join(tmp, f"rank_{rank}.json")
            procs.append((out, subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--rank", str(rank),
                 "--port", str(port), "--out", out, "--backbone", args.backbone,
                 "--model_axis", str(args.model_axis), "--device", args.device,
                 "--size", str(args.size), "--images", str(args.images)],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        results = []
        try:
            for out, p in procs:
                log = p.communicate(timeout=args.timeout)[0]
                if p.returncode != 0:
                    raise RuntimeError(f"rank failed (rc {p.returncode}): {log[-3000:]}")
                with open(out) as f:
                    results.append(json.load(f))
        finally:
            for _, p in procs:
                if p.poll() is None:
                    p.kill()
    return results


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--backbone", default="resnet152", choices=["resnet50", "resnet152"])
    p.add_argument("--model_axis", type=int, default=2)
    p.add_argument("--device", default="cuda", choices=["cpu", "cuda"])
    p.add_argument("--size", type=int, default=224, help="image side of the measured step")
    p.add_argument("--images", type=int, default=18, help="images a stream of the step")
    p.add_argument("--timeout", type=float, default=900.0)
    p.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--out", default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.rank is not None:
        _rank(args)
        return 0
    if args.device == "cuda" and not torch.cuda.is_available():
        print("torch_shard_bench: --device cuda needs a CUDA GPU", file=sys.stderr)
        return 2
    report = {"kind": "torch_shard_bench", "backbone": args.backbone,
              "mesh_shape": [1, 1, args.model_axis], "device": args.device,
              "optimizer": "two-group SGD, one momentum buffer a parameter",
              "analytic": analytic(args.backbone, args.model_axis)}
    ranks = measured(args)
    dp = report["analytic"]["dp_param_momentum_bytes"]
    for r in ranks:
        r["share_of_replicated"] = (r["param_bytes"] + r["momentum_bytes"]) / dp
    report["measured"] = ranks
    report["measured_equals_analytic"] = all(
        r["param_bytes"] + r["momentum_bytes"]
        == report["analytic"]["fsdp_param_momentum_bytes"] for r in ranks)
    if args.device == "cuda":
        report["card"] = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                 "--format=csv,noheader"], capture_output=True,
                                text=True).stdout.strip()
    print(json.dumps(report))
    return 0 if report["measured_equals_analytic"] and all(
        r["blocks_ok"] for r in ranks) else 1


if __name__ == "__main__":
    sys.exit(main())
