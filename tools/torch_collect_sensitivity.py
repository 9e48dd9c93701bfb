#!/usr/bin/env python3
"""How far the serving adapter's collect forward through the CUDA kernels
moves from the same collect through their plain versions, per seed, on a
CUDA GPU: the readings behind ``chip_smoke.py``'s ``COLLECT_SITE_TOL`` and
``COLLECT_TOL``.

Run from the root of a checkout on a machine with the card::

    python3 tools/torch_collect_sensitivity.py [--seeds 2,12,22,32,42]
        [--batches 3] [--out chiprun_out/collect_sensitivity.json]

``--model tiny --size 32 --device cpu`` rehearses it on the CPU (where
both collects take the plain versions and every reading is 0).

Per seed: a ResNet50-DWT server engine with weights from ``--seed``
(``--init_random``), its collect forward (``serve.adapt.make_collect_fn``:
``--adapt_batch`` images tiled into the 3 domains, train mode, no
gradients) over ``--batches`` batches of images from ``seed + 1`` shifted
by ``chip_smoke.ADAPT_DRIFT``, chained from the engine's stats as the
adapter chains a window.  Each batch is collected twice from the same
input stats, through the kernels and with both kernels swapped for their
plain versions, and compared by ``chip_smoke.collect_errors``: per stat
tensor, max |kernel − plain| over max |plain − input|, the error relative
to the batch's own update.  Prints one JSON line per seed (per batch, its
worst tensor among the whitened sites' mean and cov and among the other
stats, ``chip_smoke.worst_collect_errors``), then the worst of each over
all seeds and the card
(``nvidia-smi`` name and power limit); the per-tensor readings go to
``--out``.  Fails without CUDA unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seeds", default="2,12,22,32,42")
    p.add_argument("--batches", type=int, default=3, help="collect batches per seed")
    p.add_argument("--adapt_batch", type=int, default=32)
    p.add_argument("--model", default="resnet50", choices=("resnet50", "tiny"))
    p.add_argument("--size", type=int, default=224)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default="chiprun_out/collect_sensitivity.json")
    args = p.parse_args(argv)

    import numpy as np
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("torch_collect_sensitivity: needs a CUDA GPU (or --device cpu)",
              file=sys.stderr)
        return 2
    import chip_smoke as cs
    from dwt_tpu_torch.nn.norms import whitening_sites
    from dwt_tpu_torch.ops import _build, cuda_whitening as cw
    from dwt_tpu_torch.serve import server
    from dwt_tpu_torch.serve.adapt import make_collect_fn

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.device == "cuda":
        _build.build_all()
    tables, worst = [], {"whitened": 0.0, "other": 0.0}
    for seed in [int(s) for s in args.seeds.split(",")]:
        engine = server.build_engine(server.build_parser().parse_args([
            "--model", args.model, "--num_classes", "65", "--image_size", str(args.size),
            "--init_random", "--seed", str(seed), "--buckets", "1",
            "--device", args.device]))
        state, collect = engine.state, make_collect_fn(engine)
        sites = set(whitening_sites(state.model))
        plain = make_collect_fn(engine)
        rng = np.random.default_rng(seed + 1)
        drift = cs.ADAPT_DRIFT
        stats, per_batch = state.batch_stats, []
        for _ in range(args.batches):
            x = (rng.normal(size=(args.adapt_batch,) + engine.input_shape)
                 * drift["scale"] + drift["offset"]).astype(np.float32)
            got = collect(state, stats, x)
            kernels = (cw.whiten_moments, cw.whiten_apply)
            cw.whiten_moments, cw.whiten_apply = cw.whiten_moments_plain, cw.whiten_apply_plain
            try:
                ref = plain(state, stats, x)
            finally:
                cw.whiten_moments, cw.whiten_apply = kernels
            errs = cs.collect_errors(stats, got, ref)
            per_batch.append(errs)
            stats = got
        tops = [cs.worst_collect_errors(e, sites) for e in per_batch]
        worst = {part: max([v] + [t[part]["err"] for t in tops]) for part, v in worst.items()}
        print(json.dumps({"seed": seed, "worst_per_batch": tops}), flush=True)
        tables.append({"seed": seed, "per_batch": per_batch})
        del engine, collect, plain, state, stats
        if args.device == "cuda":
            torch.cuda.empty_cache()
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(tables, f)
    print(json.dumps({"worst": worst, "seeds": args.seeds, "batches": args.batches}))
    if args.device == "cuda":
        print(cs.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
