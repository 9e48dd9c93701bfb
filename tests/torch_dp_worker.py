"""One rank of the port's data-parallel tests: ``python tests/torch_dp_worker.py SPEC``.

Imports the port only (never jax).  ``SPEC`` is a JSON file: ``rank``,
``world``, ``port`` (the gloo rendezvous on localhost), ``dcn`` (slices of
a 2-D mesh, 0 for 1-D), ``dir`` (inputs the test wrote; outputs land
there as ``out_<rank>.npz``) and ``cases``, run in order:

* ``digits_train`` / ``officehome_train``: ``steps`` replica train steps
  from ``init.pt`` on this rank's slice of ``batch_<i>.npz``, then the
  same steps again through ``make_scanned_step`` at ``k = steps`` from
  the same start — the metrics and the state after each step, and the
  scanned run's state;
* ``eval``: the accumulating eval step on this rank's slice of
  ``eval.npz`` — the counters;
* ``collect``: ``passes`` stat-collection passes of the eval pipeline
  over ``collect.npz`` — the stats after them;
* ``whiten_grad``: the group-aware plain op and ``cuda_group_whiten``
  (the kernel seam; on the CPU its plain kernels) on this rank's rows of
  ``whiten.npz`` — outputs, new stats and input gradients.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from dwt_tpu_torch import parallel  # noqa: E402
from dwt_tpu_torch.config import DigitsConfig, OfficeHomeConfig  # noqa: E402
from dwt_tpu_torch.data.datasets import ArrayDataset  # noqa: E402
from dwt_tpu_torch.nn.lenet import build_lenet  # noqa: E402
from dwt_tpu_torch.nn.norms import set_group  # noqa: E402
from dwt_tpu_torch.nn.resnet import ResNetDWT  # noqa: E402
from dwt_tpu_torch.ops import cuda_whitening, whitening  # noqa: E402
from dwt_tpu_torch.train import steps  # noqa: E402
from dwt_tpu_torch.train.evalpipe import EvalPipeline  # noqa: E402
from dwt_tpu_torch.train.optim import digits_tx, officehome_tx  # noqa: E402
from dwt_tpu_torch.train.state import TrainState  # noqa: E402


def _model(kind: str, mesh, init: str, classes: int):
    if kind == "digits":
        model = build_lenet(group_size=4)
    else:
        model = ResNetDWT.tiny(num_classes=classes)
    model.load_state_dict(torch.load(init, weights_only=True))
    return set_group(model.to(memory_format=torch.channels_last), mesh)


def _state(kind: str, model, spe: int):
    if kind == "digits":
        optimizer, schedules = digits_tx(model, DigitsConfig(), spe)
    else:
        optimizer, schedules = officehome_tx(model, OfficeHomeConfig())
    return TrainState(model, optimizer, schedules)


def _train(case, mesh, d, out):
    kind = case["kind"]
    batches = [dict(np.load(os.path.join(d, f"batch_{i}.npz"))) for i in range(case["steps"])]
    local = [{k: torch.from_numpy(np.ascontiguousarray(v))
              for k, v in parallel.shard_batch(b, mesh).items()} for b in batches]
    init = os.path.join(d, "init.pt")
    make = (steps.make_digits_train_step if kind == "digits"
            else steps.make_officehome_train_step)
    model = _model(kind, mesh, init, case.get("classes", 10))
    state = _state(kind, model, case.get("spe", 3))
    parallel.replicate_state(state, mesh)
    step = parallel.make_sharded_train_step(make(model, 0.1, group=mesh), mesh)
    for i, b in enumerate(local):
        metrics = step(state, b)
        for k, v in metrics.items():
            out[f"{kind}_m{i}_{k}"] = v.detach().double().numpy()
        for name, v in model.state_dict().items():
            out[f"{kind}_state{i}_{name}"] = v.detach().clone().numpy()

    model2 = _model(kind, mesh, init, case.get("classes", 10))
    state2 = _state(kind, model2, case.get("spe", 3))
    scanned = parallel.make_sharded_scanned_step(make(model2, 0.1, group=mesh), mesh,
                                                 len(local))
    chunk = {k: torch.stack([b[k] for b in local]) for k in local[0]}
    scanned(state2, chunk)
    for name, v in model2.state_dict().items():
        out[f"{kind}_scanned_{name}"] = v.detach().numpy()


def _eval(case, mesh, d, out):
    model = _model("digits", mesh, os.path.join(d, "init.pt"), 10)
    chunk = dict(np.load(os.path.join(d, "eval.npz")))
    local = {k: torch.from_numpy(np.ascontiguousarray(v))
             for k, v in parallel.shard_batch(chunk, mesh, chunked=True).items()}
    fn = parallel.make_sharded_eval_step(
        steps.make_accum_eval_step(model, k=chunk["x"].shape[0], group=mesh), mesh)
    counters = fn(steps.eval_counters(torch.device("cpu")), local)
    for k, v in counters.items():
        out[f"eval_{k}"] = v.numpy()


def _collect(case, mesh, d, out):
    model = _model("digits", mesh, os.path.join(d, "init.pt"), 10)
    arrays = np.load(os.path.join(d, "collect.npz"))
    plan = parallel.ShardingPlan.replica(mesh)
    pipe = EvalPipeline(case["batch"], torch.device("cpu"), num_domains=2,
                        eval_k=case["k"], plan=plan)
    state = TrainState(model, None, ())
    for p in range(case["passes"]):
        pipe.collect_stats(state, ArrayDataset(arrays["x"], arrays["y"]), epoch=p)
    for name, v in model.state_dict().items():
        out[f"collect_{name}"] = v.detach().numpy()


def _whiten_grad(case, mesh, d, out):
    data = np.load(os.path.join(d, "whiten.npz"))
    gsize = int(case["group_size"])
    x = parallel.shard_batch(data["x"], mesh, chunked=True)  # [D, M/N, C]
    gy = parallel.shard_batch(data["gy"], mesh, chunked=True)
    for dtype in ("f64", "f32"):
        tdt = torch.float64 if dtype == "f64" else torch.float32
        xt = torch.from_numpy(np.ascontiguousarray(x)).to(tdt).requires_grad_(True)
        stats = whitening.init_whitening_stats(xt.shape[-1], gsize, dtype=tdt)
        ys = []
        for i in range(xt.shape[0]):
            y, new = whitening.group_whiten(xt[i], stats, group_size=gsize, train=True,
                                            group=mesh)
            ys.append(y)
            out[f"plain_{dtype}_mean{i}"] = new.mean.detach().numpy()
            out[f"plain_{dtype}_cov{i}"] = new.cov.detach().numpy()
        y = torch.stack(ys)
        (dx,) = torch.autograd.grad(y, xt, torch.from_numpy(np.ascontiguousarray(gy)).to(tdt))
        out[f"plain_{dtype}_y"] = y.detach().numpy()
        out[f"plain_{dtype}_dx"] = dx.numpy()
    xt = torch.from_numpy(np.ascontiguousarray(x)).float().requires_grad_(True)
    d_, c = xt.shape[0], xt.shape[-1]
    stats = whitening.init_whitening_stats(c, gsize)
    stacked = type(stats)(*(s.repeat((d_,) + (1,) * s.dim()) for s in stats))
    y, new = cuda_whitening.cuda_group_whiten(xt, stacked, group_size=gsize, train=True,
                                              group=mesh)
    (dx,) = torch.autograd.grad(y, xt, torch.from_numpy(np.ascontiguousarray(gy)).float())
    out["kernel_y"] = y.detach().numpy()
    out["kernel_dx"] = dx.numpy()
    out["kernel_mean"] = new.mean.numpy()
    out["kernel_cov"] = new.cov.numpy()


CASES = {"digits_train": _train, "officehome_train": _train, "eval": _eval,
         "collect": _collect, "whiten_grad": _whiten_grad}


def main(path: str) -> None:
    with open(path) as f:
        spec = json.load(f)
    torch.set_num_threads(2)
    parallel.initialize_distributed(f"127.0.0.1:{spec['port']}", spec["world"],
                                    spec["rank"], device="cpu")
    mesh = parallel.make_mesh(dcn_slices=spec.get("dcn") or None)
    out = {"mesh_index": np.asarray(mesh.index)}
    for case in spec["cases"]:
        CASES[case["name"]](case, mesh, spec["dir"], out)
    np.savez(os.path.join(spec["dir"], f"out_{spec['rank']}.npz"), **out)
    parallel.shutdown_distributed()


if __name__ == "__main__":
    main(sys.argv[1])
