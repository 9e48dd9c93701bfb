"""One rank of the port's gspmd tests: ``python tests/torch_gspmd_worker.py SPEC``.

Imports the port only (never jax).  ``SPEC`` is a JSON file: ``rank``,
``world``, ``port`` (the gloo rendezvous on localhost), ``mesh`` (the
``--mesh_shape``), ``rules`` (the ``--sharding_rules``), ``dir`` (inputs
the test wrote; outputs land there as ``out_<rank>.npz``) and ``cases``,
run in order under one ``plan_from_flags`` plan, with span tracing on:

* ``digits_train`` / ``officehome_train``: the plan's step from
  ``init.pt`` on this rank's slice of ``batch_<i>.npz`` (``steps``
  steps): the metrics after each step, the gathered state after the last
  (``plan.gather``), the state-dict keys whose ``plan.gather_fns``
  callable gives that gathered tensor, every state tensor's local shape,
  and, before any
  step, a probe forward and backward that keeps each gathered weight's
  full gradient and every whole parameter's gradient, before any mean;
* ``eval``: an eval pass of the plan's eval pipeline over ``eval.npz``
  (the counters) and one stat-collection pass over ``collect.npz`` (the
  running stats after it);
* ``ckpt``: the digits state restored to spec from the single-process
  checkpoints ``ckpt_full`` and ``ckpt_delta`` (the gathered state and
  the local shapes after each), then saved gathered in the host-shard
  format (``out_hs``) and the delta format (``out_dl``).

The tracer's ``shard``-category span names land in ``shard_spans``.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from dwt_tpu_torch import obs, parallel  # noqa: E402
from dwt_tpu_torch.config import DigitsConfig, OfficeHomeConfig  # noqa: E402
from dwt_tpu_torch.data.datasets import ArrayDataset  # noqa: E402
from dwt_tpu_torch.nn.lenet import build_lenet  # noqa: E402
from dwt_tpu_torch.nn.norms import set_group  # noqa: E402
from dwt_tpu_torch.nn.resnet import ResNetDWT  # noqa: E402
from dwt_tpu_torch.ops.losses import entropy_loss, softmax_cross_entropy  # noqa: E402
from dwt_tpu_torch.parallel import gspmd  # noqa: E402
from dwt_tpu_torch.train import steps  # noqa: E402
from dwt_tpu_torch.train.evalpipe import EvalPipeline  # noqa: E402
from dwt_tpu_torch.train.optim import digits_tx, officehome_tx  # noqa: E402
from dwt_tpu_torch.train.state import TrainState  # noqa: E402
from dwt_tpu_torch.utils import checkpoint  # noqa: E402


def _state(kind: str, plan, d: str, classes: int = 10):
    if kind == "digits":
        model = build_lenet(group_size=4)
    else:
        model = ResNetDWT.tiny(num_classes=classes, pad_classes_to=2)
    model.load_state_dict(torch.load(os.path.join(d, "init.pt"), weights_only=True))
    set_group(model.to(memory_format=torch.channels_last), plan.group)
    if kind == "digits":
        optimizer, schedules = digits_tx(model, DigitsConfig(), 3)
    else:
        optimizer, schedules = officehome_tx(model, OfficeHomeConfig())
    state = TrainState(model, optimizer, schedules)
    plan.place(state)
    return state


def _shapes(state, out, prefix):
    for name, t in state.model.state_dict().items():
        out[f"{prefix}shape_{name}"] = np.asarray(t.shape)
    names = {id(p): n for n, p in state.model.named_parameters()}
    for p, buffers in state.optimizer.state.items():
        for key, v in buffers.items():
            if torch.is_tensor(v) and v.dim():
                out[f"{prefix}optshape_{names[id(p)]}_{key}"] = np.asarray(v.shape)


def _gathered(plan, state, out, prefix):
    payload = plan.gather(state).payload
    for name, t in payload["model"].items():
        out[f"{prefix}model_{name}"] = t.numpy()
    names = [n for g in state.optimizer.param_groups for p in g["params"]
             for n, q in state.model.named_parameters() if q is p]
    for i, buffers in payload["optimizer"]["state"].items():
        for key, v in buffers.items():
            if torch.is_tensor(v):
                out[f"{prefix}opt_{names[int(i)]}_{key}"] = v.numpy()


def _probe_grads(kind, state, batch, out):
    """One forward and backward of the step's loss (no mean, no update):
    each gathered weight's full gradient and each whole parameter's."""
    model = state.model
    saved = {k: v.clone() for k, v in model.state_dict().items()}
    layout = gspmd.layout_of(model)
    full, hooks = {}, []
    for leaf in layout.sharded():
        head, _, attr = leaf.name.rpartition(".")

        def keep(module, args, attr=attr, name=leaf.name):
            t = module.__dict__[attr]
            t.retain_grad()
            full[name] = t
        hooks.append(model.get_submodule(head).register_forward_pre_hook(keep))
    model.train()
    if kind == "digits":
        logits = model(torch.stack([batch["source_x"], batch["target_x"]]))
        loss = softmax_cross_entropy(logits[0], batch["source_y"]) + \
            0.1 * entropy_loss(logits[1])
    else:
        logits = model(torch.stack([batch["source_x"], batch["target_x"],
                                    batch["target_aug_x"]]))
        loss = softmax_cross_entropy(logits[0], batch["source_y"])
    loss.backward()
    for name, t in full.items():
        out[f"fullgrad_{name}"] = t.grad.numpy()
    for name, p in model.named_parameters():
        if not layout.leaves[name].sharded:
            out[f"fullgrad_{name}"] = p.grad.numpy()
    for h in hooks:
        h.remove()
    state.optimizer.zero_grad(set_to_none=True)
    model.load_state_dict(saved)


def _train(case, plan, d, out):
    kind = case["kind"]
    state = _state(kind, plan, d, case.get("classes", 10))
    _shapes(state, out, "init_")
    batches = [dict(np.load(os.path.join(d, f"batch_{i}.npz"))) for i in range(case["steps"])]
    local = [{k: torch.from_numpy(np.ascontiguousarray(v))
              for k, v in plan.shard_batch(b).items()} for b in batches]
    _probe_grads(kind, state, local[0], out)
    make = (steps.make_digits_train_step if kind == "digits"
            else steps.make_officehome_train_step)
    step = plan.make_train_step(make(state.model, 0.1, group=plan.group))
    for i, b in enumerate(local):
        metrics = step(state, b)
        for k, v in metrics.items():
            out[f"m{i}_{k}"] = v.detach().double().numpy()
    _shapes(state, out, "")
    _gathered(plan, state, out, "")
    fns, local = plan.gather_fns(state), state.model.state_dict()
    out["gather_fns_equal"] = np.asarray(sorted(
        k for k, t in local.items()
        if np.array_equal(fns[k](t).detach().numpy(), out[f"model_{k}"])))


def _eval(case, plan, d, out):
    state = _state("digits", plan, d)
    pipe = EvalPipeline(8, torch.device("cpu"), num_domains=2, eval_k=2, plan=plan)
    arrays = np.load(os.path.join(d, "eval.npz"))
    result = pipe.evaluate(state, ArrayDataset(arrays["x"], arrays["y"]))
    for k in ("loss", "accuracy", "count"):
        out[f"eval_{k}"] = np.asarray(result[k])
    arrays = np.load(os.path.join(d, "collect.npz"))
    pipe.collect_stats(state, ArrayDataset(arrays["x"], arrays["y"]), epoch=0)
    for name, v in state.model.state_dict().items():
        if not gspmd.layout_of(state.model).leaves[name].sharded:
            out[f"collect_{name}"] = v.detach().numpy()


def _ckpt(case, plan, d, out):
    for fmt in ("full", "delta"):
        state = _state("digits", plan, d)
        checkpoint.restore_state(os.path.join(d, f"ckpt_{fmt}"), state,
                                 shardings=plan.restore_shardings(state))
        _shapes(state, out, f"{fmt}_")
        _gathered(plan, state, out, f"{fmt}_")
    host = plan.gather(state)
    checkpoint.save_host_shard(os.path.join(d, "out_hs"), state.step, host,
                               process_index=parallel.process_index())
    torch.distributed.barrier()
    if parallel.process_index() == 0:
        checkpoint.promote_host_shards(os.path.join(d, "out_hs"), state.step,
                                       parallel.process_count())
        from dwt_tpu_torch.ckpt.store import save_delta

        save_delta(os.path.join(d, "out_dl"), state.step, host)
    torch.distributed.barrier()


CASES = {"digits_train": _train, "officehome_train": _train, "eval": _eval, "ckpt": _ckpt}


def main(path: str) -> None:
    with open(path) as f:
        spec = json.load(f)
    torch.set_num_threads(2)
    obs.configure()
    parallel.initialize_distributed(f"127.0.0.1:{spec['port']}", spec["world"],
                                    spec["rank"], device="cpu")
    plan = parallel.plan_from_flags(mesh_shape=spec["mesh"], sharding_rules=spec["rules"],
                                    distributed=True, local_devices=0)
    out = {"coords": np.asarray(plan.mesh.coords),
           "batch_position": np.asarray(plan.mesh.batch_position)}
    for case in spec["cases"]:
        CASES[case["name"]](case, plan, spec["dir"], out)
    out["shard_spans"] = np.asarray(sorted({s["name"] for s in obs.snapshot()
                                            if s["cat"] == "shard"}))
    np.savez(os.path.join(spec["dir"], f"out_{spec['rank']}.npz"), **out)
    parallel.shutdown_distributed()


if __name__ == "__main__":
    main(sys.argv[1])
