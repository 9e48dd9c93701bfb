"""Port parity: the gspmd mode of ``dwt_tpu_torch.parallel`` on gloo ranks.

Each case spawns ranks (``tests/torch_gspmd_worker.py``: processes that
import the port only, gloo over localhost, two torch threads each, every
collective under a 60 s timeout):

* the digits step (LeNet-DWT, Adam) at mesh ``1,2,2`` under ``model`` on
  4 ranks against JAX's gspmd step on ``make_plan_mesh((1, 2, 2))`` from
  the same initial state: the step-1 loss within ``rtol=1e-5``, the step-2
  metrics at ``rtol=1e-3``, each gathered parameter's change over the 2
  steps within a relative error norm of ``0.1`` of JAX's (a missing
  update scores 1) and the running stats at ``atol=1e-3``; every rank's
  records and gathered state bitwise rank 0's; the same under a rules
  file that shards parameters over ``data`` and ``(data, model)``;
* the ranks of one model group compute the same full gradient, bitwise,
  for every gathered weight and every whole parameter, before any mean
  (the reason no reduce-scatter over ``model`` is needed);
* every rank's local shapes are its rule's blocks (``devices_indices_map``
  under the layout map), Adam's moments included, and ``plan.gather_fns``
  gives each key's whole tensor back;
* the eval counters (``count`` and ``correct`` exact, ``loss`` to
  ``rtol=1e-5``) and a stat-collection pass with a ragged tail
  (``rtol=1e-5, atol=2e-5``, JAX's collect tolerance) against one process;
* the tiny ResNet-DWT OfficeHome step (two-group SGD, head padded to 6)
  at ``1,1,2`` under ``fsdp`` on 2 ranks against one process on the same
  global batch: step-1 metrics within ``rtol=1e-5``, the gathered
  parameters within ``rtol=1e-4, atol=1e-6`` and each momentum buffer (the
  first step's gradient, whose float reassociation differs between the two
  runs) within PR 18's SGD bound, a relative error norm of ``2e-3``;
* checkpoints cross plans both ways in both formats: the one-process
  full and delta checkpoints restore to spec under gspmd (each rank's
  tensors are its blocks, gathered bitwise the saved state), and the
  gspmd host-shard and delta saves restore bitwise under one process;
* the ranks' ``shard`` spans are the ones JAX's gspmd plan opens at the
  same sites (``shard_put``, ``gather``, ``restore_place``).
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dwt_tpu import parallel as jpar
from dwt_tpu.nn import LeNetDWT as JaxLeNetDWT
from dwt_tpu.train import steps as jsteps
from dwt_tpu.train.optim import adam_l2 as jax_adam_l2
from dwt_tpu.train.optim import multistep_schedule as jax_multistep
from dwt_tpu.train.optim import with_lr_backoff
from dwt_tpu.train.state import TrainState as JaxTrainState
from dwt_tpu_torch import parallel
from dwt_tpu_torch.config import DigitsConfig, OfficeHomeConfig
from dwt_tpu_torch.convert import load_jax_variables
from dwt_tpu_torch.data.datasets import ArrayDataset
from dwt_tpu_torch.nn.lenet import build_lenet
from dwt_tpu_torch.nn.resnet import ResNetDWT
from dwt_tpu_torch.train import steps
from dwt_tpu_torch.train.evalpipe import EvalPipeline
from dwt_tpu_torch.train.optim import digits_tx, officehome_tx
from dwt_tpu_torch.train.state import TrainState
from dwt_tpu_torch.utils import checkpoint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_gspmd_worker.py")
N_IMG = 8
LR = 1e-3
torch.set_num_threads(2)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(tmp, world: int, mesh: str, rules: str, cases):
    """Run ``cases`` on ``world`` worker ranks; their outputs, by rank."""
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if not k.startswith(("DWT_", "MASTER_"))}
    env.update(DWT_DIST_TIMEOUT_S="60", OMP_NUM_THREADS="2")
    procs = []
    for r in range(world):
        spec = tmp / f"spec_{r}.json"
        spec.write_text(json.dumps(dict(rank=r, world=world, port=port, mesh=mesh,
                                        rules=rules, dir=str(tmp), cases=cases)))
        procs.append(subprocess.Popen([sys.executable, WORKER, str(spec)], env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]
    return [dict(np.load(tmp / f"out_{r}.npz")) for r in range(world)]


def _randomize_stats(stats, rng):
    def leaf(path, a):
        name = getattr(path[-1], "name", str(path[-1]))
        if name == "cov":
            m = rng.normal(size=a.shape)
            return (m @ np.swapaxes(m, -1, -2) / 4 + 0.5 * np.eye(4)).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 2.0, size=a.shape).astype(np.float32)
        if name == "mean":
            return rng.normal(0.0, 0.2, size=a.shape).astype(np.float32)
        return np.full(a.shape, 3, a.dtype)

    return jax.tree_util.tree_map_with_path(leaf, stats)


def _lenet(params, stats):
    port = build_lenet(group_size=4)
    load_jax_variables(port, jax.tree.map(np.asarray, params),
                       jax.tree.map(np.asarray, stats))
    return port


def _check_blocks(out, state_dict, layout_of_rank, prefix):
    """Every local shape of the rank is its rule's block (moments too)."""
    for name, full in state_dict.items():
        leaf = layout_of_rank.leaves[name]
        want = layout_of_rank.block_shape(leaf)
        assert tuple(out[f"{prefix}shape_{name}"]) == want, name
        key = f"{prefix}optshape_{name}_exp_avg"
        if key in out:
            assert tuple(out[key]) == want, key


def _port_layout(model, mesh, coords, rules):
    """The layout a rank at ``coords`` places ``model`` with (computed
    here from the rules, describe-only)."""
    plan = parallel.ShardingPlan.gspmd(mesh, rules)
    mesh.coords = tuple(int(c) for c in coords)
    return plan._layout(TrainState(model, digits_tx(model, DigitsConfig(), 3)[0], ()))


# A rules file that shards over the batch axes too: the conv kernels' out
# channels over ``(data, model)``, ``fc3``'s input rows over ``data``.
DATA_RULES = [["(\\.|\\[')(batch_stats|whiten_cache)", []],
              ["conv\\w*'\\]\\['kernel'\\]", [None, None, None, ["data", "model"]]],
              ["fc3'\\]\\['kernel'\\]", ["data", None]],
              [".*", []]]


@pytest.fixture(scope="module")
def digits_inputs():
    """The digits initial state (JAX), its optimizer and two batches."""
    model = JaxLeNetDWT(group_size=4)
    tx = with_lr_backoff(jax_adam_l2(jax_multistep(LR, (50, 80), 0.1, scale=3), 5e-4))
    variables = jax.jit(lambda k: model.init(
        k, jnp.zeros((2, N_IMG, 28, 28, 1)), train=True))(jax.random.key(0))
    rng = np.random.default_rng(0)
    params = jax.tree.map(
        lambda a: (a + rng.normal(0, 0.1, a.shape) if a.ndim == 1 else a).astype(a.dtype),
        jax.tree.map(np.asarray, variables["params"]))
    stats = _randomize_stats(jax.tree.map(np.asarray, variables["batch_stats"]), rng)
    params = jax.tree.map(jnp.asarray, params)
    state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                          batch_stats=jax.tree.map(jnp.asarray, stats),
                          opt_state=tx.init(params))
    rng = np.random.default_rng(1)
    batches = [{"source_x": rng.normal(size=(N_IMG, 28, 28, 1)).astype(np.float32),
                "source_y": rng.integers(0, 10, size=N_IMG),
                "target_x": rng.normal(0.5, size=(N_IMG, 28, 28, 1)).astype(np.float32)}
               for _ in range(2)]
    return dict(model=model, tx=tx, state=state, batches=batches)


def _jax_digits(inputs, rules):
    """JAX's gspmd digits steps at ``1,2,2`` under ``rules``: the metrics
    of each step and the gathered state after the last."""
    plan = jpar.ShardingPlan.gspmd(jpar.make_plan_mesh((1, 2, 2), jax.devices()[:4]),
                                   rules, name="t")
    step = plan.make_train_step(jsteps.make_digits_train_step(
        inputs["model"], inputs["tx"], 0.1, axis_name=None))
    st = plan.place(inputs["state"], "train state")
    metrics = []
    for b in inputs["batches"]:
        st, m = step(st, plan.shard_batch(jax.tree.map(jnp.asarray, b)))
        metrics.append(jax.tree.map(float, m))
    return metrics, plan.gather(st)


def _write_digits(tmp, inputs):
    state = inputs["state"]
    torch.save(_lenet(state.params, state.batch_stats).state_dict(), tmp / "init.pt")
    for i, b in enumerate(inputs["batches"]):
        np.savez(tmp / f"batch_{i}.npz", **b)


@pytest.fixture(scope="module")
def digits_run(tmp_path_factory, digits_inputs):
    """JAX's gspmd digits state and steps, and the port's 4 ranks on the
    same inputs (train, eval and collect, checkpoints)."""
    tmp = tmp_path_factory.mktemp("gspmd_digits")
    state = digits_inputs["state"]
    jax_metrics, jax_final = _jax_digits(digits_inputs, jpar.PRESETS["model"])
    _write_digits(tmp, digits_inputs)
    rng = np.random.default_rng(5)
    np.savez(tmp / "eval.npz", x=rng.normal(size=(28, 28, 28, 1)).astype(np.float32),
             y=rng.integers(0, 10, size=28))
    np.savez(tmp / "collect.npz", x=rng.normal(0.3, size=(28, 28, 28, 1)).astype(np.float32),
             y=rng.integers(0, 10, size=28))
    # One process: a step from init, saved in both formats.
    single = TrainState(_lenet(state.params, state.batch_stats).to(
        memory_format=torch.channels_last), None, ())
    single.optimizer, single.schedules = digits_tx(single.model, DigitsConfig(), 3)
    one = steps.make_digits_train_step(single.model, 0.1)
    one(single, {k: torch.from_numpy(v) for k, v in digits_inputs["batches"][0].items()})
    checkpoint.save_state(str(tmp / "ckpt_full"), single.step, single)
    from dwt_tpu_torch.ckpt.store import save_delta

    save_delta(str(tmp / "ckpt_delta"), single.step, single)
    outs = _spawn(tmp, 4, "1,2,2", "model", [
        dict(name="digits_train", kind="digits", steps=2),
        dict(name="eval"), dict(name="ckpt")])
    return dict(tmp=tmp, jax_state=state, jax_metrics=jax_metrics, jax_final=jax_final,
                outs=outs, single=single)


def _check_digits_against_jax(outs, jax_metrics, jax_final, jax_init):
    """Step 1's metrics within ``rtol=1e-5``, step 2's at ``rtol=1e-3``;
    each parameter's change over the 2 steps against JAX's as a relative
    error norm, ``|Δgot − Δwant| / |Δwant| ≤ 0.1`` (an update left out
    scores 1, one of the wrong sign 2).  Elementwise bounds do not fit
    Adam: its first update moves every element by ``±lr`` whatever its
    gradient's size, so float reassociation flips the elements whose
    gradient is near zero; the second update divides by the gradients'
    running RMS, so where two steps' gradients nearly cancel, it moves an
    element by up to one ``lr`` (one of ``conv2.bias``'s 48 scores 0.077
    alone).  The running stats at ``atol=1e-3``; every rank bitwise rank
    0."""
    for key in ("loss", "cls_loss", "entropy_loss", "grad_norm"):
        np.testing.assert_allclose(float(outs[0][f"m0_{key}"]), jax_metrics[0][key],
                                   rtol=1e-5, err_msg=key)
        np.testing.assert_allclose(float(outs[0][f"m1_{key}"]), jax_metrics[1][key],
                                   rtol=1e-3, atol=1e-5, err_msg=key)
    init = _lenet(jax_init.params, jax_init.batch_stats).state_dict()
    ref = _lenet(jax_final.params, jax_final.batch_stats).state_dict()
    params = {n for n, _ in build_lenet(group_size=4).named_parameters()}
    for name, want in ref.items():
        got = outs[0][f"model_{name}"]
        if name in params:
            start = init[name].numpy()
            assert not np.array_equal(want.numpy(), start), name
            change = want.numpy().astype(np.float64) - start
            err = np.linalg.norm(got - start - change) / np.linalg.norm(change)
            assert err <= 0.1, (name, err)
        else:
            np.testing.assert_allclose(got, want.numpy(), rtol=0, atol=1e-3, err_msg=name)
    for out in outs[1:]:
        for k, v in outs[0].items():
            if k.startswith(("m0_", "m1_", "model_", "opt_", "eval_", "collect_")):
                assert np.array_equal(out[k], v), k


def test_digits_model_step_matches_jax_gspmd(digits_run):
    _check_digits_against_jax(digits_run["outs"], digits_run["jax_metrics"],
                              digits_run["jax_final"], digits_run["jax_state"])


def test_digits_batch_axis_rules_step_matches_jax_gspmd(tmp_path, digits_inputs):
    """A rules file that shards parameters over ``data`` (alone and with
    ``model``): the ranks of one data line hold different blocks, so each
    such gradient is averaged over the data group before its block is
    kept.  Against JAX's gspmd step under the same file."""
    path = tmp_path / "data_rules.json"
    path.write_text(json.dumps(DATA_RULES))
    jax_metrics, jax_final = _jax_digits(digits_inputs, jpar.load_rules_file(str(path)))
    _write_digits(tmp_path, digits_inputs)
    outs = _spawn(tmp_path, 4, "1,2,2", str(path),
                  [dict(name="digits_train", kind="digits", steps=2)])
    _check_digits_against_jax(outs, jax_metrics, jax_final, digits_inputs["state"])
    # Blocks: conv1's 32 out channels in 4 chunks, chunk data·2 + model;
    # fc3's 2352 inputs (torch dim 1) in 2, by data position.
    for out in outs:
        assert tuple(out["shape_conv1.weight"]) == (8, 1, 5, 5)
        assert tuple(out["shape_fc3.weight"]) == (100, 1176)
        assert tuple(out["optshape_fc3.weight_exp_avg"]) == (100, 1176)
        assert tuple(out["shape_fc5.weight"]) == (10, 100)


def test_model_group_ranks_compute_the_same_full_gradient(digits_run):
    """Ranks (0, 1) and (2, 3) share a data position: their full
    gradients (each gathered weight's and each whole parameter's, before
    any mean) are bitwise equal; the two data positions' differ."""
    outs = digits_run["outs"]
    assert [tuple(o["coords"]) for o in outs] == [(0, 0, 0), (0, 0, 1), (0, 1, 0), (0, 1, 1)]
    assert [int(o["batch_position"]) for o in outs] == [0, 0, 1, 1]
    keys = [k for k in outs[0] if k.startswith("fullgrad_")]
    assert "fullgrad_conv1.weight" in keys and "fullgrad_fc5.weight" in keys
    for a, b in ((0, 1), (2, 3)):
        for k in keys:
            assert np.array_equal(outs[a][k], outs[b][k]), (a, b, k)
    assert not np.array_equal(outs[0]["fullgrad_conv1.weight"], outs[2]["fullgrad_conv1.weight"])


def test_every_rank_holds_its_rules_blocks(digits_run):
    outs = digits_run["outs"]
    init = build_lenet(group_size=4)
    rules = parallel.PRESETS["model"]
    for out in outs:
        mesh = parallel.make_plan_mesh((1, 2, 2), world=4)
        layout = _port_layout(init, mesh, out["coords"], rules)
        assert tuple(layout.leaves["conv1.weight"].spec) == (("model",), None, None, None)
        assert layout.block_shape(layout.leaves["conv1.weight"]) == (16, 1, 5, 5)
        assert layout.block_shape(layout.leaves["fc3.weight"]) == (50, 2352)
        assert not layout.leaves["fc5.weight"].sharded
        _check_blocks(out, init.state_dict(), layout, "init_")
        _check_blocks(out, init.state_dict(), layout, "")
        assert tuple(out["optshape_conv1.weight_exp_avg"]) == (16, 1, 5, 5)
        # plan.gather_fns: each key's callable gives its whole tensor.
        assert set(out["gather_fns_equal"].tolist()) == set(init.state_dict())


def test_eval_counters_and_collection_match_one_process(digits_run):
    outs, tmp = digits_run["outs"], digits_run["tmp"]
    model = build_lenet(group_size=4)
    model.load_state_dict(torch.load(tmp / "init.pt", weights_only=True))
    state = TrainState(model.to(memory_format=torch.channels_last), None, ())
    pipe = EvalPipeline(8, torch.device("cpu"), num_domains=2, eval_k=2)
    arrays = np.load(tmp / "eval.npz")
    result = pipe.evaluate(state, ArrayDataset(arrays["x"], arrays["y"]))
    assert int(outs[0]["eval_count"]) == result["count"] == 28
    assert float(outs[0]["eval_accuracy"]) == result["accuracy"]
    np.testing.assert_allclose(float(outs[0]["eval_loss"]), result["loss"], rtol=1e-5)
    arrays = np.load(tmp / "collect.npz")
    pipe.collect_stats(state, ArrayDataset(arrays["x"], arrays["y"]), epoch=0)
    for name, want in model.state_dict().items():
        key = f"collect_{name}"
        if key in outs[0]:
            np.testing.assert_allclose(outs[0][key], want.numpy(), rtol=1e-5, atol=2e-5,
                                       err_msg=name)
    assert "collect_dn1.cov" in outs[0]


def test_checkpoints_cross_plans_both_ways_both_formats(digits_run):
    outs, tmp, single = digits_run["outs"], digits_run["tmp"], digits_run["single"]
    want = single.state_dict()
    names = [n for n, _ in single.model.named_parameters()]
    init = build_lenet(group_size=4)
    for fmt in ("full", "delta"):
        for r, out in enumerate(outs):
            # Restored to spec: this rank holds blocks only ...
            mesh = parallel.make_plan_mesh((1, 2, 2), world=4)
            layout = _port_layout(init, mesh, out["coords"], parallel.PRESETS["model"])
            _check_blocks(out, init.state_dict(), layout, f"{fmt}_")
            # ... and together they are the saved state, bitwise.
            for name, t in want["model"].items():
                assert np.array_equal(out[f"{fmt}_model_{name}"], t.numpy()), (fmt, name)
            for i, buffers in want["optimizer"]["state"].items():
                for key, v in buffers.items():
                    if torch.is_tensor(v):
                        assert np.array_equal(out[f"{fmt}_opt_{names[int(i)]}_{key}"],
                                              v.numpy()), (fmt, key)
    manifest = json.load(open(tmp / "out_hs" / "1" / "manifest.json"))
    assert manifest["format"] == "host_shards" and manifest["process_count"] == 4
    for saved in ("out_hs", "out_dl"):
        back = TrainState(build_lenet(group_size=4).to(memory_format=torch.channels_last),
                          None, ())
        back.optimizer, back.schedules = digits_tx(back.model, DigitsConfig(), 3)
        checkpoint.restore_state(str(tmp / saved), back)
        got = back.state_dict()
        assert got["step"] == want["step"] == 1
        for name, t in want["model"].items():
            assert torch.equal(got["model"][name], t), (saved, name)
        for i, buffers in want["optimizer"]["state"].items():
            for key, v in buffers.items():
                assert torch.equal(got["optimizer"]["state"][i][key], v), (saved, key)


def test_shard_spans_match_jax(digits_run, tmp_path):
    """The ``shard`` spans the port's ranks opened are those JAX's gspmd
    plan opens at the same sites: the placement, the gather before a save
    and the restore to spec."""
    from dwt_tpu import obs as jax_obs
    from dwt_tpu.utils.checkpoint import (
        host_fetch,
        promote_host_shards,
        restore_state,
        save_host_shard,
    )

    state = digits_run["jax_state"]
    plan = jpar.ShardingPlan.gspmd(jpar.make_plan_mesh((1, 2, 2), jax.devices()[:4]),
                                   jpar.PRESETS["model"], name="model")
    jax_obs.disable()
    jax_obs.configure()
    try:
        placed = plan.place(state, "train state")
        host = host_fetch(placed, gather=plan.gather)
        save_host_shard(str(tmp_path), 1, host, process_index=0)
        promote_host_shards(str(tmp_path), 1, process_count=1)
        restore_state(str(tmp_path), state, shardings=plan.restore_shardings(state))
        want = {s["name"] for s in jax_obs.snapshot() if s["cat"] == "shard"}
    finally:
        jax_obs.disable()
    assert want == {"shard_put", "gather", "restore_place"}
    for out in digits_run["outs"]:
        assert set(out["shard_spans"].tolist()) == want


def test_officehome_fsdp_step_matches_one_process(tmp_path):
    """Two ranks at ``1,1,2`` under ``fsdp`` (every kernel sharded, the
    padded head too) against one process on the same global batch."""
    classes = 5
    torch.manual_seed(0)
    model = ResNetDWT.tiny(num_classes=classes, pad_classes_to=2)
    torch.save(model.state_dict(), tmp_path / "init.pt")
    rng = np.random.default_rng(2)
    img = lambda: rng.normal(size=(4, 32, 32, 3)).astype(np.float32)
    batch = {"source_x": img(), "source_y": rng.integers(0, classes, size=4),
             "target_x": img(), "target_aug_x": img()}
    np.savez(tmp_path / "batch_0.npz", **batch)
    outs = _spawn(tmp_path, 2, "1,1,2", "fsdp", [
        dict(name="officehome_train", kind="officehome", steps=1, classes=classes)])

    model = model.to(memory_format=torch.channels_last)
    optimizer, schedules = officehome_tx(model, OfficeHomeConfig())
    state = TrainState(model, optimizer, schedules)
    metrics = steps.make_officehome_train_step(model, 0.1)(
        state, {k: torch.from_numpy(v) for k, v in batch.items()})
    for key in ("loss", "cls_loss", "mec_loss", "grad_norm"):
        np.testing.assert_allclose(float(outs[0][f"m0_{key}"]), float(metrics[key]),
                                   rtol=1e-5, err_msg=key)
    for name, want in model.state_dict().items():
        np.testing.assert_allclose(outs[0][f"model_{name}"], want.numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=name)
    names = {id(p): n for n, p in model.named_parameters()}
    for p, buffers in optimizer.state.items():
        got = outs[0][f"opt_{names[id(p)]}_momentum_buffer"].astype(np.float64)
        want = buffers["momentum_buffer"].double().numpy()
        err = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert err <= 2e-3, (names[id(p)], err)
    assert np.array_equal(outs[0]["model_fc_out.weight"], outs[1]["model_fc_out.weight"])
    # fsdp shards the padded head (6 rows) and every conv kernel: half each.
    for r, out in enumerate(outs):
        assert tuple(out["shape_fc_out.weight"]) == (3, 2048)
        assert tuple(out["shape_conv1.weight"]) == (32, 3, 7, 7)
        assert tuple(out["shape_dn1.gamma"]) == (64,)
        assert tuple(out["optshape_fc_out.weight_momentum_buffer"]) == (3, 2048)
    for k in [k for k in outs[0] if k.startswith("fullgrad_")]:
        assert np.array_equal(outs[0][k], outs[1][k]), k
