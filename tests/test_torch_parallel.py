"""Port parity: the replica-mode data-parallel steps of ``dwt_tpu_torch.parallel``
against the JAX package's ``shard_map`` steps on the fake CPU mesh.

Each case spawns N ranks (``tests/torch_dp_worker.py``: processes that
import the port only, gloo over localhost, two torch threads each, every
collective under a 60 s timeout) and runs the JAX side here, from the same
numpy state and batches:

* the digits step (Adam) at N = 2 and 4 and over the 2-D ``(2, 2)``
  ``(dcn, data)`` mesh, and a tiny OfficeHome step (SGD, two lr groups)
  at N = 2, against ``dwt_tpu.parallel.make_sharded_train_step`` over
  ``jax.devices()[:N]``: step-1 metrics ``rtol=1e-4`` and running stats
  ``rtol=1e-4, atol=1e-4`` (the single-device parity tests' limits);
  SGD's parameter updates within 2e-3 of JAX's (relative, the normalized
  biases excepted); Adam's parameters within JAX's own DP parity bound
  ``2·steps·lr`` and its step-2 metrics and stats at that test's
  ``rtol=1e-3`` and ``atol=1e-3``; every rank's outputs bitwise equal;
* the k-step scanned step against the same k single steps (bitwise);
* the eval counters against JAX's accumulating eval step (``correct`` and
  ``count`` exact, ``loss_sum`` ``rtol=1e-5``): the unsharded one, whose
  counters JAX's contract makes the sharded step's — its
  ``make_sharded_eval_step`` does not trace on the installed jax (its
  own ``test_sharded_eval_exact_counter_parity[8]`` fails there);
* two stat-collection passes with a ragged tail against the unsharded
  JAX collection, at JAX's ``test_sharded_collect_parity_2d_mesh_multi_pass``
  tolerance (``rtol=1e-5, atol=2e-5``);
* the group-aware plain whitening op and the kernel seam
  (``cuda_group_whiten`` through ``TrainWhiten``; plain kernels on the CPU)
  against JAX's ``group_whiten`` on the concatenated batch: outputs,
  stats and the input gradient, in float64 (``jax.enable_x64``) to 1e-10
  and in float32 to 1e-4;
* ``plan_from_flags`` on a table of flag combinations, the gspmd mode's
  included, against JAX's decision or error text.
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

from dwt_tpu.config import OfficeHomeConfig as JaxOfficeHomeConfig
from dwt_tpu.nn import LeNetDWT as JaxLeNetDWT
from dwt_tpu.nn import ResNetDWT as JaxResNetDWT
from dwt_tpu.ops.whitening import group_whiten as jax_group_whiten
from dwt_tpu.ops.whitening import init_whitening_stats as jax_init_stats
from dwt_tpu.parallel import DATA_AXIS
from dwt_tpu.parallel import make_mesh as jax_make_mesh
from dwt_tpu.parallel import make_sharded_train_step as jax_sharded_step
from dwt_tpu.parallel import plan_from_flags as jax_plan_from_flags
from dwt_tpu.parallel import replicate_state as jax_replicate
from dwt_tpu.parallel import shard_batch as jax_shard_batch
from dwt_tpu.train import steps as jsteps
from dwt_tpu.train.evalpipe import make_whiten_cache_fn
from dwt_tpu.train.optim import adam_l2 as jax_adam_l2
from dwt_tpu.train.optim import multistep_schedule as jax_multistep
from dwt_tpu.train.optim import officehome_tx as jax_officehome_tx
from dwt_tpu.train.optim import with_lr_backoff
from dwt_tpu.train.state import TrainState as JaxTrainState
from dwt_tpu.data.datasets import ArrayDataset as JaxArrayDataset
from dwt_tpu.data.loader import batch_iterator as jax_batch_iterator
from dwt_tpu_torch import parallel
from dwt_tpu_torch.convert import load_jax_variables
from dwt_tpu_torch.nn.lenet import build_lenet
from dwt_tpu_torch.nn.resnet import ResNetDWT

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_dp_worker.py")
N_IMG = 8  # images per stream of the global batch
SPE = 3  # the digits schedule's steps per epoch
METRIC_TOL = dict(rtol=1e-4)
STATS_TOL = dict(rtol=1e-4, atol=1e-4)
UPDATE_TOL = 2e-3
NORMALIZED_BIASES = {"conv1.bias", "conv2.bias", "fc3.bias", "fc4.bias", "fc5.bias"}
torch.set_num_threads(2)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(tmp, world: int, cases, dcn: int = 0):
    """Run ``cases`` on ``world`` worker ranks; their outputs, by rank."""
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if not k.startswith(("DWT_", "MASTER_"))}
    env.update(DWT_DIST_TIMEOUT_S="60", OMP_NUM_THREADS="2")
    procs = []
    for r in range(world):
        spec = tmp / f"spec_{r}.json"
        spec.write_text(json.dumps(dict(rank=r, world=world, port=port, dcn=dcn,
                                        dir=str(tmp), cases=cases)))
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


def _randomize(params, stats, rng):
    params = jax.tree.map(
        lambda a: (a + rng.normal(0, 0.1, a.shape) if a.ndim == 1 else a).astype(a.dtype),
        params)

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

    return params, jax.tree_util.tree_map_with_path(leaf, stats)


def _digits_tx():
    return with_lr_backoff(jax_adam_l2(
        jax_multistep(1e-3, (50, 80), 0.1, scale=SPE), 5e-4))


@pytest.fixture(scope="module")
def digits():
    """JAX's LeNet-DWT state (randomized stats) and two global batches."""
    model = JaxLeNetDWT(group_size=4)
    variables = jax.jit(lambda k: model.init(
        k, jnp.zeros((2, N_IMG, 28, 28, 1)), train=True))(jax.random.key(0))
    params, stats = _randomize(jax.tree.map(np.asarray, variables["params"]),
                               jax.tree.map(np.asarray, variables["batch_stats"]),
                               np.random.default_rng(0))
    params = jax.tree.map(jnp.asarray, params)
    state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                          batch_stats=jax.tree.map(jnp.asarray, stats),
                          opt_state=_digits_tx().init(params))
    rng = np.random.default_rng(1)
    batches = [{"source_x": rng.normal(size=(N_IMG, 28, 28, 1)).astype(np.float32),
                "source_y": rng.integers(0, 10, size=N_IMG),
                "target_x": rng.normal(0.5, size=(N_IMG, 28, 28, 1)).astype(np.float32)}
               for _ in range(2)]
    return state, batches


def _lenet(params, stats):
    port = build_lenet(group_size=4)
    load_jax_variables(port, jax.tree.map(np.asarray, params),
                       jax.tree.map(np.asarray, stats))
    return port


def _write_inputs(tmp, model, batches):
    torch.save(model.state_dict(), tmp / "init.pt")
    for i, b in enumerate(batches):
        np.savez(tmp / f"batch_{i}.npz", **b)


def _jax_dp(state, batches, world, dcn, make_model, make_step):
    mesh = jax_make_mesh(jax.devices()[:world], dcn_slices=dcn or None)
    axis = tuple(mesh.axis_names) if dcn else DATA_AXIS
    step = jax_sharded_step(make_step(make_model(axis), axis), mesh)
    st = jax_replicate(state, mesh)
    states, metrics = [], []
    for b in batches:
        st, m = step(st, jax_shard_batch(jax.tree.map(jnp.asarray, b), mesh))
        states.append(st)
        metrics.append(jax.tree.map(float, m))
    return states, metrics


def _assert_step(outs, kind, jax_states, jax_metrics, port_of, keys, adam_lr=None):
    """Rank 0's metrics, stats and parameters after each step against
    JAX's; every rank's outputs bitwise rank 0's; the scanned run bitwise
    the single steps.  SGD (``adam_lr`` None): each parameter's update
    within ``UPDATE_TOL`` of JAX's.  Adam: JAX's own DP parity bound,
    ``|p − p_jax| ≤ 2·steps·lr`` (a near-zero gradient's update is a full
    ±lr whose sign float noise can flip), and from step 2 on the metrics
    at ``rtol=1e-3, atol=1e-5`` and the stats at ``atol=1e-3``."""
    params = {n for n, _ in port_of(jax_states[0]).named_parameters()}
    for i, st in enumerate(jax_states[1:]):
        ref = port_of(st).state_dict()
        before = dict(port_of(jax_states[i]).named_parameters())
        tight = i == 0
        for key in keys:
            np.testing.assert_allclose(
                float(outs[0][f"{kind}_m{i}_{key}"]), jax_metrics[i][key], err_msg=key,
                **(METRIC_TOL if tight else dict(rtol=1e-3, atol=1e-5)))
        for name, want in ref.items():
            got = outs[0][f"{kind}_state{i}_{name}"]
            if name not in params:
                np.testing.assert_allclose(got, want.numpy(), err_msg=name,
                                           **(STATS_TOL if tight else dict(rtol=0, atol=1e-3)))
            elif adam_lr is not None:
                np.testing.assert_allclose(got, want.detach().numpy(), rtol=0,
                                           atol=2 * (i + 1) * adam_lr, err_msg=name)
            elif name not in NORMALIZED_BIASES:
                delta = (want - before[name]).detach().double()
                mine = (torch.from_numpy(got) - before[name]).detach().double()
                err = float((mine - delta).norm() / delta.norm())
                assert err <= UPDATE_TOL, (name, err)
    for out in outs[1:]:
        for k, v in outs[0].items():
            if k.startswith((f"{kind}_", "eval_", "collect_")):
                assert np.array_equal(out[k], v), k
    last = len(jax_states) - 2
    for k, v in outs[0].items():
        if k.startswith(f"{kind}_state{last}_"):
            assert np.array_equal(outs[0][k.replace(f"_state{last}_", "_scanned_")], v), k


@pytest.mark.parametrize("world,dcn", [(2, 0), (4, 0), (4, 2)],
                         ids=["2", "4", "2x2"])
def test_digits_replica_step_eval_and_collect_match_jax(tmp_path, digits, world, dcn):
    state, batches = digits
    make_model = lambda axis: JaxLeNetDWT(group_size=4, axis_name=axis)
    make_step = lambda m, axis: jsteps.make_digits_train_step(m, _digits_tx(), 0.1,
                                                              axis_name=axis)
    jax_states, jax_metrics = _jax_dp(state, batches, world, dcn, make_model, make_step)

    # Eval: a chunk of two masked batches; collect: 28 images at batch 8.
    rng = np.random.default_rng(5)
    chunk = {"x": rng.normal(size=(2, N_IMG, 28, 28, 1)).astype(np.float32),
             "y": rng.integers(0, 10, size=(2, N_IMG)),
             "mask": np.ones((2, N_IMG), bool)}
    chunk["mask"][1, 5:] = False
    cx = rng.normal(0.3, size=(28, 28, 28, 1)).astype(np.float32)
    cy = rng.integers(0, 10, size=28)
    _write_inputs(tmp_path, _lenet(state.params, state.batch_stats), batches)
    np.savez(tmp_path / "eval.npz", **chunk)
    np.savez(tmp_path / "collect.npz", x=cx, y=cy)
    outs = _spawn(tmp_path, world, [
        dict(name="digits_train", kind="digits", steps=2, spe=SPE),
        dict(name="eval"),
        dict(name="collect", batch=8, k=3, passes=2),
    ], dcn=dcn)
    assert [int(o["mesh_index"]) for o in outs] == list(range(world))
    port_of = lambda st: _lenet(st.params, st.batch_stats)
    _assert_step(outs, "digits", [state] + jax_states, jax_metrics, port_of,
                 ("loss", "cls_loss", "entropy_loss", "grad_norm"), adam_lr=1e-3)

    model = JaxLeNetDWT(group_size=4)
    cache = make_whiten_cache_fn()(state.batch_stats)
    counters = jax.jit(jsteps.make_accum_eval_step(model))(
        jsteps.eval_counters(), state.params, state.batch_stats, cache,
        jax.tree.map(jnp.asarray, chunk))
    assert int(outs[0]["eval_correct"]) == int(counters["correct"])
    assert int(outs[0]["eval_count"]) == int(counters["count"]) == 2 * N_IMG - 3
    np.testing.assert_allclose(float(outs[0]["eval_loss_sum"]),
                               float(counters["loss_sum"]), rtol=1e-5)

    collect = jax.jit(jsteps.make_stat_collection_step(model, 2))
    want = state
    for p in range(2):
        for x, _ in jax_batch_iterator(JaxArrayDataset(cx, cy), 8, shuffle=False,
                                       drop_last=False, epoch=p):
            want = collect(want, jnp.asarray(x))
    ref = _lenet(want.params, want.batch_stats).state_dict()
    for name, value in ref.items():
        np.testing.assert_allclose(outs[0][f"collect_{name}"], value.numpy(),
                                   rtol=1e-5, atol=2e-5, err_msg=name)


def test_officehome_replica_step_matches_jax(tmp_path):
    """The tiny ResNet-DWT's OfficeHome step (two SGD lr groups) on two
    ranks, 4 images of each stream a rank, against JAX's on two devices."""
    classes, size = 5, 32
    model = JaxResNetDWT(stage_sizes=(1, 1, 1, 1), num_classes=classes)
    tx = jax_officehome_tx(JaxOfficeHomeConfig())
    variables = jax.jit(lambda k: model.init(
        k, jnp.zeros((3, N_IMG, size, size, 3)), train=True))(jax.random.key(0))
    params, stats = _randomize(jax.tree.map(np.asarray, variables["params"]),
                               jax.tree.map(np.asarray, variables["batch_stats"]),
                               np.random.default_rng(0))
    params = jax.tree.map(jnp.asarray, params)
    state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                          batch_stats=jax.tree.map(jnp.asarray, stats),
                          opt_state=tx.init(params))
    rng = np.random.default_rng(2)
    img = lambda: rng.normal(size=(N_IMG, size, size, 3)).astype(np.float32)
    batches = [{"source_x": img(), "source_y": rng.integers(0, classes, size=N_IMG),
                "target_x": img(), "target_aug_x": img()}]
    make_model = lambda axis: JaxResNetDWT(stage_sizes=(1, 1, 1, 1),
                                           num_classes=classes, axis_name=axis)
    make_step = lambda m, axis: jsteps.make_officehome_train_step(m, tx, 0.1,
                                                                  axis_name=axis)
    jax_states, jax_metrics = _jax_dp(state, batches, 2, 0, make_model, make_step)

    def port_of(st):
        port = ResNetDWT.tiny(num_classes=classes)
        load_jax_variables(port, jax.tree.map(np.asarray, st.params),
                           jax.tree.map(np.asarray, st.batch_stats))
        return port

    _write_inputs(tmp_path, port_of(state), batches)
    outs = _spawn(tmp_path, 2, [dict(name="officehome_train", kind="officehome",
                                     steps=1, classes=classes)])
    _assert_step(outs, "officehome", [state] + jax_states, jax_metrics, port_of,
                 ("loss", "cls_loss", "mec_loss", "grad_norm"))


def _jax_whiten(x, gy, dtype):
    """JAX's train-mode ``group_whiten`` of each domain's global rows: y,
    the new stats and the input gradient."""
    stats = jax.tree.map(lambda a: a.astype(dtype), jax_init_stats(x.shape[-1], 4))

    def f(xx):
        outs = [jax_group_whiten(xx[i], stats, group_size=4, train=True)
                for i in range(xx.shape[0])]
        return jnp.stack([o[0] for o in outs]), [o[1] for o in outs]

    @jax.jit
    def run(xx, g):
        y, pull, new = jax.vjp(f, xx, has_aux=True)
        return y, new, pull(g)[0]

    y, new, dx = run(jnp.asarray(x, dtype), jnp.asarray(gy, dtype))
    return np.asarray(y), new, np.asarray(dx)


def test_group_whitening_gradient_is_the_global_batchs(tmp_path):
    """Two ranks, each with half the rows of every domain: the group-aware
    plain op (f64 and f32) and the kernel seam give JAX's global-batch
    outputs, stats and input gradient on the concatenated rows."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 16, 8)) * np.linspace(0.5, 2.0, 8) + 0.3
    gy = rng.normal(size=x.shape)
    np.savez(tmp_path / "whiten.npz", x=x, gy=gy)
    torch.save(build_lenet(group_size=4).state_dict(), tmp_path / "init.pt")
    outs = _spawn(tmp_path, 2, [dict(name="whiten_grad", group_size=4)])
    cat = lambda key: np.concatenate([o[key] for o in outs], axis=1)
    with jax.enable_x64(True):
        y64, new64, dx64 = _jax_whiten(x, gy, jnp.float64)
    np.testing.assert_allclose(cat("plain_f64_y"), y64, rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(cat("plain_f64_dx"), dx64, rtol=1e-10, atol=1e-10)
    for i in range(2):
        for o in outs:
            np.testing.assert_allclose(o[f"plain_f64_mean{i}"], np.asarray(new64[i].mean),
                                       rtol=1e-10, atol=1e-12)
            np.testing.assert_allclose(o[f"plain_f64_cov{i}"], np.asarray(new64[i].cov),
                                       rtol=1e-10, atol=1e-12)
    y32, new32, dx32 = _jax_whiten(x, gy, jnp.float32)
    for prefix in ("plain_f32", "kernel"):
        np.testing.assert_allclose(cat(f"{prefix}_y"), y32, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(cat(f"{prefix}_dx"), dx32, rtol=1e-4, atol=1e-4)
    for o in outs:
        np.testing.assert_allclose(o["kernel_mean"], np.stack([n.mean for n in new32]),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(o["kernel_cov"], np.stack([n.cov for n in new32]),
                                   rtol=1e-4, atol=1e-5)


# (flags, JAX world): the port's plan at world size N against JAX's with N
# devices (the fake mesh has 8).
RULES_FILE = os.path.join(REPO, "configs", "resnet152_fsdp_rules.json")
PLAN_CASES = [
    dict(),
    dict(data_parallel=True),
    dict(data_parallel=True, dcn_slices=2),
    dict(data_parallel=True, dcn_slices=3),
    dict(dcn_slices=2),
    dict(data_parallel=True, batch_size=12),
    dict(data_parallel=True, batch_size=16),
    dict(data_parallel=True, pallas_whiten=True),
    dict(pallas_whiten=True),
    dict(mesh_shape="8"),
    dict(mesh_shape="2,4"),
    dict(mesh_shape="2,4", dcn_slices=4),
    dict(mesh_shape="1,4,2"),
    dict(mesh_shape="16"),
    dict(mesh_shape="x,4"),
    dict(mesh_shape="8", batch_size=12),
    dict(data_parallel=True, sharding_rules="model"),
    # The gspmd mode: presets, a rules file, a table that shards nothing,
    # the dcn and mesh conflicts, batch divisibility over the data axes.
    dict(mesh_shape="1,4,2", sharding_rules="model"),
    dict(mesh_shape="1,4,2", sharding_rules="fsdp"),
    dict(mesh_shape="1,4,2", sharding_rules=RULES_FILE),
    dict(mesh_shape="2,2,2", sharding_rules="fsdp"),
    dict(mesh_shape="1,8,1", sharding_rules="model"),
    dict(sharding_rules="fsdp"),
    dict(mesh_shape="1,4,2", sharding_rules="model", dcn_slices=2),
    dict(mesh_shape="4,2,1", sharding_rules="model", dcn_slices=2),
    dict(mesh_shape="1,4,2", sharding_rules="model", batch_size=6),
    dict(mesh_shape="1,64,2", sharding_rules="model"),
    dict(mesh_shape="1,2,2", sharding_rules="dp"),
]


def _decide(fn, kwargs):
    try:
        plan = fn(**kwargs)
    except (ValueError, NotImplementedError) as e:
        return ("error", str(e))
    shape = None if plan.mesh is None else dict(plan.mesh.shape)
    return (plan.mode, plan.data_size, shape)


@pytest.mark.parametrize("flags", PLAN_CASES, ids=lambda f: ",".join(
    f"{k}={os.path.basename(str(v))}" for k, v in f.items()) or "none")
def test_plan_from_flags_matches_jax(flags):
    assert jax.device_count() == 8
    ours = _decide(lambda **kw: parallel.plan_from_flags(world_size=8, local_devices=0,
                                                         distributed=True, **kw), flags)
    theirs = _decide(jax_plan_from_flags, flags)
    assert ours == theirs


def test_plan_rules_and_device_guards():
    """A non-dp rules table is the gspmd mode over every rank; --data_parallel
    on one rank is single, and without --distributed on a multi-GPU host it
    raises; a mesh shape that leaves ranks out raises, under dp rules and
    under a model-sharding table."""
    plan = parallel.plan_from_flags(sharding_rules="fsdp", world_size=8, local_devices=0)
    assert plan.mode == "gspmd" and dict(plan.mesh.shape) == {"dcn": 1, "data": 8, "model": 1}
    assert not plan.uses_state_sharding and plan.data_size == 8
    with pytest.raises(ValueError, match="every rank must be in the mesh"):
        parallel.plan_from_flags(mesh_shape="1,2,2", sharding_rules="model", world_size=8,
                                 local_devices=0)
    assert parallel.plan_from_flags(data_parallel=True, world_size=1,
                                    local_devices=0).mode == "single"
    with pytest.raises(ValueError, match="one process per GPU"):
        parallel.plan_from_flags(data_parallel=True, world_size=1, local_devices=2)
    with pytest.raises(ValueError, match="every rank must be in the mesh"):
        parallel.plan_from_flags(mesh_shape="4", world_size=8, local_devices=0)
    assert parallel.choose_backend("cpu", 2, 0) == "gloo"
    assert parallel.choose_backend("cuda", 2, 1) == "gloo"
    assert parallel.choose_backend("cuda", 2, 2) == "nccl"
    with pytest.raises(ValueError, match="cannot split into 3 equal slices"):
        parallel.make_mesh(list(range(8)), dcn_slices=3)
