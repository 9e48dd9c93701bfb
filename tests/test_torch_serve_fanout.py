"""Port parity: the server's fan-out over ranks against the JAX engine's sharded serving.

Ranks are gloo processes of ``python -m dwt_tpu_torch.serve.server
--distributed --device cpu`` (``tests/torch_fanout_ranks.py``); the JAX
oracle runs in this process on the 8 CPU devices the conftest forces.
Weights are tied through ``convert.from_jax``: the JAX variables (stats
randomized) are loaded into the port model and saved as a port
checkpoint every rank restores.

* replica (``--data_parallel`` on 2 ranks, LeNet-DWT): the buckets equal
  JAX ``ServeEngine(..., mesh=make_mesh(devices[:2])).buckets``; five rows
  through the front's HTTP match that engine and the port's one-process
  engine at ``rtol=2e-4, atol=2e-3`` (``tests/test_serve.py``'s replica
  tolerance); both ranks forwarded and hold one generation digest;
* gspmd (``model`` at ``1,2,2`` on LeNet-DWT, 4 ranks; ``fsdp`` at
  ``1,1,2`` on the tiny ResNet-DWT, 2 ranks): every rank's local
  parameter shapes are the blocks of JAX ``plan.tree_specs`` on the serve
  state, the resident share is the blocks', and the logits match JAX's
  gspmd ``ServeEngine`` at the same tolerance;
* the flag conflicts raise the texts of JAX's ``plan_from_flags`` (and
  ``fsdp`` at model 2 on ResNet50-DWT's 65-class head its indivisible-head
  error, from the serve state's specs).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dwt_tpu import parallel as jpar
from dwt_tpu.nn import LeNetDWT as JaxLeNetDWT
from dwt_tpu.nn.registry import build_backbone as jax_build_backbone
from dwt_tpu.serve import ServeEngine as JaxServeEngine
from dwt_tpu.train.evalpipe import make_whiten_cache_fn
from dwt_tpu_torch.convert import load_jax_variables
from dwt_tpu_torch.nn.lenet import build_lenet
from dwt_tpu_torch.nn.registry import build_backbone
from dwt_tpu_torch.parallel.paths import serve_leaves
from dwt_tpu_torch.serve import ServeEngine
from dwt_tpu_torch.serve import server
from dwt_tpu_torch.utils import checkpoint as ckpt

from torch_fanout_ranks import Ranks

torch.set_num_threads(2)

RTOL, ATOL = 2e-4, 2e-3
LENET_SHAPE = (28, 28, 1)
TINY_SHAPE = (32, 32, 3)
TINY_CLASSES = 4


def _randomize(params, stats, rng):
    params = jax.tree.map(
        lambda a: (np.asarray(a) + rng.normal(0, 0.1, a.shape) if a.ndim == 1
                   else np.asarray(a)).astype(np.float32), params)

    def leaf(path, a):
        name = getattr(path[-1], "name", str(path[-1]))
        if name == "cov":
            m = rng.normal(size=a.shape)
            return (m @ np.swapaxes(m, -1, -2) / 4 + 0.5 * np.eye(a.shape[-1])).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 2.0, size=a.shape).astype(np.float32)
        if name == "mean":
            return rng.normal(0.0, 0.2, size=a.shape).astype(np.float32)
        return np.asarray(a)

    return params, jax.tree_util.tree_map_with_path(leaf, jax.tree.map(np.asarray, stats))


def _tied(kind, d):
    """``(jax model, params, stats, port model loaded from them)``, the port
    model also saved as step 1 under ``d``."""
    if kind == "lenet":
        jmodel = JaxLeNetDWT(group_size=4)
        sample = jnp.zeros((2, 2) + LENET_SHAPE)
        port = build_lenet(group_size=4)
    else:
        jmodel = jax_build_backbone("tiny", num_classes=TINY_CLASSES)
        sample = jnp.zeros((3, 2) + TINY_SHAPE)
        port = build_backbone("tiny", num_classes=TINY_CLASSES, image_size=TINY_SHAPE[0])
    variables = jax.jit(lambda k: jmodel.init(k, sample, train=True))(jax.random.key(0))
    params, stats = _randomize(variables["params"], variables["batch_stats"],
                               np.random.default_rng(0))
    load_jax_variables(port, params, stats)
    host = ckpt.HostState({"model": {k: v.clone() for k, v in port.state_dict().items()},
                           "optimizer": {"state": {}, "param_groups": []},
                           "step": 1, "lr_scale": 1.0},
                          tuple(n for n, _ in port.named_parameters()))
    ckpt.save_state(str(d), 1, host)
    return jmodel, params, stats, port


def _flags(kind, d, buckets):
    if kind == "lenet":
        model = ["--model", "lenet"]
    else:
        model = ["--model", "tiny", "--num_classes", str(TINY_CLASSES),
                 "--image_size", str(TINY_SHAPE[0])]
    return model + ["--ckpt_dir", str(d), "--buckets", buckets, "--max_batch_delay_ms", "2"]


def _images(shape, n=5, seed=3):
    return np.random.default_rng(seed).normal(size=(n,) + shape).astype(np.float32)


def test_replica_fanout_matches_jax_sharded_engine(tmp_path):
    d = tmp_path / "ck"
    jmodel, params, stats, port = _tied("lenet", d)
    jeng = JaxServeEngine(jmodel, params, stats, LENET_SHAPE, buckets=(1, 8, 32),
                          mesh=jpar.make_mesh(jax.devices()[:2]))
    x = _images(LENET_SHAPE)
    want = np.asarray(jeng.infer(x))
    one = ServeEngine.from_checkpoint(str(d), build_lenet(group_size=4), LENET_SHAPE,
                                      buckets=(1, 8, 32), device="cpu")
    ranks = Ranks(tmp_path, 2, _flags("lenet", d, "1,8,32") + ["--data_parallel"])
    try:
        assert ranks.ready["buckets"] == list(jeng.buckets) == [2, 8, 32]
        assert ranks.ready["plan"].startswith("replica")
        got = ranks.client.infer(x)
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(got, one.infer(x), rtol=RTOL, atol=ATOL)
        report = ranks.fanout(digest=True)
        assert [r["forwards"] for r in report["ranks"]] == [1, 1]
        assert len({r["digest"] for r in report["ranks"]}) == 1
        assert all(r["resident_param_bytes"] == r["full_param_bytes"] for r in report["ranks"])
    finally:
        rcs = ranks.stop()
        ranks.kill()
    assert rcs == [0, 0], ranks.stderr(0)[-2000:]


def _jax_serve_specs(plan, jmodel, params, stats):
    tree = {"params": params, "batch_stats": stats,
            "whiten_cache": make_whiten_cache_fn()(stats)}
    flat = jax.tree_util.tree_flatten_with_path(
        plan.tree_specs(tree, "serve state"),
        is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))[0]
    return {jax.tree_util.keystr(p): s for p, s in flat}


def _block_shapes(port, specs, sizes):
    """Each parameter's block shape (the port's layout) under JAX's specs."""
    out = {}
    for leaf in serve_leaves(port):
        if not leaf.keystr.startswith("['params']"):
            continue
        spec = tuple(specs[leaf.keystr]) + (None,) * (len(leaf.shape) - len(specs[leaf.keystr]))
        block = []
        for n, axes in zip(leaf.shape, spec):
            axes = () if axes is None else (axes if isinstance(axes, tuple) else (axes,))
            block.append(n // int(np.prod([sizes[a] for a in axes] or [1])))
        out[leaf.name] = [block[j] for j in leaf.perm] if leaf.perm else block
    return out


@pytest.mark.parametrize("kind,mesh,rules,world", [
    ("lenet", (1, 2, 2), "model", 4),
    ("tiny", (1, 1, 2), "fsdp", 2),
])
def test_gspmd_fanout_blocks_and_logits_match_jax(tmp_path, kind, mesh, rules, world):
    d = tmp_path / "ck"
    jmodel, params, stats, port = _tied(kind, d)
    shape = LENET_SHAPE if kind == "lenet" else TINY_SHAPE
    plan = jpar.ShardingPlan.gspmd(jpar.make_plan_mesh(mesh, jax.devices()[:world]),
                                   jpar.PRESETS[rules], name=rules)
    jeng = JaxServeEngine(jmodel, params, stats, shape, buckets=(1, 8), plan=plan)
    x = _images(shape)
    want = np.asarray(jeng.infer(x))
    blocks = _block_shapes(port, _jax_serve_specs(plan, jmodel, params, stats),
                           dict(zip(("dcn", "data", "model"), mesh)))
    ranks = Ranks(tmp_path, world, _flags(kind, d, "1,8") + [
        "--mesh_shape", ",".join(map(str, mesh)), "--sharding_rules", rules])
    try:
        assert ranks.ready["buckets"] == list(jeng.buckets)
        got = ranks.client.infer(x)
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
        report = ranks.fanout(shapes=True, digest=True)
        assert len({r["digest"] for r in report["ranks"]}) == 1
        for r in report["ranks"]:
            assert r["shapes"] == blocks, r["rank"]
            held = sum(int(np.prod(s)) for s in blocks.values()) * 4
            assert r["resident_param_bytes"] == held < r["full_param_bytes"]
    finally:
        rcs = ranks.stop()
        ranks.kill()
    assert rcs == [0] * world, ranks.stderr(0)[-2000:]


def _jax_error(**flags):
    with pytest.raises(ValueError) as e:
        jpar.plan_from_flags(**flags)
    return str(e.value)


@pytest.mark.parametrize("argv,flags", [
    (["--data_parallel", "--sharding_rules", "model"],
     dict(data_parallel=True, sharding_rules="model")),
    (["--mesh_shape", "1,2,2"], dict(mesh_shape="1,2,2")),
    (["--mesh_shape", "1,16,1"], dict(mesh_shape="1,16,1")),
    (["--mesh_shape", "1,4,4", "--sharding_rules", "model"],
     dict(mesh_shape="1,4,4", sharding_rules="model")),
], ids=["data_parallel_with_model_rules", "dp_rules_with_model_axis", "mesh_too_large",
        "gspmd_mesh_too_large"])
def test_flag_conflicts_raise_jax_text(argv, flags):
    args = server.build_parser().parse_args(["--init_random", "--device", "cpu"] + argv)
    assert jax.device_count() == 8
    with pytest.raises(SystemExit) as e:
        server.build_plan(args, world_size=8)
    assert _jax_error(**flags) in str(e.value)


def test_fsdp_on_the_65_class_head_raises_jax_text():
    """ResNet50-DWT's ``fc_out`` (65 classes) under ``fsdp`` at model 2:
    the serve state's specs raise the JAX plan's indivisible-head error
    (the server has no ``--pad_classes_to``)."""
    jmodel = jax_build_backbone("resnet50", num_classes=65)
    variables = jax.eval_shape(lambda: jmodel.init(
        jax.random.key(0), jnp.zeros((3, 1, 32, 32, 3)), train=True))
    tree = {"params": variables["params"], "batch_stats": variables["batch_stats"],
            "whiten_cache": jax.eval_shape(make_whiten_cache_fn(), variables["batch_stats"])}
    plan = jpar.ShardingPlan.gspmd(jpar.make_plan_mesh((1, 1, 2), jax.devices()[:2]),
                                   jpar.PRESETS["fsdp"], name="fsdp")
    with pytest.raises(ValueError) as want:
        plan.tree_specs(tree, "serve state")
    args = server.build_parser().parse_args(
        ["--init_random", "--device", "cpu", "--mesh_shape", "1,1,2", "--sharding_rules", "fsdp"])
    port_plan = server.build_plan(args, world_size=2)
    with torch.device("meta"):
        model = build_backbone("resnet50", num_classes=65)
    with pytest.raises(ValueError) as got:
        port_plan.serve_layout(model)
    assert "--pad_classes_to" in str(want.value)
    assert str(got.value) == str(want.value)
