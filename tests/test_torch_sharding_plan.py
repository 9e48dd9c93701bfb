"""Port parity: the rules half of ``dwt_tpu_torch.parallel.plan`` against
``dwt_tpu.parallel.plan`` on the fake CPU mesh, with no processes.

* ``match_partition_rules`` over the port's train states (the JAX key
  paths of ``parallel.paths``) against JAX's over its ``TrainState`` for
  the ``model`` and ``fsdp`` presets and ``configs/resnet152_fsdp_rules.
  json``: LeNet-DWT with Adam, the tiny ResNet-DWT with two-group SGD, and
  ResNet-152 (the port's on the ``meta`` device, JAX's through
  ``jax.eval_shape``) — every leaf's spec equal, and each torch-dim spec
  JAX's through the leaf's layout map;
* the same error and warning texts as JAX's: no match, shadowed rule,
  duplicate rule, moment skew, indivisible head (naming
  ``--pad_classes_to``), bad specs and bad rules files;
* every rank position's block of ``parallel.gspmd.block_slices`` against
  ``NamedSharding(mesh, spec).devices_indices_map(shape)``, a dim over two
  axes included;
* a gspmd plan's properties (``data_size``, ``batch_spec``,
  ``uses_model_axis``, ``uses_state_sharding``, ``batch_shard``) against
  JAX's.
"""

from __future__ import annotations

import json
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as JP

from dwt_tpu import parallel as jpar
from dwt_tpu.config import OfficeHomeConfig as JaxOfficeHomeConfig
from dwt_tpu.nn import LeNetDWT as JaxLeNetDWT
from dwt_tpu.nn import ResNetDWT as JaxResNetDWT
from dwt_tpu.nn import build_backbone as jax_build_backbone
from dwt_tpu.train.optim import adam_l2 as jax_adam_l2
from dwt_tpu.train.optim import multistep_schedule as jax_multistep
from dwt_tpu.train.optim import officehome_tx as jax_officehome_tx
from dwt_tpu.train.optim import with_lr_backoff
from dwt_tpu.train.state import TrainState as JaxTrainState
from dwt_tpu_torch import parallel
from dwt_tpu_torch.config import DigitsConfig, OfficeHomeConfig
from dwt_tpu_torch.nn.lenet import build_lenet
from dwt_tpu_torch.nn.registry import build_backbone
from dwt_tpu_torch.nn.resnet import ResNetDWT
from dwt_tpu_torch.parallel import gspmd
from dwt_tpu_torch.parallel.paths import state_leaves
from dwt_tpu_torch.train.optim import digits_tx, officehome_tx
from dwt_tpu_torch.train.state import TrainState

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RULES_FILE = os.path.join(REPO, "configs", "resnet152_fsdp_rules.json")
TABLES = ["model", "fsdp", RULES_FILE]


def _jax_rules(table):
    return (jpar.PRESETS[table] if table in jpar.PRESETS
            else jpar.load_rules_file(table))


def _port_rules(table):
    return (parallel.PRESETS[table] if table in parallel.PRESETS
            else parallel.load_rules_file(table))


def _jax_state(model, tx, sample):
    def make(k):
        v = model.init(k, sample, train=True)
        return JaxTrainState(step=jnp.zeros((), jnp.int32), params=v["params"],
                             batch_stats=v["batch_stats"], opt_state=tx.init(v["params"]))

    return jax.eval_shape(make, jax.random.key(0))


def _lenet_pair():
    jstate = _jax_state(JaxLeNetDWT(group_size=4),
                        with_lr_backoff(jax_adam_l2(jax_multistep(1e-3, (50, 80), 0.1, scale=3),
                                                    5e-4)),
                        jnp.zeros((2, 2, 28, 28, 1)))
    model = build_lenet(group_size=4)
    optimizer, schedules = digits_tx(model, DigitsConfig(), 3)
    return jstate, TrainState(model, optimizer, schedules)


def _tiny_resnet_pair(classes=6):
    jstate = _jax_state(JaxResNetDWT(stage_sizes=(1, 1, 1, 1), num_classes=classes),
                        jax_officehome_tx(JaxOfficeHomeConfig()),
                        jnp.zeros((3, 2, 32, 32, 3)))
    model = ResNetDWT.tiny(num_classes=classes)
    optimizer, schedules = officehome_tx(model, OfficeHomeConfig())
    return jstate, TrainState(model, optimizer, schedules)


def _resnet152_pair():
    jstate = _jax_state(jax_build_backbone("resnet152", num_classes=65, pad_classes_to=2),
                        jax_officehome_tx(JaxOfficeHomeConfig()),
                        jnp.zeros((3, 1, 32, 32, 3)))
    with torch.device("meta"):
        model = build_backbone("resnet152", num_classes=65, pad_classes_to=2)
        optimizer, schedules = officehome_tx(model, OfficeHomeConfig())
    return jstate, TrainState(model, optimizer, schedules)


PAIRS = {"lenet_adam": _lenet_pair, "tiny_resnet_sgd": _tiny_resnet_pair,
         "resnet152_sgd": _resnet152_pair}


def _jax_flat(tree):
    return {jax.tree_util.keystr(p): v for p, v in
            jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=lambda x: isinstance(x, JP))[0]}


@pytest.fixture(scope="module")
def pairs():
    return {name: make() for name, make in PAIRS.items()}


@pytest.mark.parametrize("table", TABLES, ids=["model", "fsdp", "rules_file"])
@pytest.mark.parametrize("which", list(PAIRS))
def test_tree_specs_match_jax(pairs, which, table):
    """Every tensor of the port's state gets the spec JAX's rule matcher
    gives its leaf (over the (1, 4, 2) mesh, shapes validated), and its
    torch-dim spec is that spec through the layout map; every JAX leaf
    with a non-scalar shape that the port holds as a tensor is covered."""
    jstate, state = pairs[which]
    jmesh = jpar.make_plan_mesh((1, 4, 2))
    mesh = parallel.make_plan_mesh((1, 4, 2), world=8)
    want = _jax_flat(jpar.match_partition_rules(_jax_rules(table), jstate, mesh=jmesh,
                                                what="train state"))
    shapes = {k: tuple(v.shape) for k, v in _jax_flat(jstate).items()}
    got = parallel.match_partition_rules(_port_rules(table), state, mesh=mesh,
                                         what="train state")
    leaves = state_leaves(state.model, state.optimizer)
    assert [leaf.keystr for leaf in leaves] == list(got)
    for leaf in leaves:
        assert leaf.keystr in want, leaf.keystr
        assert leaf.shape == shapes[leaf.keystr], leaf.keystr
        assert tuple(got[leaf.keystr]) == tuple(want[leaf.keystr]), leaf.keystr
        spec = gspmd.torch_spec(got[leaf.keystr], len(leaf.shape), leaf.perm)
        jdims = [want[leaf.keystr][j] if j < len(want[leaf.keystr]) else None
                 for j in range(len(leaf.shape))]
        for t, axes in enumerate(spec):
            j = t if leaf.perm is None else leaf.perm[t]
            expect = jdims[j]
            assert axes == (None if expect is None else
                            tuple(expect) if isinstance(expect, tuple) else (expect,))
    covered = {leaf.keystr for leaf in leaves}
    missing = [k for k, s in shapes.items()
               if k not in covered and int(np.prod(s)) > 1]
    assert missing == [], missing[:5]
    # The DWT contract: every running statistic stays whole.
    assert all(v == parallel.P() for k, v in got.items() if k.startswith(".batch_stats"))


def _both(fn):
    """``fn(module)`` for each package's plan module: the two texts (or
    the two exception texts)."""
    out = []
    for mod in (jpar.plan, parallel.plan):
        try:
            out.append(("ok", fn(mod)))
        except ValueError as e:
            out.append(("error", str(e)))
    return out


def _spec(mod, *dims):
    return (JP if mod is jpar.plan else parallel.P)(*dims)


def _mesh(mod, shape):
    n = int(np.prod(shape))
    return (jpar.make_plan_mesh(shape, jax.devices()[:n]) if mod is jpar.plan
            else parallel.make_plan_mesh(shape, world=n))


@pytest.mark.parametrize("case", [
    "no_match", "indivisible_head", "divisibility", "rank", "unknown_axis",
    "moment_skew"])
def test_error_texts_match_jax(pairs, case):
    jstate, state = pairs["lenet_adam"]

    def run(mod):
        P = lambda *d: _spec(mod, *d)
        if case == "no_match":
            return mod.match_partition_rules(
                [(r"\['fc\d'\]", P()), (r"bias", P())],
                {"params": {"conv9": {"kernel": np.zeros((3, 3, 4, 8))}}}, what="params")
        if case == "indivisible_head":
            plan = mod.ShardingPlan.gspmd(_mesh(mod, (1, 4, 2)),
                                          [(r"fc_out", P(None, "model")), (r".*", P())],
                                          name="t")
            return plan.tree_specs({"fc_out": {"kernel": np.zeros((2048, 65))}})
        plan = mod.ShardingPlan.gspmd(_mesh(mod, (1, 2, 2)), [
            (r"w", P(None, "model") if case != "unknown_axis" else P("nonexistent")),
            (r".*", P())], name="t")
        if case == "divisibility":
            return plan.tree_specs({"w": np.zeros((4, 5))})
        if case == "rank":
            return plan.tree_specs({"w": np.zeros((4,))})
        if case == "unknown_axis":
            return plan.tree_specs({"w": np.zeros((4, 4))})
        skewed = [(r"\.(mu|nu)\[", P()),
                  (r"conv\w*'\]\['kernel'\]", P(None, None, None, "model")),
                  (r"'\]\['kernel'\]", P(None, "model")), (r".*", P())]
        return mod.match_partition_rules(
            skewed, jstate if mod is jpar.plan else state, what="skewed table")

    (jk, jtext), (pk, ptext) = _both(run)
    assert jk == pk == "error"
    assert ptext == jtext
    if case == "indivisible_head":
        assert "--pad_classes_to 2" in ptext


def test_warnings_match_jax(caplog):
    """A shadowed rule and a duplicate rule warn in JAX's words."""
    texts = {}
    for mod, logger in ((jpar.plan, "dwt_tpu.parallel.plan"),
                        (parallel.plan, "dwt_tpu_torch.parallel.plan")):
        caplog.clear()
        P = lambda *d, m=mod: _spec(m, *d)
        with caplog.at_level(logging.WARNING, logger=logger):
            specs = mod.match_partition_rules([(r".*", P()), (r"\['w'\]", P("model", None))],
                                              {"w": np.zeros((4, 4))})
            mod.ShardingPlan.gspmd(_mesh(mod, (1, 2, 1)),
                                   [(r".*", P()), (r".*", P(None, "model"))], name="dup")
        assert tuple(specs["w"]) == ()
        texts[mod] = [r.getMessage() for r in caplog.records]
    assert len(texts[jpar.plan]) == 2
    assert texts[parallel.plan] == texts[jpar.plan]


def test_rules_file_loads_as_jax(tmp_path):
    path = tmp_path / "rules.json"
    path.write_text(json.dumps([
        [r"(\.|\[')(batch_stats|whiten_cache)", []],
        [r"conv\w*'\]\['kernel'\]", [None, None, None, "model"]],
        [r"fsdp", [["data", "model"]]],
        [r".*", []],
    ]))
    assert [(p, tuple(s)) for p, s in parallel.load_rules_file(str(path))] == \
        [(p, tuple(s)) for p, s in jpar.load_rules_file(str(path))]
    assert str(parallel.load_rules_file(str(path))[2][1]) == \
        str(jpar.load_rules_file(str(path))[2][1])
    for bad in ([["(unclosed", []]], [[".*", "model"]], [[".*", [3]]], [], {"a": 1},
                [[".*"]]):
        path.write_text(json.dumps(bad))
        (jk, jtext), (pk, ptext) = _both(lambda mod: mod.load_rules_file(str(path)))
        assert jk == pk == "error" and ptext == jtext


SPECS = [(None, None, None, "model"), (None, "model"), ("model", None), (("data", "model"),),
         ("data", "model"), (("dcn", "data"), None), (None, ("data", "model"), None, None)]


@pytest.mark.parametrize("shape", [(1, 4, 2), (2, 2, 2)], ids=["1x4x2", "2x2x2"])
def test_blocks_match_devices_indices_map(shape):
    """The block each rank position holds is the block JAX's sharding
    gives the device at that position, in the port's layout too."""
    jmesh = jpar.make_plan_mesh(shape)
    sizes = dict(zip(parallel.PLAN_AXES, shape))
    full = (8, 16, 4, 8)
    perm = (3, 2, 0, 1)  # conv HWIO -> OIHW
    for dims in SPECS:
        jshape = full[:max(len(dims), 2)] if len(dims) < 4 else full
        want = NamedSharding(jmesh, JP(*dims)).devices_indices_map(jshape)
        for pos, device in enumerate(jmesh.devices.reshape(-1)):
            coords = np.unravel_index(pos, shape)
            spec = gspmd.torch_spec(parallel.P(*dims), len(jshape), None)
            got = gspmd.block_slices(spec, jshape, coords, sizes)
            norm = lambda sl, n: tuple(range(n))[sl]
            assert [norm(g, n) for g, n in zip(got, jshape)] == \
                [norm(w, n) for w, n in zip(want[device], jshape)], (dims, pos)
            if len(jshape) == 4:
                tspec = gspmd.torch_spec(parallel.P(*dims), 4, perm)
                tshape = tuple(jshape[perm[t]] for t in range(4))
                tgot = gspmd.block_slices(tspec, tshape, coords, sizes)
                assert [norm(tgot[t], tshape[t]) for t in range(4)] == \
                    [norm(want[device][perm[t]], tshape[t]) for t in range(4)]


def test_gspmd_plan_properties_match_jax():
    for table in ("model", "fsdp"):
        jplan = jpar.plan_from_flags(mesh_shape="1,4,2", sharding_rules=table)
        plan = parallel.plan_from_flags(mesh_shape="1,4,2", sharding_rules=table,
                                        world_size=8, local_devices=0)
        assert plan.mode == jplan.mode == "gspmd"
        assert plan.data_size == jplan.data_size == 4
        assert plan.data_axes == jplan.data_axes
        assert tuple(plan.batch_spec()) == tuple(jplan.batch_spec())
        assert tuple(plan.batch_spec(chunked=True)) == tuple(jplan.batch_spec(chunked=True))
        assert plan.uses_model_axis == jplan.uses_model_axis
        assert plan.uses_state_sharding == jplan.uses_state_sharding
        assert plan.batch_shard == (0, 4) and not plan.capture
    mesh = parallel.make_plan_mesh((1, 4, 2), world=8)
    jmesh = jpar.make_plan_mesh((1, 4, 2))
    for rules in ([(r"kernel", (None, None, None, "data")), (r".*", ())],
                  list(jpar.PRESETS["dp"])):
        jp = jpar.ShardingPlan.gspmd(jmesh, [(p, JP(*s)) for p, s in rules], name="t")
        pp = parallel.ShardingPlan.gspmd(mesh, [(p, parallel.P(*s)) for p, s in rules],
                                         name="t")
        assert (pp.uses_state_sharding, pp.uses_model_axis) == \
            (jp.uses_state_sharding, jp.uses_model_axis)
    single = parallel.ShardingPlan.single()
    assert not single.uses_state_sharding and single.restore_shardings(None) is None
    assert str(parallel.P(None, "model")) == str(JP(None, "model"))
    assert str(parallel.P(("data", "model"))) == str(JP(("data", "model")))


def test_shard_fns_cut_each_key_to_its_block(pairs):
    """``shard_fns`` cuts a whole tensor of each state-dict key to the
    block of the rank's position (the model rules at ``1,2,2``, the rank
    at model index 1): conv kernels on out channels, the head whole."""
    _, state = pairs["lenet_adam"]
    mesh = parallel.make_plan_mesh((1, 2, 2), world=4)
    mesh.coords = (0, 1, 1)
    plan = parallel.ShardingPlan.gspmd(mesh, parallel.PRESETS["model"], name="model")
    fns = plan.shard_fns(state)
    sd = state.model.state_dict()
    assert set(fns) == set(sd)
    assert torch.equal(fns["conv1.weight"](sd["conv1.weight"]), sd["conv1.weight"][16:32])
    assert torch.equal(fns["fc3.weight"](sd["fc3.weight"]), sd["fc3.weight"][50:100])
    assert fns["fc5.weight"](sd["fc5.weight"]) is sd["fc5.weight"]
    assert fns["dn1.cov"](sd["dn1.cov"]) is sd["dn1.cov"]
    assert plan.restore_shardings is not None and plan.batch_shard == (1, 2)
    assert plan.place_replicated(state) is state    # gspmd places with place()
