"""The port's backbone registry (``dwt_tpu_torch.nn.registry``) and what goes through it, against the live JAX package.

* the registry: the names of ``dwt_tpu.nn.BACKBONES``, one keyword
  surface for every entry, the unknown-name message, ``register_backbone``
  (a stub reaches the trainer through ``--backbone``), ResNet101/152's
  stage sizes and a JAX ResNet101 parameter tree loaded leaf for leaf;
* ``pad_classes_to``: a padded head's logits, eval counters and losses
  bitwise the unpadded head's with the same weights, and JAX's padded
  model's eval logits;
* the helpers that run a port CLI against the JAX loop from the same
  initial state (``_run_both``), for ``tests/test_torch_visda.py`` and
  ``tests/test_torch_vit.py``;
* the server's ``--model`` choices against the JAX server's, and
  ``resnet101`` built through the registry;
* the reference converter on a ResNet101 target, against JAX's
  (``strict=False`` semantics, a ResNet101 archive and a ResNet50 one),
  and ``cli/convert.py --arch resnet101`` round-tripping.

Tolerances: records as ``tests/test_torch_dispatch.py`` holds them
(losses ``rtol = 1e-4``, eval losses ``1e-2``, accuracies and counts
exact); the f32 eval logits ``rtol = atol = 1e-4``; converted weights
bitwise.
"""

from __future__ import annotations

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dwt_tpu.cli import officehome as jax_officehome_cli
from dwt_tpu.convert import convert_resnet_state_dict as jax_convert
from dwt_tpu.nn import BACKBONES as JAX_BACKBONES
from dwt_tpu.nn import ResNetDWT as JaxResNetDWT
from dwt_tpu.train import loop as jax_loop
from dwt_tpu.train import steps as jsteps
from dwt_tpu.train.evalpipe import make_whiten_cache_fn
from dwt_tpu_torch.cli import convert as convert_cli
from dwt_tpu_torch.config import OfficeHomeConfig
from dwt_tpu_torch.convert import (
    convert_resnet_state_dict,
    load_jax_variables,
    load_pytorch_checkpoint,
)
from dwt_tpu_torch.nn import (
    BACKBONES,
    DomainWhiten,
    ResNetDWT,
    ViTDWT,
    build_backbone,
    register_backbone,
)
from dwt_tpu_torch.nn.resnet import build_resnet
from dwt_tpu_torch.train import loop, steps
from dwt_tpu_torch.train.evalpipe import install_whiten_cache, make_whiten_cache
from dwt_tpu_torch.train.optim import officehome_tx
from dwt_tpu_torch.train.state import TrainState
from dwt_tpu_torch.utils import checkpoint as ckpt
from test_torch_dispatch import _compare, _Records

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------- registry


def test_registry_names_are_jax_names():
    assert sorted(BACKBONES) == sorted(JAX_BACKBONES) == [
        "resnet101", "resnet152", "resnet50", "tiny", "vit_dwt", "vit_tiny"]


@pytest.mark.parametrize("name", sorted(BACKBONES))
def test_every_entry_takes_the_loop_kwargs(name):
    """The keyword surface the trainer passes, every knob visible on the
    built model; a seed gives fresh weights, the same seed the same."""
    kw = dict(num_classes=12, group_size=8, momentum=0.2, dtype=torch.bfloat16,
              whitener="swbn", remat=True, pad_classes_to=16, image_size=32, seed=5)
    model = build_backbone(name, **kw)
    assert isinstance(model, ViTDWT if name.startswith("vit") else ResNetDWT)
    assert (model.fc_out.out_features, model.num_classes) == (16, 12)
    assert model.dtype is torch.bfloat16 and model.remat
    sites = [m for m in model.modules() if isinstance(m, DomainWhiten)]
    assert sites and all((s.whitener, s.momentum, s.group_size) == ("swbn", 0.2, 8)
                         for s in sites)
    if name == "vit_tiny":  # the cheap one: determinism by seed
        again = build_backbone(name, **kw).state_dict()
        assert all(torch.equal(v, again[k]) for k, v in model.state_dict().items())


def test_unknown_backbone_lists_the_registered_ones():
    with pytest.raises(ValueError, match="unknown backbone 'vit_huge'; registered: "
                       "resnet101, resnet152, resnet50, tiny, vit_dwt, vit_tiny"):
        build_backbone("vit_huge")
    with pytest.raises(ValueError, match="is not a ResNet"):
        build_resnet("vit_tiny")


def test_a_registered_stub_reaches_the_trainer():
    """``register_backbone`` adds an entry; the trainer's ``build_model``
    builds it by ``backbone`` with the loop's kwargs, and ``backbone``
    wins over ``arch``."""
    seen = {}

    def stub(**kw):
        seen.update(kw)
        return build_backbone("vit_tiny", **kw)

    register_backbone("test_stub", stub)
    try:
        cfg = OfficeHomeConfig(backbone="test_stub", arch="resnet50", num_classes=4,
                               img_crop_size=16, pad_classes_to=8, seed=3)
        model = loop.build_model(cfg)
    finally:
        del BACKBONES["test_stub"]
    assert isinstance(model, ViTDWT) and model.fc_out.out_features == 8
    assert seen == dict(num_classes=4, group_size=4, seed=3, momentum=0.1, dtype=None,
                        whitener="cholesky", remat=False, pad_classes_to=8,
                        image_size=16)
    assert isinstance(loop.build_model(OfficeHomeConfig(arch="tiny")), ResNetDWT)


@pytest.mark.parametrize("name,stages", [("resnet101", (3, 4, 23, 3)),
                                         ("resnet152", (3, 8, 36, 3))])
def test_deep_resnets_have_jax_stage_sizes(name, stages):
    port = build_backbone(name)
    assert port.stage_sizes == getattr(JaxResNetDWT, name)().stage_sizes == stages
    assert len(list(port.blocks())) == sum(stages)
    # Only the stem and stage 1 whiten: 11 sites, as ResNet50.
    assert sum(isinstance(m, DomainWhiten) for m in port.modules()) == 11


def _numpy_tree(shapes, rng):
    """Arrays of a JAX variables tree's shapes: SPD covariances, positive
    variances, normal draws elsewhere."""
    def leaf(path, s):
        name = getattr(path[-1], "name", str(path[-1]))
        if name == "cov":
            m = rng.standard_normal(s.shape, dtype=np.float32)
            return m @ np.swapaxes(m, -1, -2) / 4 + 0.5 * np.eye(4, dtype=np.float32)
        if name == "var":
            return rng.uniform(0.5, 2.0, size=s.shape).astype(np.float32)
        if name == "count":
            return np.full(s.shape, 2, s.dtype)
        return rng.standard_normal(s.shape, dtype=np.float32) * 0.05
    return jax.tree_util.tree_map_with_path(leaf, shapes)


@pytest.fixture(scope="module")
def resnet101_template():
    """The JAX ResNet101's variables as shapes (``jax.eval_shape``: traced,
    not run; the shapes do not depend on the image size)."""
    return jax.eval_shape(lambda: JaxResNetDWT.resnet101(num_classes=12).init(
        jax.random.key(0), jnp.zeros((3, 1, 32, 32, 3)), train=True))


def test_a_jax_resnet101_tree_loads_leaf_for_leaf(resnet101_template):
    variables = _numpy_tree(resnet101_template, np.random.default_rng(0))
    port = load_jax_variables(build_backbone("resnet101", num_classes=12),
                              variables["params"], variables["batch_stats"])
    np.testing.assert_array_equal(
        port.layer3_22.conv2.weight.detach().numpy(),
        variables["params"]["layer3_22"]["conv2"]["kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(port.layer1_2.dn3.cov.numpy(),
                                  variables["batch_stats"]["layer1_2"]["dn3"]["whitening"].cov)
    short = copy.deepcopy(variables)
    del short["params"]["layer3_22"]
    with pytest.raises(KeyError, match="layer3_22"):
        load_jax_variables(build_backbone("resnet101", num_classes=12),
                           short["params"], short["batch_stats"])
    with pytest.raises(ValueError, match="match no module"):
        load_jax_variables(build_backbone("resnet50", num_classes=12),
                           variables["params"], variables["batch_stats"])


# ---------------------------------------------------------- pad_classes_to


def _padded_twin(model, name, **kw):
    padded = build_backbone(name, pad_classes_to=4, **kw)
    state = padded.state_dict()
    for k, v in model.state_dict().items():
        if k.startswith("fc_out"):
            state[k][: v.shape[0]] = v
        else:
            state[k].copy_(v)
    padded.load_state_dict(state)
    return padded.to(memory_format=torch.channels_last)


def test_padded_resnet_head_is_the_unpadded_head_bitwise():
    """The tiny ResNet at 5 classes padded to 8: train logits, eval
    counters (a masked batch) and a train step's losses bitwise those of
    the unpadded head; eval logits within f32 of JAX's padded model."""
    kw = dict(num_classes=5, seed=0)
    plain = build_backbone("tiny", **kw).to(memory_format=torch.channels_last)
    padded = _padded_twin(plain, "tiny", **kw)
    assert padded.fc_out.out_features == 8
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(3, 8, 32, 32, 3)).astype(np.float32))
    with torch.no_grad():
        assert torch.equal(plain.train()(x), padded.train()(x))
    batch = {"source_x": x[0], "source_y": torch.from_numpy(rng.integers(0, 5, 8)),
             "target_x": x[1], "target_aug_x": x[2]}
    metrics, counters = [], []
    eval_batch = {"x": x[0][None], "y": batch["source_y"][None],
                  "mask": torch.tensor([[True] * 6 + [False] * 2])}
    for m in (copy.deepcopy(plain), copy.deepcopy(padded)):
        optimizer, schedules = officehome_tx(m, OfficeHomeConfig())
        metrics.append(steps.make_officehome_train_step(m, 0.1)(
            TrainState(m, optimizer, schedules), batch))
        install_whiten_cache(m, make_whiten_cache(m))
        counters.append(steps.make_accum_eval_step(m)(
            steps.eval_counters(torch.device("cpu")), eval_batch))
    assert all(float(metrics[0][k]) == float(metrics[1][k]) for k in metrics[0])
    assert all(torch.equal(counters[0][k], counters[1][k]) for k in counters[0])

    jmodel = JaxResNetDWT(stage_sizes=(1, 1, 1, 1), num_classes=5, pad_classes_to=4)
    variables = _numpy_tree(jax.eval_shape(lambda: jmodel.init(
        jax.random.key(2), jnp.zeros((3, 1, 32, 32, 3)), train=True)),
        np.random.default_rng(2))
    params, stats = variables["params"], variables["batch_stats"]
    assert params["fc_out"]["kernel"].shape == (2048, 8)
    port = load_jax_variables(build_backbone("tiny", num_classes=5, pad_classes_to=4),
                              params, stats).to(memory_format=torch.channels_last).eval()
    ref = jax.jit(jsteps.make_serve_forward(jmodel))(
        params, stats, make_whiten_cache_fn("cholesky")(stats), x[0].numpy())
    install_whiten_cache(port, make_whiten_cache(port))
    with torch.no_grad():
        ours = port(x[0]).numpy()
    assert ours.shape == (8, 5)
    scale = np.abs(np.asarray(ref)).max()
    assert np.abs(ours - np.asarray(ref)).max() <= TOL["rtol"] * scale


# -------------------------------------------------------------------- CLIs


def _jax_config(parser, argv):
    return jax_officehome_cli.config_from_args(parser.parse_args(argv))


def _jax_init(jmodel, cfg):
    """The JAX loop's initial variables: ``model.init`` at the run's seed
    on a zero train batch."""
    size, bs = cfg.img_crop_size, cfg.source_batch_size
    return jax.jit(lambda k: jmodel.init(k, jnp.zeros((3, bs, size, size, 3)),
                                         train=True))(jax.random.key(cfg.seed))


def _run_both(jax_cfg, port_cfg, port_model):
    """Both loops from the same initial state: the port's records of
    ``RECORD_KINDS`` are the JAX loop's (2 steps, an eval, a collection
    pass, the final eval)."""
    ref = _Records()
    jax_loop.run_officehome(jax_cfg, ref)
    ours = []
    loop.run_officehome(port_cfg, lambda kind, step, **f: ours.append((kind, step, f)),
                        model=port_model)
    ours = [r for r in ours if r[0] in RECORD_KINDS]
    assert [k for k, _, _ in ours] == ["train"] * 2 + ["test", "stat_collection",
                                                       "final_test"]
    _compare(ours, ref.records, ("cls_loss", "mec_loss"))


RUN = ["--synthetic", "--source_batch_size", "8", "--num_iters", "2",
       "--check_acc_step", "2", "--stat_collection_passes", "1", "--log_interval", "1",
       "--seed", "1"]
# The records both loops write (the port's checkpoint bookkeeping aside).
RECORD_KINDS = ("train", "test", "stat_collection", "final_test")


# ---------------------------------------------------------------- convert


def _reference_state_dict(blocks, rng, head=(1000, 2048)):
    """Every key of a reference-scheme ResNet-DWT state dict with
    ``blocks`` bottlenecks per stage (the table of
    ``tests/test_torch_convert.py``), real shapes, the ImageNet head."""
    sd = {}
    arr = lambda *shape: rng.standard_normal(shape, dtype=np.float32)

    def wh_site(prefix, c):
        sd[f"{prefix}.wh.running_mean"] = arr(1, c, 1, 1)
        sd[f"{prefix}.wh.running_variance"] = arr(c // 4, 4, 4)
        sd[f"{prefix}.gamma"] = arr(c, 1, 1)
        sd[f"{prefix}.beta"] = arr(c, 1, 1)

    def bn_site(prefix, c):
        sd[f"{prefix}.running_mean"] = arr(c)
        sd[f"{prefix}.running_var"] = np.abs(arr(c)) + 0.5
        sd[f"{prefix}.weight"] = arr(c)
        sd[f"{prefix}.bias"] = arr(c)
        sd[f"{prefix}.num_batches_tracked"] = np.asarray(1000, np.int64)

    sd["conv1.weight"] = arr(64, 3, 7, 7)
    wh_site("bn1", 64)
    cin = 64
    for stage, n in enumerate(blocks, start=1):
        site = wh_site if stage == 1 else bn_site
        planes = 64 * 2 ** (stage - 1)
        out = planes * 4
        for b in range(n):
            p = f"layer{stage}.{b}"
            sd[f"{p}.conv1.weight"] = arr(planes, cin if b == 0 else out, 1, 1)
            sd[f"{p}.conv2.weight"] = arr(planes, planes, 3, 3)
            sd[f"{p}.conv3.weight"] = arr(out, planes, 1, 1)
            for k, c in ((1, planes), (2, planes), (3, out)):
                site(f"{p}.bn{k}", c)
        sd[f"layer{stage}.0.downsample.0.weight"] = arr(out, cin, 1, 1)
        site(f"layer{stage}.0.downsample_bn", out)
        cin = out
    sd["fc.weight"] = arr(*head)
    sd["fc.bias"] = arr(head[0])
    return sd


def _report(r):
    return (r.loaded, r.skipped_unexpected,
            [(k, tuple(sorted(a)), tuple(sorted(b))) for k, a, b in r.skipped_shape_mismatch])


@pytest.mark.parametrize("blocks", [(3, 4, 23, 3), (3, 4, 6, 3)],
                         ids=["resnet101_archive", "resnet50_archive"])
def test_converter_on_a_resnet101_target_reports_as_jax(blocks, resnet101_template):
    """``strict=False`` semantics on a ResNet101: a ResNet101 archive
    loads but its ImageNet head; a ResNet50 archive loads everything it
    has (its stage 3 is the first 6 of 23 blocks) and leaves the rest at
    fresh init — both converters report the same keys."""
    sd = _reference_state_dict(blocks, np.random.default_rng(0))
    _, ref = jax_convert(sd, dict(resnet101_template), num_domains=3)
    model = build_backbone("resnet101", num_classes=12, seed=0)
    fresh = model.layer3_6.conv2.weight.detach().clone()
    _, ours = convert_resnet_state_dict({k: torch.from_numpy(np.asarray(v))
                                         for k, v in sd.items()}, model, num_domains=3)
    assert _report(ours) == _report(ref)
    assert ours.skipped_unexpected == [] and len(ours.loaded) == len(sd) - 2
    torch.testing.assert_close(model.layer3_5.conv2.weight,
                               torch.from_numpy(sd["layer3.5.conv2.weight"]),
                               rtol=0, atol=0)
    assert torch.equal(model.layer3_6.conv2.weight, fresh) == (blocks[2] == 6)


def test_convert_cli_round_trips_a_resnet101_archive(tmp_path):
    sd = _reference_state_dict((3, 4, 23, 3), np.random.default_rng(1), head=(12, 2048))
    archive = tmp_path / "resnet101.pth.tar"
    torch.save({"state_dict": {f"module.{k}": torch.from_numpy(np.asarray(v))
                               for k, v in sd.items()}}, str(archive))
    out = str(tmp_path / "ckpt")
    assert convert_cli.main(["--torch_ckpt", str(archive), "--out_dir", out,
                             "--arch", "resnet101", "--num_classes", "12"]) == 0
    model = build_backbone("resnet101", num_classes=12)
    state = TrainState(model, *officehome_tx(model, OfficeHomeConfig()))
    assert ckpt.restore_state(out, state).step == 0
    loaded = load_pytorch_checkpoint(str(archive))
    assert torch.equal(model.layer3_22.conv3.weight, loaded["layer3.22.conv3.weight"])
    assert torch.equal(model.fc_out.weight, loaded["fc.weight"])
    assert torch.equal(model.layer4_0.downsample_dn.var[2],
                       loaded["layer4.0.downsample_bn.running_var"])


def test_server_offers_the_jax_servers_models():
    """``--model`` takes the JAX server's choices (``resnet101`` among
    them, no ViT); ``resnet101`` builds through the registry."""
    from dwt_tpu.serve import server as jax_server
    from dwt_tpu_torch.serve import server

    def choices(parser):
        return sorted(next(a.choices for a in parser._actions if a.dest == "model"))

    assert choices(server.build_parser()) == choices(jax_server.build_parser()) == [
        "lenet", "resnet101", "resnet50", "tiny"]
    model, shape = server.build_model(server.build_parser().parse_args(
        ["--model", "resnet101", "--num_classes", "12", "--init_random", "--device", "cpu"]))
    assert isinstance(model, ResNetDWT) and model.stage_sizes == (3, 4, 23, 3)
    assert model.fc_out.out_features == 12 and shape == (224, 224, 3)
