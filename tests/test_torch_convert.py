"""The port's converter of the reference's PyTorch checkpoint, against ``dwt_tpu.convert.convert_resnet_state_dict``, and its CLI.

A full ResNet50-DWT state dict in the reference's key scheme is
synthesized from a seed (every key and shape of ``model_best_gr_4.pth.tar``,
with its ImageNet ``fc`` head: the table of
``tests/test_convert_fullsize.py``).  Both converters read it; every
loaded leaf must be bitwise the JAX package's (conv HWIO ↔ OIHW, dense
``[in, out]`` ↔ ``[out, in]``), the loaded and unexpected lists equal, and
the shape-mismatch list name the same keys with the same shapes up to
that layout.  Then ``python -m dwt_tpu_torch.cli.convert`` writes a
step-0 checkpoint, and the trainer starts from it with ``--init_ckpt``
(and from the archive itself with ``--resnet_path``).
"""

from __future__ import annotations

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from dwt_tpu.convert import convert_resnet_state_dict as jax_convert
from dwt_tpu.nn import ResNetDWT as JaxResNetDWT
from dwt_tpu_torch.cli import convert as convert_cli
from dwt_tpu_torch.config import OfficeHomeConfig
from dwt_tpu_torch.convert import convert_resnet_state_dict, load_pytorch_checkpoint
from dwt_tpu_torch.nn.resnet import build_resnet
from dwt_tpu_torch.train import loop
from dwt_tpu_torch.utils import checkpoint as ckpt

STAGES = {  # stage -> (planes, num_blocks, in_channels_of_block0)
    1: (64, 3, 64),
    2: (128, 4, 256),
    3: (256, 6, 512),
    4: (512, 3, 1024),
}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: the suite runs six test processes on the
    box's cores, and small models gain nothing from more."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _synth_state_dict(rng):
    """Every key of a whitened-ImageNet ResNet50 checkpoint, real shapes."""
    sd = {}

    def arr(*shape):
        return rng.normal(size=shape).astype(np.float32)

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

    for stage, (planes, blocks, in0) in STAGES.items():
        site = wh_site if stage == 1 else bn_site
        out = planes * 4
        for b in range(blocks):
            cin = in0 if b == 0 else out
            p = f"layer{stage}.{b}"
            sd[f"{p}.conv1.weight"] = arr(planes, cin, 1, 1)
            sd[f"{p}.conv2.weight"] = arr(planes, planes, 3, 3)
            sd[f"{p}.conv3.weight"] = arr(out, planes, 1, 1)
            site(f"{p}.bn1", planes)
            site(f"{p}.bn2", planes)
            site(f"{p}.bn3", out)
        sd[f"layer{stage}.0.downsample.0.weight"] = arr(out, in0, 1, 1)
        site(f"layer{stage}.0.downsample_bn", out)

    # The published checkpoint carries the ImageNet head — wrong shape for
    # the 65-class fc_out; strict=False semantics must skip-and-report it.
    sd["fc.weight"] = arr(1000, 2048)
    sd["fc.bias"] = arr(1000)
    return sd


def _write_archive(path, sd):
    torch.save({"state_dict": {f"module.{k}": torch.from_numpy(np.asarray(v))
                               for k, v in sd.items()}}, str(path))


def _jax_leaf(tree, key):
    """The JAX variables' leaf of a port state-dict key, in the port's
    layout."""
    *scope, leaf = key.split(".")
    get = lambda node, k: node[k] if isinstance(node, dict) else getattr(node, k)
    col = "params" if leaf in ("weight", "bias", "gamma", "beta") else "batch_stats"
    node = tree[col]
    for k in scope:
        node = get(node, k)
    if col == "params":
        node = get(node, {"weight": "kernel"}.get(leaf, leaf))
    else:
        node = get(get(node, "whitening" if "whitening" in node else "bn"), leaf)
    value = np.array(node)
    if leaf == "weight" and value.ndim == 4:
        return value.transpose(3, 2, 0, 1)  # HWIO → OIHW
    if leaf == "weight":
        return value.T
    return value


def test_the_port_converts_a_full_resnet50_checkpoint_as_jax(tmp_path):
    sd = _synth_state_dict(np.random.default_rng(0))
    assert len(sd) == 309
    archive = tmp_path / "model_best_gr_4.pth.tar"
    _write_archive(archive, sd)
    loaded = load_pytorch_checkpoint(str(archive))
    assert sorted(loaded) == sorted(sd)

    template = jax.eval_shape(lambda: JaxResNetDWT.resnet50(
        group_size=4, num_classes=65).init(
            jax.random.key(0), jnp.zeros((3, 1, 64, 64, 3)), train=True))
    ref_vars, ref = jax_convert(sd, dict(template), num_domains=3)
    model = build_resnet("resnet50", num_classes=65, seed=0)
    _, ours = convert_resnet_state_dict(loaded, model, num_domains=3)

    assert ours.loaded == ref.loaded and len(ours.loaded) == 307
    assert ours.skipped_unexpected == ref.skipped_unexpected
    assert [k for k, _, _ in ours.skipped_shape_mismatch] == [
        k for k, _, _ in ref.skipped_shape_mismatch] == ["fc.weight", "fc.bias"]
    for (_, got, want), (_, rgot, rwant) in zip(ours.skipped_shape_mismatch,
                                                ref.skipped_shape_mismatch):
        assert (got[::-1], want[::-1]) == (rgot, rwant)
    assert ours.summary() == ref.summary()

    state = model.state_dict()
    names = [n for n in state if not n.startswith("fc_out")]
    assert len(names) == 307  # every leaf but the head came from the dict
    for name in names:
        want = _jax_leaf(ref_vars, name)
        assert state[name].dtype == torch.from_numpy(want).dtype, name
        np.testing.assert_array_equal(state[name].numpy(), want, err_msg=name)


def _write_folders(root, rng, classes=4, per_class=2):
    for domain in ("src", "tgt"):
        for k in range(classes):
            d = root / domain / f"class_{k}"
            d.mkdir(parents=True)
            for i in range(per_class):
                arr = rng.integers(0, 256, size=(40, 44, 3), dtype=np.uint8)
                Image.fromarray(arr).save(d / f"im{i}.jpg", quality=90)


def test_the_cli_writes_a_step0_checkpoint_that_init_ckpt_trains_from(tmp_path, capsys):
    sd = _synth_state_dict(np.random.default_rng(1))
    archive = tmp_path / "model_best_gr_4.pth.tar"
    _write_archive(archive, sd)
    out = str(tmp_path / "init")
    assert convert_cli.main(["--torch_ckpt", str(archive), "--out_dir", out]) == 0
    printed = capsys.readouterr().out.splitlines()
    assert printed == ["loaded=307 unexpected=0 shape_mismatch=2",
                       f"wrote {os.path.join(out, '0')}"]
    assert ckpt.valid_steps(out) == [0]
    manifest = json.load(open(os.path.join(out, "0", ckpt.MANIFEST)))
    assert manifest["step"] == 0 and manifest["format"] == "torch_full"

    # The trainer from --init_ckpt: the converted weights, step 0.
    cfg = OfficeHomeConfig(synthetic=True, arch="resnet50", num_classes=65,
                           img_crop_size=32, source_batch_size=2,
                           synthetic_size=4, num_iters=1, check_acc_step=1,
                           stat_collection_passes=0, log_interval=1,
                           num_workers=0, init_ckpt=out, device="cpu")
    model = loop.build_model(cfg)
    seen = []

    def logger(kind, step, **fields):
        if kind == "init_ckpt":
            seen.append(torch.equal(model.layer3_2.conv2.weight,
                                    torch.from_numpy(sd["layer3.2.conv2.weight"])))
        seen.append((kind, step))

    loop.run_officehome(cfg, logger, model=model)
    assert seen == [True, ("init_ckpt", 0), ("train", 1), ("test", 1),
                    ("stat_collection", 1), ("final_test", 1)]

    # --resnet_path converts the archive inline when the run reads image
    # folders.  The tiny model (one block per stage) takes the keys it has:
    # the stem's 5, stage 1's 20 and stages 2-4's 24 each.
    _write_folders(tmp_path, np.random.default_rng(0))
    cfg = OfficeHomeConfig(s_dset_path=str(tmp_path / "src"),
                           t_dset_path=str(tmp_path / "tgt"), arch="tiny",
                           num_classes=4, img_resize=36, img_crop_size=32,
                           source_batch_size=4, num_iters=1, check_acc_step=1,
                           stat_collection_passes=0, num_workers=0,
                           resnet_path=str(archive), device="cpu")
    model = loop.build_model(cfg)
    records = []
    loop.run_officehome(cfg, lambda kind, step, **f: records.append(
        (kind, f.get("detail"))), model=model)
    assert records[0] == ("checkpoint_convert",
                          "loaded=97 unexpected=210 shape_mismatch=2")
    cfg.resnet_path = str(tmp_path / "absent.pth.tar")
    records.clear()
    loop.run_officehome(cfg, lambda kind, step, **f: records.append(
        (kind, f.get("detail"))), model=loop.build_model(cfg))
    assert records[0] == ("checkpoint_convert",
                          "resnet_path missing; training from fresh init")
