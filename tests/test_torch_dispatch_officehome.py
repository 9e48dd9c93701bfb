"""The tiny OfficeHome trainer at k steps per dispatch on the CPU, against the live JAX loop with the same flags (``test_torch_dispatch.py`` holds the rest)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from dwt_tpu.config import OfficeHomeConfig as JaxOfficeHomeConfig
from dwt_tpu.nn import ResNetDWT as JaxResNetDWT
from dwt_tpu.train import loop as jax_loop
from dwt_tpu_torch.config import OfficeHomeConfig
from dwt_tpu_torch.convert import load_jax_variables
from dwt_tpu_torch.nn import ResNetDWT
from dwt_tpu_torch.train import loop
from test_torch_dispatch import _compare, _Records


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _write_folders(root, rng, classes=4, per_class=4):
    for domain in ("src", "tgt"):
        for k in range(classes):
            d = root / domain / f"class_{k}"
            d.mkdir(parents=True)
            for i in range(per_class):
                h, w = rng.integers(36, 60, size=2)
                arr = rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)
                arr[: h // 4] = 60 * k  # a class signal
                Image.fromarray(arr).save(d / f"im{i}.jpg", quality=90)


def test_officehome_chunked_and_harvested_matches_the_jax_loop(tmp_path):
    """The tiny ResNet-DWT from image folders (the two packages' batches
    bitwise equal), 2 steps in one chunk (cut at the eval), an eval, a
    collection pass: JAX's records.  Two steps, as the per-step comparison
    in tests/test_torch_data_plane.py: at 8 images per stream the tiny
    model amplifies rounding (ROADMAP queue 3 item 5) — the port's
    per-step loop sits 2.4e-5 from JAX's at step 2 and 1.4e-3 at step 3,
    with or without chunks."""
    _write_folders(tmp_path, np.random.default_rng(0))
    flags = dict(s_dset_path=str(tmp_path / "src"), t_dset_path=str(tmp_path / "tgt"),
                 arch="tiny", num_classes=4, img_resize=36, img_crop_size=32,
                 source_batch_size=8, test_batch_size=10, num_iters=2,
                 check_acc_step=2, stat_collection_passes=1, log_interval=1,
                 num_workers=2, seed=1, steps_per_dispatch=3, harvest_depth=2)
    ref = _Records()
    jax_loop.run_officehome(JaxOfficeHomeConfig(**flags, resnet_path=""), ref)
    variables = jax.jit(lambda k: JaxResNetDWT(stage_sizes=(1, 1, 1, 1),
                                               num_classes=4).init(
        k, jnp.zeros((3, 8, 32, 32, 3)), train=True))(jax.random.key(1))
    model = load_jax_variables(ResNetDWT.tiny(num_classes=4),
                               jax.tree.map(np.asarray, variables["params"]),
                               jax.tree.map(np.asarray, variables["batch_stats"]))
    ours = []
    loop.run_officehome(OfficeHomeConfig(**flags, resnet_path="", device="cpu"),
                        lambda kind, step, **f: ours.append((kind, step, f)),
                        model=model)
    assert [k for k, _, _ in ours] == ["train"] * 2 + ["test", "stat_collection",
                                                       "final_test", "params_digest"]
    _compare(ours, ref.records, ("cls_loss", "mec_loss"))
