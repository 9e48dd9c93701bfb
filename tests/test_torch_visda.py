"""The port's VisDA-2017 entry point (``dwt_tpu_torch.cli.visda``) against
the live JAX package's (``dwt_tpu.cli.visda``).

* the CLI on the CPU (``python -m dwt_tpu_torch.cli.visda --arch tiny``
  at 48², 8 images per stream: at 32² the tiny model's stage 4 is 1×1,
  its BN sees 8 samples a domain, and its step-2 losses drift 1.6e-4 (8
  images) and 2.6e-4 (16 images) from JAX's; at 48² stage 4 is 2×2 and
  they sit within 1e-5): 2 steps, an eval, a collection pass, against the
  JAX VisDA CLI's records from the same initial state
  (``tests/test_torch_vit.py`` does the same for ``--backbone vit_tiny``);
* the parser's defaults against ``dwt_tpu.cli.visda``'s.

Tolerances: records as ``tests/test_torch_dispatch.py`` holds them
(losses ``rtol = 1e-4``, eval losses ``1e-2``, accuracies and counts
exact).  Its own file beside ``tests/test_torch_backbones.py``: the JAX
loop's compiles take most of a minute.
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch

from dwt_tpu.cli import visda as jax_visda_cli
from dwt_tpu.nn import ResNetDWT as JaxResNetDWT
from dwt_tpu_torch.cli import officehome, visda
from dwt_tpu_torch.config import OfficeHomeConfig
from dwt_tpu_torch.convert import load_jax_variables
from dwt_tpu_torch.nn import ResNetDWT
from test_torch_backbones import RUN, _jax_config, _jax_init, _run_both


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def test_visda_cli_trains_as_the_jax_loop():
    """``python -m dwt_tpu_torch.cli.visda --arch tiny``: VisDA's 12
    classes and the OfficeHome recipe, records equal to the JAX VisDA
    CLI's."""
    argv = RUN + ["--arch", "tiny", "--img_crop_size", "48"]
    jax_cfg = _jax_config(jax_visda_cli.build_parser(), argv)
    port_cfg = officehome.config_from_args(visda.build_parser().parse_args(
        argv + ["--device", "cpu"]))
    assert (port_cfg.num_classes, port_cfg.arch) == (jax_cfg.num_classes, jax_cfg.arch) \
        == (12, "tiny")
    variables = _jax_init(JaxResNetDWT(stage_sizes=(1, 1, 1, 1), num_classes=12), jax_cfg)
    model = load_jax_variables(ResNetDWT.tiny(num_classes=12),
                               jax.tree.map(np.asarray, variables["params"]),
                               jax.tree.map(np.asarray, variables["batch_stats"]))
    _run_both(jax_cfg, port_cfg, model)


def test_visda_parser_defaults_are_jax_visda_defaults():
    """Every flag both parsers have defaults alike, VisDA's own among
    them; ``--arch`` and ``--backbone`` take the JAX parser's choices."""
    ours, ref = visda.build_parser(), jax_visda_cli.build_parser()
    theirs = {a.dest: a for a in ref._actions}
    shared = [a for a in ours._actions if a.dest in theirs and a.dest != "help"]
    assert len(shared) > 40
    for action in shared:
        assert action.default == theirs[action.dest].default, action.dest
        assert action.choices == theirs[action.dest].choices, action.dest
    d = ours.parse_args([])
    assert (d.arch, d.num_classes, d.resnet_path) == ("resnet101", 12, "")
    assert (d.s_dset_path, d.t_dset_path) == ("../data/visda-2017/train",
                                              "../data/visda-2017/validation")
    fields = {f.name for f in dataclasses.fields(OfficeHomeConfig)}
    assert {"backbone", "pad_classes_to"} <= fields
    assert officehome.build_parser().parse_args([]).arch == "resnet50"
