"""Port parity: a bf16 train step of the tiny ResNet-DWT against the live JAX package.

The tiny ResNet-DWT (one block per stage, full widths, 4 images per stream
at 32², 5 classes), built with ``dtype`` bf16 on both sides, tied through
the weight bridge from JAX's init with perturbed affines and randomized
running stats (``test_torch_bf16_models.py``'s helpers): one OfficeHome
step (MEC, two-group SGD) — its losses and every updated running stat
within JAX's bf16 tolerance ``rtol = atol = 2e-2`` of JAX's bf16 step, its
train-mode logits within the spread bf16 itself adds, its parameters,
gradients and SGD momentum f32.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from dwt_tpu.config import OfficeHomeConfig as JaxOfficeHomeConfig
from dwt_tpu.nn import ResNetDWT as JaxResNetDWT
from dwt_tpu.train import steps as jsteps
from dwt_tpu.train.optim import officehome_tx as jax_officehome_tx
from dwt_tpu.train.state import TrainState as JaxTrainState
from dwt_tpu_torch.config import OfficeHomeConfig
from dwt_tpu_torch.convert import load_jax_variables
from dwt_tpu_torch.nn import ResNetDWT
from dwt_tpu_torch.train import steps
from dwt_tpu_torch.train.optim import officehome_tx
from dwt_tpu_torch.train.state import TrainState
from test_torch_bf16_models import (
    BF16,
    TOL,
    _assert_f32_state,
    _assert_stats_match,
    _jax_train_logits,
    _few_threads,  # noqa: F401  (the module's fixture)
    _tie,
    _within_bf16_spread,
)


def test_tiny_resnet_bf16_step_matches_jax():
    """One bf16 OfficeHome step of the tiny ResNet-DWT (MEC, two-group
    SGD) from tied weights: train logits, losses and every updated stat."""
    n, size, classes = 4, 32, 5
    jax_model = JaxResNetDWT(stage_sizes=(1, 1, 1, 1), num_classes=classes,
                             dtype=jnp.bfloat16)
    params, stats, port = _tie(jax_model, ResNetDWT.tiny(num_classes=classes, dtype=BF16),
                               jnp.zeros((3, n, size, size, 3)))
    rng = np.random.default_rng(2)
    img = lambda: rng.normal(size=(n, size, size, 3)).astype(np.float32)
    batch = {"source_x": img(), "source_y": rng.integers(0, classes, size=n),
             "target_x": img(), "target_aug_x": img()}
    x = np.stack([batch["source_x"], batch["target_x"], batch["target_aug_x"]])
    logits_ref, ref_f32 = (_jax_train_logits(jax_model.clone(dtype=dt), params, stats, x)
                           for dt in (jnp.bfloat16, jnp.float32))
    twin = ResNetDWT.tiny(num_classes=classes, dtype=BF16).train()
    load_jax_variables(twin, params, stats)
    with torch.no_grad():
        logits = twin.to(memory_format=torch.channels_last)(torch.from_numpy(x))
    _within_bf16_spread(logits.float().numpy(), np.asarray(logits_ref, np.float32),
                        np.asarray(ref_f32))

    tx = jax_officehome_tx(JaxOfficeHomeConfig())
    jparams = jax.tree.map(jnp.asarray, params)
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=jparams,
                           batch_stats=jax.tree.map(jnp.asarray, stats),
                           opt_state=tx.init(jparams))
    new_jax, ref = jax.jit(jsteps.make_officehome_train_step(jax_model, tx, 0.1))(
        jstate, jax.tree.map(jnp.asarray, batch))
    optimizer, schedules = officehome_tx(port, OfficeHomeConfig())
    state = TrainState(port, optimizer, schedules)
    metrics = steps.make_officehome_train_step(port, 0.1)(
        state, {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()})
    for key in ("loss", "cls_loss", "mec_loss"):
        np.testing.assert_allclose(float(metrics[key]), float(ref[key]), err_msg=key, **TOL)
    after = ResNetDWT.tiny(num_classes=classes)
    load_jax_variables(after, jax.tree.map(np.asarray, new_jax.params),
                       jax.tree.map(np.asarray, new_jax.batch_stats))
    _assert_stats_match(port, after)
    _assert_f32_state(state)
