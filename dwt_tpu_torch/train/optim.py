"""Optimizers and schedules of the two recipes — the port of ``dwt_tpu.train.optim``.

The reference's ``weight_decay`` is classic L2 (added to the gradient
before the moments), which ``torch.optim.SGD`` and ``torch.optim.Adam`` do
by themselves:

* OfficeHome: SGD with momentum 0.9, dampening 0 and no Nesterov is the
  optax chain ``add_decayed_weights → trace → scale_by_learning_rate`` of
  the JAX package.  optax's ``trace`` starts from zeros, so its first step
  moves by ``g``; torch's momentum buffer starts at ``g``: the two agree.
* Digits: Adam (β = 0.9, 0.999, ε = 1e-8, bias-corrected) is the chain
  ``add_decayed_weights → scale_by_adam → scale_by_learning_rate``.

The JAX package wraps the chain in ``with_lr_backoff``: a global scale
on the final update, which only the divergence guard's ``lr_backoff`` rung
moves off 1.0.  Here the scale is ``TrainState.lr_scale``, and
:func:`set_learning_rates` multiplies every group's scheduled lr by it.
For these two optimizers that is the same thing: SGD's momentum buffer
and Adam's moments are computed from the (L2-decayed) gradient alone and
the lr only multiplies the final update, so ``lr · s`` moves every
parameter by ``s`` times the update at ``lr``, as optax's
``scale_by_backoff`` does.  At ``s = 1.0`` the lr is the schedule's,
bit for bit.

On the card every group's lr is a 0-d float32 tensor on the device, and
both optimizers read it there: SGD through its fused kernel
(``fused=True``), Adam ``capturable`` (its step count a device tensor
too).  A Python-float lr would be a kernel argument frozen when a CUDA
graph captures the step, so a replayed step would run the capture's lr
forever, across a milestone or a backoff; SGD's ``foreach`` path reads a
tensor lr with ``.item()``, which no capture takes.  Eager and replayed
steps on the card run this one update rule, so k replayed steps are
bitwise k eager steps.  :func:`set_learning_rates` writes the device lr
(one small launch, only when the value changes) and keeps its value on
the host in the group's ``lr_host``.  On the CPU the lrs stay floats and
the optimizers their default paths.
"""

from __future__ import annotations

from typing import Callable, Sequence, Tuple

import torch
from torch import nn

Schedule = Callable[[int], float]


def multistep_schedule(
    base_lr: float,
    milestones: Sequence[int],
    gamma: float = 0.1,
    pre_step: bool = True,
    scale: int = 1,
) -> Schedule:
    """torch ``MultiStepLR`` as a plain function of the optimizer step.

    The reference calls ``scheduler.step()`` BEFORE each iteration, which
    shifts every decay one unit early; ``pre_step=True`` reproduces that
    lr sequence, as the JAX package's schedule does: the lr at step ``s``
    is ``base_lr · gamma^k``, ``k`` the number of boundaries
    ``(m − 1)·scale ≤ s``.
    """
    shift = 1 if pre_step else 0
    boundaries = sorted({max(m - shift, 0) * scale for m in milestones})

    def schedule(step: int) -> float:
        return base_lr * gamma ** sum(step >= b for b in boundaries)

    return schedule


def _lr(device: torch.device):
    """A param group's initial lr: a device tensor on the card, else 0.0
    (the module docstring); :func:`set_learning_rates` sets it per step."""
    if device.type == "cuda":
        return torch.zeros((), dtype=torch.float32, device=device)
    return 0.0


def sgd_two_group(
    model: nn.Module,
    momentum: float = 0.9,
    weight_decay: float = 5e-4,
    head_key: str = "fc_out",
) -> torch.optim.SGD:
    """SGD with the reference's two param groups: group 0 is the
    ``head_key`` submodule's parameters, group 1 everything else.  Every
    parameter decays, norm affines and the head bias included.  The
    learning rates are set per step (:func:`set_learning_rates`)."""
    head, backbone = [], []
    for name, p in model.named_parameters():
        (head if name.split(".")[0] == head_key else backbone).append(p)
    device = next(model.parameters()).device
    # Each group its own lr (a device tensor on the card, not one shared).
    return torch.optim.SGD(
        [{"params": head, "lr": _lr(device)}, {"params": backbone, "lr": _lr(device)}],
        momentum=momentum, dampening=0.0,
        weight_decay=weight_decay, nesterov=False,
        **({"fused": True} if device.type == "cuda" else {}),
    )


def officehome_tx(model: nn.Module, cfg) -> Tuple[torch.optim.SGD,
                                                   Tuple[Schedule, Schedule]]:
    """The OfficeHome optimizer: two-group SGD and its two multistep
    schedules, the head at ``lr`` and the rest at ``lr·backbone_lr_scale``."""
    schedules = (
        multistep_schedule(cfg.lr, cfg.lr_milestones, cfg.lr_gamma),
        multistep_schedule(cfg.lr * cfg.backbone_lr_scale, cfg.lr_milestones,
                           cfg.lr_gamma),
    )
    return sgd_two_group(model, cfg.sgd_momentum, cfg.weight_decay), schedules


def adam_l2(model: nn.Module, weight_decay: float = 5e-4) -> torch.optim.Adam:
    """Adam with torch-style L2 weight decay on every parameter (the digits
    recipe, ``usps_mnist.py:389``: Adam(lr=1e-3, weight_decay=5e-4)); one
    param group, its lr set per step (:func:`set_learning_rates`)."""
    device = next(model.parameters()).device
    return torch.optim.Adam(model.parameters(), lr=_lr(device), betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=weight_decay,
                            **({"capturable": True, "foreach": True}
                               if device.type == "cuda" else {}))


def digits_tx(model: nn.Module, cfg, steps_per_epoch: int
              ) -> Tuple[torch.optim.Adam, Tuple[Schedule]]:
    """The digits optimizer: Adam with L2 and its multistep schedule, the
    epoch milestones converted to steps (decays at ``(m − 1)·
    steps_per_epoch``, the reference's pre-step quirk)."""
    schedule = multistep_schedule(cfg.lr, cfg.lr_milestones, cfg.lr_gamma,
                                  scale=steps_per_epoch)
    return adam_l2(model, cfg.weight_decay), (schedule,)


def grads_in_param_dtype(model: nn.Module) -> None:
    """Each gradient cast to its parameter's dtype before the optimizer
    reads it — the JAX package's ``--compute_dtype bf16`` contract: the
    parameters, and so the optimizer's moments, stay f32, and a
    reduced-precision gradient widens before the moments, not inside them.
    Autograd already returns the gradient of a cast f32 parameter in f32,
    so this is an identity in the port's models; kept as the contract's
    one place."""
    for p in model.parameters():
        if p.grad is not None and p.grad.dtype != p.dtype:
            p.grad = p.grad.to(p.dtype)


def set_learning_rates(
    optimizer: torch.optim.Optimizer, schedules: Sequence[Schedule], step: int,
    scale: float = 1.0,
) -> None:
    """Set each param group's lr from its schedule at ``step``, times the
    guard's backoff ``scale`` (1.0: the schedule's lr unchanged).  A device
    lr is written in place, on the current stream, when its host value
    ``lr_host`` changes."""
    for group, schedule in zip(optimizer.param_groups, schedules, strict=True):
        lr = schedule(step) * scale
        if not torch.is_tensor(group["lr"]):
            group["lr"] = lr
        elif group.get("lr_host") != lr:
            group["lr"].fill_(lr)
            group["lr_host"] = lr
