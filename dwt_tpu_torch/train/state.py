"""What a train step threads — the port of ``dwt_tpu.train.state``.

The JAX package's ``TrainState`` is one functional pytree (params, stats,
optimizer state).  Here the model owns its parameters and running stats
(the stats advance in place in train-mode forwards), the optimizer owns
its momentum, and the state ties them to the step count and the lr
schedules.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
from torch import nn

from dwt_tpu_torch.train.optim import Schedule


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    schedules: Sequence[Schedule]  # one per param group
    step: int = 0  # optimizer steps taken; a host int, read without a sync
