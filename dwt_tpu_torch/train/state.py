"""What a train step threads — the port of ``dwt_tpu.train.state``.

The JAX package's ``TrainState`` is one functional pytree (params, stats,
optimizer state).  Here the model owns its parameters and running stats
(the stats advance in place in train-mode forwards), the optimizer owns
its momentum, and the state ties them to the step count and the lr
schedules.  :meth:`TrainState.state_dict` and
:meth:`TrainState.load_state_dict` are the pytree's counterpart for
checkpoints (``dwt_tpu_torch.utils.checkpoint``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Sequence

import torch
from torch import nn

from dwt_tpu_torch.nn.norms import install_eval_matrix, whitening_sites
from dwt_tpu_torch.train.optim import Schedule


def _host_copy(obj: Any) -> Any:
    """``obj`` with every tensor replaced by a contiguous CPU copy."""
    if torch.is_tensor(obj):
        return obj.detach().to("cpu", copy=True,
                               memory_format=torch.contiguous_format)
    if isinstance(obj, dict):
        return {k: _host_copy(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_host_copy(v) for v in obj)
    return obj


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    schedules: Sequence[Schedule]  # one per param group
    step: int = 0  # optimizer steps taken; a host int, read without a sync

    def state_dict(self) -> Dict[str, Any]:
        """``{"model", "optimizer", "step"}``: the model's parameters and
        running stats (not the non-persistent eval matrices) and the
        optimizer's state, every tensor a contiguous CPU copy."""
        return {"model": _host_copy(self.model.state_dict()),
                "optimizer": _host_copy(self.optimizer.state_dict()),
                "step": int(self.step)}

    def load_state_dict(self, payload: Dict[str, Any]) -> None:
        """Adopt a :meth:`state_dict` in place, from any device.

        Parameters and stats keep the model's device and memory format
        (``load_state_dict`` copies into them); each momentum and Adam
        buffer is re-laid like its parameter.  Every site's cached eval
        matrix is cleared: it was factorized from the stats replaced
        here.  The schedules are functions of ``step``, so the next
        update runs at the restored step's learning rates."""
        self.model.load_state_dict(payload["model"])
        self.optimizer.load_state_dict(payload["optimizer"])
        for group in self.optimizer.param_groups:
            for p in group["params"]:
                buffers = self.optimizer.state.get(p, {})
                for key, value in buffers.items():
                    if torch.is_tensor(value) and value.shape == p.shape:
                        buffers[key] = torch.empty_like(p).copy_(value)
        for site in whitening_sites(self.model).values():
            install_eval_matrix(site, None)
        self.step = int(payload["step"])
