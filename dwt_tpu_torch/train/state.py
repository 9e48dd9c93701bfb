"""What a train step threads — the port of ``dwt_tpu.train.state``.

The JAX package's ``TrainState`` is one functional pytree (params, stats,
optimizer state).  Here the model owns its parameters and running stats
(the stats advance in place in train-mode forwards), the optimizer owns
its momentum, and the state ties them to the step count, the lr
schedules and the guard's backoff scale ``lr_scale`` (the JAX package's
``BackoffScaleState``).  :meth:`TrainState.state_dict` and
:meth:`TrainState.load_state_dict` are the pytree's counterpart for
checkpoints (``dwt_tpu_torch.utils.checkpoint``); :meth:`TrainState.
snapshot` is its device copy (``jnp.copy`` of the tree), which the
divergence guard reverts to and the background checkpoint writer copies
to the host.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from dwt_tpu_torch.nn.norms import install_eval_matrix, whitening_sites
from dwt_tpu_torch.train.optim import Schedule


def _host_tensor(t: torch.Tensor) -> torch.Tensor:
    """A contiguous CPU copy of ``t``.  A dense card tensor in another
    layout (a channels_last weight) crosses as its own bytes, one copy
    without a temporary on the card, and is laid out contiguous on the
    host."""
    t = t.detach()
    if t.is_cuda and not t.is_contiguous() and _dense(t):
        host = torch.empty_strided(t.size(), t.stride(), dtype=t.dtype)
        host.copy_(t)
        return host.contiguous()
    return t.to("cpu", copy=True, memory_format=torch.contiguous_format)


def _host_copy(obj: Any) -> Any:
    """``obj`` with every tensor replaced by a contiguous CPU copy."""
    if torch.is_tensor(obj):
        return _host_tensor(obj)
    if isinstance(obj, dict):
        return {k: _host_copy(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_host_copy(v) for v in obj)
    return obj


def _dense(t: torch.Tensor) -> bool:
    """``t`` covers exactly ``numel`` consecutive elements of its storage
    (contiguous in some order of its dimensions, as channels_last is)."""
    expect = 1
    for stride, size in sorted((st, n) for n, st in zip(t.shape, t.stride()) if n > 1):
        if stride != expect:
            return False
        expect *= size
    return True


def _flat(t: torch.Tensor) -> torch.Tensor:
    """A dense ``t`` as the 1-D contiguous view of its elements."""
    return t.as_strided((t.numel(),), (1,))


def _tensor_leaves(obj: Any, path: Tuple = ()) -> List[Tuple[Tuple, torch.Tensor]]:
    """``(path, tensor)`` for every tensor in a nest of dicts and lists."""
    if torch.is_tensor(obj):
        return [(path, obj)]
    if isinstance(obj, dict):
        return [leaf for k, v in obj.items() for leaf in _tensor_leaves(v, path + (k,))]
    if isinstance(obj, (list, tuple)):
        return [leaf for i, v in enumerate(obj)
                for leaf in _tensor_leaves(v, path + (i,))]
    return []


def _replace_leaves(obj: Any, new: Dict[Tuple, torch.Tensor], path: Tuple = ()) -> Any:
    """``obj`` with the tensor at each path of ``new`` replaced."""
    if torch.is_tensor(obj):
        return new[path]
    if isinstance(obj, dict):
        return {k: _replace_leaves(v, new, path + (k,)) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_replace_leaves(v, new, path + (i,)) for i, v in enumerate(obj))
    return obj


@dataclasses.dataclass
class StateSnapshot:
    """Copies of every tensor of a ``TrainState`` (parameters, running
    stats, optimizer buffers) as ``{"model", "optimizer", "step",
    "lr_scale"}``, the form :meth:`TrainState.state_dict` returns, its
    tensors on their own devices.  ``event`` is recorded on the compute
    stream after the copies (CUDA only): a reader on another stream waits
    on it."""

    payload: Dict[str, Any]
    event: Optional[Any] = None

    def buffers(self) -> Dict[Tuple, torch.Tensor]:
        return dict(_tensor_leaves({k: self.payload[k] for k in ("model", "optimizer")}))

    def host_payload(self, stream=None) -> Dict[str, Any]:
        """The payload with every tensor a contiguous CPU copy — on the
        CUDA ``stream`` (after it waits on ``event``) when given."""
        if stream is None:
            return _host_copy(self.payload)
        stream.wait_event(self.event)
        with torch.cuda.stream(stream):
            host = _host_copy(self.payload)
        stream.synchronize()
        return host


# A param group's implementation flags: the live optimizer's stay.
_IMPL_KEYS = ("fused", "foreach", "capturable", "differentiable")


def _adopt_optimizer_state(optimizer: torch.optim.Optimizer, saved: Dict) -> None:
    """``optimizer.load_state_dict(saved)`` in place: each saved buffer is
    copied into the live one of its parameter when one of its shape
    exists (references held elsewhere stay valid), else created beside its
    parameter (a momentum re-laid like a channels_last weight); a
    parameter without saved state loses its live state, as a fresh
    optimizer's; the groups' hyperparameters are the saved ones, but for
    the live optimizer's own implementation (``_IMPL_KEYS``, chosen per
    device by ``train/optim.py``) and its device lr, so a state saved on
    another device, or before the lr moved to the device, resumes into
    the update rule a capture reads."""
    groups = optimizer.param_groups
    saved_groups = saved["param_groups"]
    if len(groups) != len(saved_groups) or any(
            len(g["params"]) != len(s["params"]) for g, s in zip(groups, saved_groups)):
        raise ValueError("the saved optimizer state has other param groups")
    by_id, group_of = {}, {}
    for group, sgroup in zip(groups, saved_groups):
        by_id.update(zip(sgroup["params"], group["params"]))
        group_of.update((id(p), group) for p in group["params"])
        device_lr = torch.is_tensor(group.get("lr"))
        keep_live = _IMPL_KEYS + (("lr", "lr_host") if device_lr else ())
        # JSON (a delta manifest) turns a tuple (Adam's betas) into a list.
        group.update({k: tuple(v) if isinstance(group.get(k), tuple) else v
                      for k, v in sgroup.items()
                      if k != "params" and k not in keep_live})
        if device_lr:
            # The device lr stays the tensor a captured step reads; the next
            # set_learning_rates writes it.
            group["lr_host"] = None
    keep = {by_id[int(i)] for i in saved["state"]}
    for p in [p for p in optimizer.state if p not in keep]:
        del optimizer.state[p]
    with torch.no_grad():
        for i, buffers in saved["state"].items():
            p = by_id[int(i)]
            live = optimizer.state[p]
            for key in [k for k in live if k not in buffers]:
                del live[key]
            for key, value in buffers.items():
                current = live.get(key)
                if not torch.is_tensor(value):
                    live[key] = value
                elif (torch.is_tensor(current) and current.shape == value.shape
                      and current.dtype == value.dtype):
                    current.copy_(value)
                elif value.shape == p.shape:
                    live[key] = torch.empty_like(p).copy_(value)
                else:  # Adam's step count: on the device when capturable
                    group = group_of[id(p)]
                    on_device = group.get("capturable") or group.get("fused")
                    live[key] = value.detach().clone().to(
                        p.device if on_device else "cpu")


def _copy_all(dsts: List[torch.Tensor], srcs: List[torch.Tensor]) -> None:
    """``dst.copy_(src)`` pairwise in a few launches: dense pairs of equal
    strides as 1-D views, one ``torch._foreach_copy_`` per device and
    dtype (it takes ~110 tensors a launch); any other pair on its own."""
    groups: Dict[Any, Tuple[List, List]] = {}
    for d, s in zip(dsts, srcs):
        if d.stride() == s.stride() and _dense(s):
            pair = groups.setdefault((s.device, s.dtype), ([], []))
            pair[0].append(_flat(d))
            pair[1].append(_flat(s))
        else:
            d.copy_(s)
    for d, s in groups.values():
        torch._foreach_copy_(d, s)


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    schedules: Sequence[Schedule]  # one per param group
    step: int = 0  # optimizer steps taken; a host int, read without a sync
    # The divergence guard's backoff scale on every group's lr (1.0: off);
    # a host float, saved with the state.
    lr_scale: float = 1.0

    def _live(self) -> Dict[str, Any]:
        optimizer = self.optimizer.state_dict()
        for group in optimizer["param_groups"]:
            if torch.is_tensor(group.get("lr")):
                # A device lr (train/optim.py) is saved as its host value.
                lr = group.pop("lr_host", None)
                group["lr"] = 0.0 if lr is None else lr
        return {"model": self.model.state_dict(), "optimizer": optimizer}

    def state_dict(self) -> Dict[str, Any]:
        """``{"model", "optimizer", "step", "lr_scale"}``: the model's
        parameters and running stats (not the non-persistent eval
        matrices) and the optimizer's state, every tensor a contiguous CPU
        copy."""
        return {**_host_copy(self._live()), "step": int(self.step),
                "lr_scale": float(self.lr_scale)}

    def snapshot(self, reuse: Optional[StateSnapshot] = None) -> StateSnapshot:
        """Copies of the state's tensors on their devices, each keeping its
        strides (a channels_last weight stays so), enqueued on the current
        stream without a sync, in a few fused launches (:func:`_copy_all`).
        ``reuse`` is a former snapshot whose buffers are overwritten where
        path, shape, dtype, device and strides still match."""
        live = self._live()
        old = reuse.buffers() if reuse is not None else {}
        dsts, srcs, new = [], [], {}
        for path, t in _tensor_leaves(live):
            t = t.detach()
            buf = old.get(path)
            if buf is None or buf.shape != t.shape or buf.dtype != t.dtype or (
                    buf.device != t.device) or buf.stride() != t.stride():
                buf = torch.empty_like(t, memory_format=torch.preserve_format)
            new[path] = buf
            dsts.append(buf)
            srcs.append(t)
        with torch.no_grad():
            _copy_all(dsts, srcs)
        event = None
        if any(t.is_cuda for t in srcs):
            event = torch.cuda.Event()
            event.record()
        payload = _replace_leaves(live, new)
        return StateSnapshot({**payload, "step": int(self.step),
                              "lr_scale": float(self.lr_scale)}, event)

    def load_state_dict(self, payload: Dict[str, Any]) -> None:
        """Adopt a :meth:`state_dict` or a :meth:`snapshot`'s payload in
        place, from any device.

        Parameters and stats are copied into the model's tensors (their
        device and memory format stay); optimizer buffers as in
        :func:`_adopt_optimizer_state`.  Every site's cached eval matrix
        is cleared: it was factorized from the stats replaced here.  The
        schedules are functions of ``step``, so the next update runs at
        the restored step's learning rates; ``lr_scale`` is the saved one
        (1.0 for a checkpoint written before the scale was saved)."""
        self.model.load_state_dict(payload["model"])
        _adopt_optimizer_state(self.optimizer, payload["optimizer"])
        for site in whitening_sites(self.model).values():
            install_eval_matrix(site, None)
        self.step = int(payload["step"])
        self.lr_scale = float(payload.get("lr_scale", 1.0))
