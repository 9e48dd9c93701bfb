"""Int8 post-training weight quantization — a serving deployment format.

The port of ``dwt_tpu.serve.quant``.  The checkpoint on disk never
changes (its weights stay f32); quantization happens when the engine
builds a generation (:meth:`ServeEngine.build_state`, off the dispatcher
thread), producing:

* the int8 weights ``q``, one per named float parameter, and
* their dequant scales, one f32 per tensor, carried with them on the
  :class:`~dwt_tpu_torch.serve.engine.EngineState` —

so the forward dequantizes ``q.float() * scale`` on the device at every
call and a hot swap can never pair new int8 weights with old scales.

Symmetric per-tensor quantization: ``scale = max|w| / 127`` (1 for an
all-zero tensor, which keeps its dequant exact), ``q = round(w / scale)``
clipped to ±127, rounding half to even.  Each step is the JAX function's
f32 arithmetic in the same order, so ``q``, the scales and the
dequantized weights are bitwise the JAX package's.  Non-float tensors
pass through unchanged with scale 1.  The accuracy check is not this
module's job: every quantized candidate passes the fleet's
:class:`~dwt_tpu_torch.fleet.canary.CanaryGate` before taking traffic.
"""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

import torch

INT8_MAX = 127.0


def quantize_tensor(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``w -> (q, scale)``: int8 ``q`` in ``w``'s shape and memory format
    and a 0-d f32 scale; a non-float ``w`` comes back as is, scale 1."""
    if not w.is_floating_point():
        return w, torch.ones((), dtype=torch.float32, device=w.device)
    w = w.detach().float()
    amax = w.abs().max()
    scale = torch.where(amax > 0, amax / INT8_MAX, torch.ones_like(amax))
    q = torch.clamp(torch.round(w / scale), -INT8_MAX, INT8_MAX)
    return q.to(torch.int8), scale


def dequantize_tensor(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``q.float() * scale`` for an int8 ``q``; anything else as is."""
    if q.dtype != torch.int8:
        return q
    return q.float() * scale


def quantize_int8(
    named: Iterable[Tuple[str, torch.Tensor]]
) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """``(name, tensor)`` pairs (``model.named_parameters()``) → ``({name:
    q}, {name: scale})``, every name in both."""
    qs: Dict[str, torch.Tensor] = {}
    scales: Dict[str, torch.Tensor] = {}
    for name, w in named:
        qs[name], scales[name] = quantize_tensor(w)
    return qs, scales


def dequantize_int8(
    qparams: Dict[str, torch.Tensor], scales: Dict[str, torch.Tensor]
) -> Dict[str, torch.Tensor]:
    """``{name: q.float() * scale}``; non-int8 entries come back as is."""
    return {k: dequantize_tensor(q, scales[k]) for k, q in qparams.items()}
