"""Train, stat-collection and eval steps of both recipes — the single-device core of ``dwt_tpu.train.steps``.

Each factory closes over a model and returns a function that runs one
step on device tensors and returns device tensors: nothing in a step
reads a value back to the host, so the loop decides when to sync (at its
log interval, and once per eval pass).  Each step sets the model's mode
itself, as the JAX steps pass ``train=`` to ``model.apply``.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch
import torch.nn.functional as F
from torch import nn

from dwt_tpu_torch.ops.losses import (
    at_least_f32,
    entropy_loss,
    mec_loss,
    nll_loss,
    softmax_cross_entropy,
)
from dwt_tpu_torch.train.optim import set_learning_rates
from dwt_tpu_torch.train.state import TrainState

Batch = Dict[str, torch.Tensor]
Metrics = Dict[str, torch.Tensor]


def _finite_flag(metrics: Metrics) -> torch.Tensor:
    """Device-side all-finite verdict over loss and grad norm."""
    return torch.isfinite(metrics["loss"]) & torch.isfinite(metrics["grad_norm"])


def _finish_step(state: TrainState, loss: torch.Tensor,
                 metrics: Metrics) -> Metrics:
    """Backward of ``loss``, the global gradient norm and the finite flag
    into ``metrics``, then the optimizer step at the schedules' lrs for
    ``state.step``; ``state.step`` advances by one."""
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    grads = [p.grad for p in state.model.parameters() if p.grad is not None]
    metrics["grad_norm"] = torch.nn.utils.get_total_norm(grads)
    metrics["finite"] = _finite_flag(metrics)
    set_learning_rates(state.optimizer, state.schedules, state.step)
    state.optimizer.step()
    state.step += 1
    return metrics


def make_digits_train_step(
    model: nn.Module, lambda_entropy: float = 0.1
) -> Callable[[TrainState, Batch], Metrics]:
    """Digits (USPS↔MNIST) step: cls on source + λ·entropy on target.

    The reference loop body (``usps_mnist.py:281-308``): the two streams
    stacked ``[2, N, 28, 28, 1]``, one train forward (every norm site's
    running stats advance), ``nll(log_softmax(src), y) + λ·H(tgt)``, the
    global gradient norm, then the Adam step at the schedule's lr for
    ``state.step``.  ``state.step`` advances by one.
    """

    def train_step(state: TrainState, batch: Batch) -> Metrics:
        model.train()
        logits = model(torch.stack([batch["source_x"], batch["target_x"]]))
        cls = softmax_cross_entropy(logits[0], batch["source_y"])
        ent = lambda_entropy * entropy_loss(logits[1])
        loss = cls + ent
        return _finish_step(state, loss, {
            "loss": loss.detach(), "cls_loss": cls.detach(),
            "entropy_loss": ent.detach()})

    return train_step


def make_officehome_train_step(
    model: nn.Module, lambda_mec: float = 0.1
) -> Callable[[TrainState, Batch], Metrics]:
    """OfficeHome step: cls on source + λ·MEC between the two target views.

    The reference loop body: the three streams (source, target, augmented
    target) stacked ``[3, N, H, W, C]``, one train forward (every norm
    site's running stats advance), ``nll + λ·MEC(tgt, tgt_aug)``, the
    global gradient norm, then the SGD step at the schedules' lrs for
    ``state.step``.  ``state.step`` advances by one.
    """

    def train_step(state: TrainState, batch: Batch) -> Metrics:
        model.train()
        x = torch.stack(
            [batch["source_x"], batch["target_x"], batch["target_aug_x"]]
        )
        logits = model(x)
        cls = softmax_cross_entropy(logits[0], batch["source_y"])
        mec = lambda_mec * mec_loss(logits[1], logits[2])
        loss = cls + mec
        return _finish_step(state, loss, {
            "loss": loss.detach(), "cls_loss": cls.detach(),
            "mec_loss": mec.detach()})

    return train_step


def make_stat_collection_step(
    model: nn.Module, num_domains: int
) -> Callable[[TrainState, torch.Tensor], TrainState]:
    """The post-training stat-collection pass (gradient-free train forward).

    The reference's ``eval_pass_collect_stats``: the model in train mode
    under no_grad, fed the same batch tiled into every domain slot, purely
    to advance the running stats toward the target distribution.  Only
    the stats change.
    """

    @torch.no_grad()
    def collect(state: TrainState, x: torch.Tensor) -> TrainState:
        model.train()
        model(x.unsqueeze(0).expand((num_domains,) + tuple(x.shape)))
        return state

    return collect


def eval_counters(device: torch.device) -> Metrics:
    """Zero device-resident eval accumulators: the reference ``test()``'s
    summed loss, correct count and sample count."""
    return {
        "loss_sum": torch.zeros((), dtype=torch.float32, device=device),
        "correct": torch.zeros((), dtype=torch.int32, device=device),
        "count": torch.zeros((), dtype=torch.int32, device=device),
    }


def make_eval_step(
    model: nn.Module,
) -> Callable[[torch.Tensor, torch.Tensor], Metrics]:
    """Eval step ``(x, y) -> {loss_sum, correct, count}`` of one batch, the
    reference ``test()``'s per-batch sums (``usps_mnist.py:310-327``):
    summed nll in at least f32, correct predictions and the batch size,
    the counts int32.  The callers sum them over a pass."""

    @torch.no_grad()
    def eval_step(x: torch.Tensor, y: torch.Tensor) -> Metrics:
        model.eval()
        logits = model(x)
        logp = F.log_softmax(at_least_f32(logits), dim=-1)
        return {
            "loss_sum": nll_loss(logp, y, reduction="sum"),
            "correct": (logits.argmax(dim=-1) == y).sum(dtype=torch.int32),
            "count": torch.tensor(y.shape[0], dtype=torch.int32,
                                  device=y.device),
        }

    return eval_step


def make_accum_eval_step(
    model: nn.Module,
) -> Callable[[Metrics, torch.Tensor, torch.Tensor, torch.Tensor], Metrics]:
    """Accumulating eval step: ``(counters, x, y, mask) -> counters``.

    One eval-mode forward of the batch; ``mask`` marks real samples (the
    loader pads a ragged final batch), and padded rows add nothing to any
    counter, so counts stay exact.
    """

    @torch.no_grad()
    def accum_eval(counters: Metrics, x: torch.Tensor, y: torch.Tensor,
                   mask: torch.Tensor) -> Metrics:
        model.eval()
        logits = model(x)
        per_sample = nll_loss(F.log_softmax(at_least_f32(logits), dim=-1), y,
                              reduction="none")
        hit = (logits.argmax(dim=-1) == y) & mask
        return {
            "loss_sum": counters["loss_sum"]
            + torch.where(mask, per_sample, 0.0).sum(),
            "correct": counters["correct"] + hit.sum(dtype=torch.int32),
            "count": counters["count"] + mask.sum(dtype=torch.int32),
        }

    return accum_eval
