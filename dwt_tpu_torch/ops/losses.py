"""Domain-adaptation losses — the port of ``dwt_tpu.ops.losses``.

All losses compute in at least float32: lower-precision logits (bf16) are
promoted to f32; f64 passes through untruncated (the f64 parity tests).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def at_least_f32(x: torch.Tensor) -> torch.Tensor:
    """Promote sub-f32 inputs (bf16/f16) to f32; f64 passes through."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def entropy_loss(logits: torch.Tensor) -> torch.Tensor:
    """Mean Shannon entropy of softmax predictions,
    ``-mean_n sum_k p_nk log p_nk``."""
    logp = F.log_softmax(at_least_f32(logits), dim=-1)
    return -(logp.exp() * logp).sum(dim=-1).mean()


def mec_loss(logits_a: torch.Tensor, logits_b: torch.Tensor) -> torch.Tensor:
    """Min-Entropy Consensus loss between two views of the target batch:
    per sample ``min_k 0.5 · (−log p_a(k) − log p_b(k))``, then the batch
    mean."""
    la = F.log_softmax(at_least_f32(logits_a), dim=-1)
    lb = F.log_softmax(at_least_f32(logits_b), dim=-1)
    return (0.5 * (-la - lb)).min(dim=-1).values.mean()


def nll_loss(
    log_probs: torch.Tensor, labels: torch.Tensor, reduction: str = "mean"
) -> torch.Tensor:
    """Negative log likelihood of integer ``labels`` under ``log_probs``."""
    picked = at_least_f32(log_probs).gather(-1, labels[:, None].long())[:, 0]
    if reduction == "mean":
        return -picked.mean()
    if reduction == "sum":
        return -picked.sum()
    if reduction == "none":
        return -picked
    raise ValueError(f"unknown reduction {reduction!r}")


def softmax_cross_entropy(
    logits: torch.Tensor, labels: torch.Tensor, reduction: str = "mean"
) -> torch.Tensor:
    """``nll(log_softmax(logits), labels)`` — the reference's cls loss."""
    return nll_loss(F.log_softmax(at_least_f32(logits), dim=-1), labels,
                    reduction)


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Fraction of argmax predictions equal to ``labels`` (float32)."""
    return (logits.argmax(dim=-1) == labels).to(torch.float32).mean()
