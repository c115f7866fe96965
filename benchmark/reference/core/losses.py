"""Loss functions (port of ``core/losses.py``), in f32.

Each takes its weights or mask and an ``avg_factor`` from the caller, so
the caller controls the normalisation: sigmoid focal loss, L1, and softmax
cross-entropy with per-class weights.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def sigmoid_ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Numerically stable sigmoid cross-entropy, per element."""
    return logits.clamp(min=0) - logits * labels + torch.log1p(torch.exp(-logits.abs()))


def sigmoid_focal_loss(logits: torch.Tensor, targets_onehot: torch.Tensor,
                       gamma: float = 2.0, alpha: float = 0.25) -> torch.Tensor:
    """Per-element focal loss (no reduction); targets in {0, 1}."""
    p = torch.sigmoid(logits)
    ce = sigmoid_ce(logits, targets_onehot)
    p_t = p * targets_onehot + (1 - p) * (1 - targets_onehot)
    alpha_t = alpha * targets_onehot + (1 - alpha) * (1 - targets_onehot)
    return alpha_t * (1 - p_t) ** gamma * ce


def l1_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return (pred - target).abs()


def softmax_ce_loss(logits: torch.Tensor, labels: torch.Tensor,
                    class_weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-element cross-entropy of int labels [N] (clipped into range),
    times the label's class weight; returns [N]."""
    safe = labels.clamp(0, logits.shape[-1] - 1).long()
    nll = -F.log_softmax(logits, dim=-1).gather(-1, safe[..., None])[..., 0]
    if class_weight is not None:
        nll = nll * class_weight[safe]
    return nll


def weighted_reduce(loss: torch.Tensor, weight: torch.Tensor,
                    avg_factor: torch.Tensor) -> torch.Tensor:
    """sum(loss · weight) / max(avg_factor, 1)."""
    return (loss * weight).sum() / torch.clamp(torch.as_tensor(avg_factor, dtype=loss.dtype,
                                                               device=loss.device), min=1.0)
