"""Shared model building blocks (the part of ``repro.models.common`` the
CNN client needs)."""
from __future__ import annotations

from typing import Dict

import torch

Params = Dict[str, torch.Tensor]


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean token-level CE. logits (..., V) float; labels (...,) int."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long().unsqueeze(-1)).squeeze(-1)
    return (logz - gold).mean()
