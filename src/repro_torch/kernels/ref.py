"""Plain PyTorch versions of the kernels: the CPU path, and the ground
truth each Hopper kernel is held against on the card."""
from __future__ import annotations

from typing import Tuple

import torch


def vaoi_distance_ref(
    v: torch.Tensor, h: torch.Tensor, age: torch.Tensor, q: torch.Tensor, mu: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused Eq. (5) + Eq. (7): distances M_i and updated ages.

    v, h: (N, F) float; age: (N,) float32; q: (N,) float32 in {0,1}.
    Returns (m (N,), new_age (N,)), both fp32.
    """
    diff = v.float() - h.float()
    m = torch.sqrt(torch.sum(diff * diff, dim=-1))
    inc = torch.where(m >= mu, age + 1.0, age)
    return m, inc * (1.0 - q)


def fedavg_reduce_ref(msgs: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Weighted aggregation: msgs (K, P), weights (K,) -> (P,) in fp32."""
    return torch.einsum("kp,k->p", msgs.float(), weights.float())
