"""Version Age of Information (VAoI): Eq. (2)/(7) of the paper, the
feature-based dissimilarity proxy M_i (Eq. 5) and Alg. 2 client selection.

Plain PyTorch; the Hopper kernel ``kernels/vaoi_distance`` fuses
:func:`feature_distance` and :func:`vaoi_update`.  Selection noise is an
argument (``core.draws``), not drawn here.
"""
from __future__ import annotations

from typing import Tuple

import torch


def feature_distance(v: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """M_i = ||v_i - h_i||_2 per client. v, h: (N, F) -> (N,)."""
    diff = v.float() - h.float()
    return torch.sqrt(torch.sum(diff * diff, dim=-1))


def vaoi_update(age: torch.Tensor, m: torch.Tensor, q: torch.Tensor, mu: float) -> torch.Tensor:
    """Eq. (7): X(t+1) = (X+1)(1-q) if M >= mu else X(1-q).

    age: (N,) float; m: (N,) distances; q: (N,) {0,1} participation.
    """
    inc = torch.where(m >= mu, age + 1.0, age)
    return inc * (1.0 - q.to(age.dtype))


def _topk_mask(scores: torch.Tensor, k: int) -> torch.Tensor:
    # a stable descending sort puts the lower index first among equal
    # scores, which is lax.top_k's tie-break; torch.topk promises no order
    idx = torch.sort(scores, descending=True, stable=True).indices[:k]
    mask = torch.zeros(scores.shape[0], dtype=torch.bool, device=scores.device)
    mask[idx] = True
    return mask


def select_topk(age: torch.Tensor, k: int, noise: torch.Tensor) -> torch.Tensor:
    """Alg. 2: normalize p_i = X_i / sum X_j, take the k largest.

    ``noise`` is the U[0, 1e-3) tie-break (it also covers the all-zero cold
    start, where selection degenerates to uniform sampling of k clients).
    Returns a boolean mask (N,).
    """
    total = torch.sum(age)
    p = torch.where(total > 0, age / torch.clamp(total, min=1e-12), 0.0)
    return _topk_mask(p + noise, k)


def select_gumbel(age: torch.Tensor, k: int, gumbel: torch.Tensor) -> torch.Tensor:
    """Sample k clients WITHOUT replacement with probability proportional to
    p_i = X_i / sum X_j (Gumbel-top-k, with standard Gumbel ``gumbel``)."""
    logp = torch.where(age > 0, torch.log(torch.clamp(age, min=1e-12)), -20.0)
    return _topk_mask(logp + gumbel, k)


def client_select(
    age: torch.Tensor, v: torch.Tensor, h: torch.Tensor, k: int, mu: float, noise: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Alg. 2 CLIENTSELECT: returns (selected mask, new ages, distances M).

    v: (N, F) feature vectors of the *global* model on each client's probe
    batch; h: (N, F) stored historical moments.
    """
    selected = select_topk(age, k, noise)
    m = feature_distance(v, h)
    new_age = vaoi_update(age, m, selected.float(), mu)
    return selected, new_age, m
