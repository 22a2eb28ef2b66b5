"""Version Age of Information (VAoI): Eq. (2)/(7) of the paper, the
feature-based dissimilarity proxy M_i (Eq. 5) and Alg. 2 client selection.

Plain PyTorch; the Hopper kernel ``kernels/vaoi_distance`` fuses
:func:`feature_distance` and :func:`vaoi_update`.  Selection noise is an
argument (``core.draws``), not drawn here.

The ``*_sharded`` forms are the fleet's (``core.fleet``): ``age`` and the
noise are one shard's rows of the global vectors, and the selection is
the solo one bit for bit: each shard takes its local top candidates, the
shards share them, and a global top-k over the candidates picks the same
clients (the true global top-k lies in the union of the local ones).
"""
from __future__ import annotations

from typing import Any, Tuple

import torch
import torch.distributed as dist
from torch.profiler import record_function


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


def _all_sum(x: torch.Tensor, group: Any) -> torch.Tensor:
    with record_function("ehfl.fleet.select"):
        dist.all_reduce(x, group=group)
    return x


def _distributed_topk(scores: torch.Tensor, k: int, group: Any) -> torch.Tensor:
    """Global top-k over a client-sharded score vector -> this shard's
    (n_loc,) mask.  Each shard takes its top kk = min(k, n_loc) in
    :func:`_topk_mask`'s order and shares (score, global index) pairs; the
    global order is score descending, then index ascending, the stable
    sort's tie-break, so the mask is the solo one's rows.

    The pairs are shared by an all-reduce of a zero-padded (shards, kk, 2)
    float64 buffer, each shard writing only its own row: exact (every slot
    has one contributor, and x + 0 is x; fp32 scores and indices below
    2^53 are exact in float64), and one code path for NCCL, gloo on the CPU
    and gloo on CUDA tensors, which has no all-gather for them."""
    n_loc = scores.shape[0]
    rank, shards = dist.get_rank(group), dist.get_world_size(group)
    kk = min(k, n_loc)
    local = torch.sort(scores, descending=True, stable=True).indices[:kk]
    cand = torch.zeros(shards, kk, 2, dtype=torch.float64, device=scores.device)
    cand[rank, :, 0] = scores[local].double()
    cand[rank, :, 1] = (local + rank * n_loc).double()
    cand = _all_sum(cand, group).view(-1, 2)
    cand_scores, cand_idx = cand[:, 0].float(), cand[:, 1].long()
    by_idx = torch.argsort(cand_idx)  # the indices are distinct
    top = by_idx[torch.sort(cand_scores[by_idx], descending=True, stable=True).indices[:k]]
    pos = cand_idx[top] - rank * n_loc
    mask = torch.zeros(n_loc, dtype=torch.bool, device=scores.device)
    mask[pos[(pos >= 0) & (pos < n_loc)]] = True
    return mask


def select_topk_sharded(age: torch.Tensor, k: int, noise: torch.Tensor, *, group: Any) -> torch.Tensor:
    """:func:`select_topk` with ``age`` and ``noise`` this shard's rows.
    The normalizer is the all-reduced sum of the ages, which are
    integer-valued floats: their sum is exact in any order."""
    total = _all_sum(torch.sum(age), group)
    p = torch.where(total > 0, age / torch.clamp(total, min=1e-12), 0.0)
    return _distributed_topk(p + noise, k, group)


def select_gumbel_sharded(age: torch.Tensor, k: int, gumbel: torch.Tensor, *, group: Any) -> torch.Tensor:
    """:func:`select_gumbel` with ``age`` and ``gumbel`` this shard's rows."""
    logp = torch.where(age > 0, torch.log(torch.clamp(age, min=1e-12)), -20.0)
    return _distributed_topk(logp + gumbel, k, group)


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
