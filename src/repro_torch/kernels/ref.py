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


def ssd_scan_ref(
    x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mamba2 SSD: the exact sequential recurrence, in fp32, from a zero state.

    x (B, S, nh, hp); dt (B, S, nh) post-softplus; A (nh,) negative;
    Bm, Cm (B, S, ds).  Per step t: S_t = S_{t-1}·exp(dt_t·A) + dt_t·x_tᵀB_t
    and y_t = S_t·C_t.  Returns (y (B, S, nh, hp), final state (B, nh, hp, ds)).
    """
    b, s, nh, hp = x.shape
    ds = Bm.shape[-1]
    xf, dtf, Af, Bf, Cf = x.float(), dt.float(), A.float(), Bm.float(), Cm.float()
    state = torch.zeros(b, nh, hp, ds, dtype=torch.float32, device=x.device)
    y = torch.empty(b, s, nh, hp, dtype=torch.float32, device=x.device)
    for t in range(s):
        decay = torch.exp(dtf[:, t] * Af[None, :])  # (B, nh)
        upd = torch.einsum("bh,bhp,bn->bhpn", dtf[:, t], xf[:, t], Bf[:, t])
        state = state * decay[..., None, None] + upd
        y[:, t] = torch.einsum("bhpn,bn->bhp", state, Cf[:, t])
    return y, state
