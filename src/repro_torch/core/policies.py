"""Scheduling policies (§V benchmarks + the paper's VAoI scheme).

Each policy supplies, per epoch:
  * ``epoch_selection`` — who *wants* to train this epoch;
  * ``make_want_fn`` — the slot-level start rule for the energy loop;
  * whether it maintains VAoI state (only the VAoI schemes do).

Policies:
  vaoi          — the paper: top-k by VAoI, start ASAP within the epoch.
  vaoi_soft     — Gumbel-top-k selection in place of Alg. 2's top-k.
  fedavg        — greedy energy-aware baseline: everyone, ASAP.
  fedbacys      — cyclic groups; procrastinate to the last feasible slot.
  fedbacys_odd  — FedBacys + odd-chance rule (skip every other opportunity).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist

from repro_torch.core import vaoi as vaoi_lib
from repro_torch.core.energy import SlotState

POLICIES = ("vaoi", "vaoi_soft", "fedavg", "fedbacys", "fedbacys_odd")


@dataclass(frozen=True)
class PolicySpec:
    name: str
    uses_vaoi: bool
    cyclic_groups: int = 0  # FedBacys group count G (0 = none)
    # static upper bound on the clients that can START training in one epoch
    # (the selection mask's max popcount): k for the top-k schemes, the
    # largest cyclic group for FedBacys, N for fedavg.  It sizes the
    # compacted training slab (simulator.resolve_compact_cap).
    max_active: int = 0


def make_policy(name: str, *, num_clients: int, k: int, num_groups: int = 0) -> PolicySpec:
    if name not in POLICIES:
        raise ValueError(f"unknown policy {name!r}; known: {POLICIES}")
    if name in ("fedbacys", "fedbacys_odd") and num_groups == 0:
        num_groups = max(1, num_clients // max(k, 1))
    if name in ("vaoi", "vaoi_soft"):
        max_active = min(k, num_clients)  # Alg. 2 selects exactly k
    elif name in ("fedbacys", "fedbacys_odd"):
        # group g = {i : i mod G == g}; the largest has ceil(N/G) members
        max_active = -(-num_clients // max(1, num_groups))
    else:  # fedavg schedules everyone
        max_active = num_clients
    return PolicySpec(
        name=name,
        uses_vaoi=name.startswith("vaoi"),
        cyclic_groups=num_groups,
        max_active=max_active,
    )


def epoch_selection(
    spec: PolicySpec, age: torch.Tensor, epoch: int, k: int, noise: torch.Tensor
) -> torch.Tensor:
    """(N,) mask of clients scheduled for this epoch.  ``noise`` is the
    epoch's selection noise (``EpochDraws.noise``)."""
    n = age.shape[0]
    if spec.name == "vaoi":
        return vaoi_lib.select_topk(age, k, noise)
    if spec.name == "vaoi_soft":
        return vaoi_lib.select_gumbel(age, k, noise)
    if spec.name == "fedavg":
        return torch.ones(n, dtype=torch.bool, device=age.device)
    # FedBacys variants: group g participates in epoch t iff g == t mod G
    G = spec.cyclic_groups
    return torch.arange(n, device=age.device) % G == int(epoch) % G


def epoch_selection_sharded(
    spec: PolicySpec, age: torch.Tensor, epoch: int, k: int, noise: torch.Tensor, *, group: Any
) -> torch.Tensor:
    """:func:`epoch_selection` over a client-sharded fleet: ``age`` and
    ``noise`` are this shard's rows (of the global vectors, in rank order
    over ``group``), and so is the returned mask, which equals the solo
    selection's rows bit for bit."""
    n_loc = age.shape[0]
    if spec.name == "vaoi":
        return vaoi_lib.select_topk_sharded(age, k, noise, group=group)
    if spec.name == "vaoi_soft":
        return vaoi_lib.select_gumbel_sharded(age, k, noise, group=group)
    if spec.name == "fedavg":
        return torch.ones(n_loc, dtype=torch.bool, device=age.device)
    # FedBacys: the cyclic group comes from the GLOBAL client index
    G = spec.cyclic_groups
    off = dist.get_rank(group) * n_loc
    return (off + torch.arange(n_loc, device=age.device)) % G == int(epoch) % G


def make_want_fn(
    spec: PolicySpec, selected: torch.Tensor, S: int, kappa: int
) -> Callable[[int, SlotState], torch.Tensor]:
    """Slot-level 'wants to start training now' rule."""
    last = S - kappa
    never = torch.zeros_like(selected)

    if spec.name in ("vaoi", "vaoi_soft", "fedavg"):
        # start as soon as feasible within the epoch
        return lambda s, st: selected

    if spec.name == "fedbacys":
        return lambda s, st: selected if s == last else never

    # fedbacys_odd: also require an odd opportunity counter (counter is
    # incremented by count_opportunity_fn before this is evaluated)
    return lambda s, st: selected & (st.counter % 2 == 1) if s == last else never


def make_opportunity_fn(
    spec: PolicySpec, selected: torch.Tensor, S: int, kappa: int
) -> Optional[Callable[[int, SlotState], torch.Tensor]]:
    """FedBacys-Odd: opportunities = slots where criteria (i)-(iii) are met."""
    if spec.name != "fedbacys_odd":
        return None
    last = S - kappa
    never = torch.zeros_like(selected)

    def opp(s, st: SlotState):
        if s != last:
            return never
        return selected & (~st.started) & (~st.pending) & (st.battery >= kappa)

    return opp
