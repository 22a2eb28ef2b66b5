"""Energy-harvesting battery substrate (§III-C, Eq. 3/4): the slot-level
dynamics of one FL epoch, vectorized over clients, looped over slots.

Semantics (faithful to the paper, as in ``repro.core.energy``):
  * at the beginning of each slot a unit of energy may arrive, battery
    capped at E_max;
  * actions: idle (0 energy), transmit (1 slot, 1 unit), train (kappa
    slots, kappa units); strict energy causality;
  * a training run occupies kappa consecutive slots and must start at a
    slot <= S - kappa, so it completes within the epoch;
  * a completed update is transmitted at the first later slot with E >= 1.

Battery and counters are int32 and match the reference exactly.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch.core import harvest as harvest_lib


class SlotState(NamedTuple):
    battery: torch.Tensor  # (N,) int32
    started: torch.Tensor  # (N,) bool: started training this epoch
    start_slot: torch.Tensor  # (N,) int32 (S if not started)
    pending: torch.Tensor  # (N,) bool: has an unsent message
    uploaded: torch.Tensor  # (N,) bool: uploaded during this epoch
    counter: torch.Tensor  # (N,) int32: FedBacys-Odd opportunity counter
    energy_used: torch.Tensor  # (N,) int32: cumulative units consumed
    harvest: Any = None  # HarvestProcess state
    stream: Any = None  # DataStream state (rides the loop untouched)


def scan_epoch(
    state: SlotState,
    *,
    S: int,
    kappa: int,
    e_max: int,
    want_fn: Callable[[int, SlotState], torch.Tensor],
    process: harvest_lib.HarvestProcess,
    count_opportunity_fn: Callable[[int, SlotState], torch.Tensor] | None = None,
    tx_allowed: torch.Tensor | None = None,
) -> SlotState:
    """Run S slots of battery/action dynamics. Returns the post-epoch state.

    ``state.harvest`` holds ``process``'s state (``process.init`` of the
    epoch's arrival bits).  ``count_opportunity_fn`` (FedBacys-Odd): mask of
    clients whose opportunity counter increments this slot.  ``tx_allowed``:
    (N,) bool mask of clients permitted to transmit this epoch (``None``
    leaves the dynamics unchanged).
    """
    if state.harvest is None:
        raise ValueError("state.harvest must hold the process state (process.init of the epoch's draws)")
    st = state
    for s in range(S):
        charge, hstate = process.step(st.harvest, st.battery)
        battery = torch.clamp(st.battery + charge.to(st.battery.dtype), max=e_max)
        st = st._replace(battery=battery, harvest=hstate)
        busy = st.started & (st.start_slot <= s) & (s < st.start_slot + kappa)
        # --- opportunity counting (before the odd-gate decides) ---
        if count_opportunity_fn is not None:
            opp = count_opportunity_fn(s, st) & ~busy
            st = st._replace(counter=st.counter + opp.to(st.counter.dtype))
        # --- start training ---
        want = want_fn(s, st)
        can = (~st.started) & (~busy) & (~st.pending) & (st.battery >= kappa)
        start = want & can if s <= S - kappa else torch.zeros_like(want)
        cost = start.to(torch.int32) * kappa
        battery = st.battery - cost
        energy_used = st.energy_used + cost
        started = st.started | start
        start_slot = torch.where(start, torch.full_like(st.start_slot, s), st.start_slot)
        busy = started & (start_slot <= s) & (s < start_slot + kappa)
        # --- completion -> message pending ---
        done_now = started & (start_slot + kappa == s + 1)
        pending = st.pending | done_now
        # --- transmit (cannot transmit while busy; 1 unit) ---
        can_tx = pending & ~busy & ~done_now & (battery >= 1) & ~st.uploaded
        if tx_allowed is not None:
            can_tx = can_tx & tx_allowed
        battery = battery - can_tx.to(battery.dtype)
        energy_used = energy_used + can_tx.to(energy_used.dtype)
        st = st._replace(
            battery=battery,
            started=started,
            start_slot=start_slot,
            pending=pending & ~can_tx,
            uploaded=st.uploaded | can_tx,
            energy_used=energy_used,
        )
    return st


def init_slot_state(
    n: int, device: torch.device, battery: torch.Tensor | None = None, S: int = 30
) -> SlotState:
    z = torch.zeros(n, dtype=torch.int32, device=device)
    f = torch.zeros(n, dtype=torch.bool, device=device)
    return SlotState(
        battery=z.clone() if battery is None else battery,
        started=f,
        start_slot=torch.full((n,), S, dtype=torch.int32, device=device),
        pending=f.clone(),
        uploaded=f.clone(),
        counter=z.clone(),
        energy_used=z.clone(),
    )
