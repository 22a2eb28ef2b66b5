"""Energy-arrival processes: the ``bernoulli`` scenario of
``repro.core.harvest`` (Eq. 3), fed by ``EpochDraws.harvest``.

``init(bits, n) -> state`` takes the epoch's (S, N) arrival bits;
``step(state, battery) -> (charge, state)`` hands out one slot's (N,) int32
arrivals.  The ``markov``, ``diurnal`` and ``hetero`` scenarios are not
ported yet (ROADMAP.md, queue 1, "Scenario axes")."""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Tuple

import torch

SCENARIOS = ("bernoulli", "markov", "diurnal", "hetero")


class HarvestProcess(NamedTuple):
    name: str
    persistent: bool  # state survives across epochs (else re-drawn per epoch)
    mean_rate: float  # configured long-run arrival rate (units/slot/client)
    init: Callable[[torch.Tensor, int], Any]
    step: Callable[[Any, torch.Tensor], Tuple[torch.Tensor, Any]]


def bernoulli(p_bc: float) -> HarvestProcess:
    """Paper-faithful i.i.d. arrivals (Eq. 3).  The arrivals are the
    injected bits; ``p_bc`` is what the draw source draws them with."""

    def init(bits: torch.Tensor, n: int):
        if bits.dim() != 2 or bits.shape[1] != n:
            raise ValueError(f"harvest bits must be (S, {n}); got {tuple(bits.shape)}")
        return bits, 0

    def step(state, battery: torch.Tensor):
        bits, s = state
        return bits[s].to(torch.int32), (bits, s + 1)

    return HarvestProcess("bernoulli", False, float(p_bc), init, step)


def make_process(name: str, p_bc: float, **params: float) -> HarvestProcess:
    if name not in SCENARIOS:
        raise ValueError(f"unknown harvest scenario {name!r}; known: {SCENARIOS}")
    if name != "bernoulli":
        raise NotImplementedError(
            f"harvest scenario {name!r} is not ported yet (ROADMAP.md queue 1, 'Scenario axes')"
        )
    if params:
        raise ValueError(f"bernoulli takes no parameters; got {sorted(params)}")
    return bernoulli(p_bc)
