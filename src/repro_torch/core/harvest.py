"""Energy-arrival processes: ``repro.core.harvest``'s four scenarios (Eq. 3
and its mean-rate-matched variants), fed by injected draws.

A process has a *carried* state that survives across epochs (``None`` for
the memoryless ``bernoulli``; the Markov phases, the diurnal slot clock or
the per-client rates otherwise) and steps through an epoch on the scan
state ``(carried, draws, s)``: ``draws`` are the epoch's per-slot draws
(``EpochDraws.harvest``, slot axis second to last) and ``s`` the slot.

  * ``init(x, n)``: ``bernoulli`` takes the epoch's (S, N) arrival bits and
    returns the scan state (the reference re-seeds it every epoch);
    the persistent processes take their ``init_draw`` and return the
    carried state (the reference draws it once, in ``init_carry``);
  * ``step(state, battery) -> (charge, state)`` hands out one slot's (N,)
    int32 arrivals;
  * ``init_draw(rng, n)`` / ``epoch_draw(g, S, N)`` draw what ``init`` and
    the epoch consume (``core.draws.TorchDraws`` calls them).

Where the reference draws ``bernoulli(k, p)``, the port compares the
injected uniform ``u < p`` in float32, as ``jax.random.bernoulli`` does."""
from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple, Tuple

import numpy as np
import torch

SCENARIOS = ("bernoulli", "markov", "diurnal", "hetero")


class HarvestProcess(NamedTuple):
    name: str
    persistent: bool  # state survives across epochs (else re-drawn per epoch)
    mean_rate: float  # configured long-run arrival rate (units/slot/client)
    init: Callable[[Any, int], Any]
    step: Callable[[Any, torch.Tensor], Tuple[torch.Tensor, Any]]
    init_draw: Callable[[np.random.Generator, int], Any]
    epoch_draw: Callable[[torch.Generator, int, int], torch.Tensor]


def begin(carried: Any, draws: torch.Tensor, n: int, S: int) -> tuple:
    """The scan state of a persistent process at the start of an epoch."""
    if draws.dim() < 2 or tuple(draws.shape[-2:]) != (S, n):
        raise ValueError(f"harvest draws must be (..., {S}, {n}); got {tuple(draws.shape)}")
    return carried, draws, 0


def _no_draw(rng: np.random.Generator, n: int) -> None:
    return None


def _uniforms(*lead: int) -> Callable[[torch.Generator, int, int], torch.Tensor]:
    return lambda g, S, n: torch.rand(*lead, S, n, generator=g)


def _need(x: Any, what: str) -> torch.Tensor:
    if x is None:
        raise ValueError(f"{what} needs its init draws (core.draws.InitDraws.harvest)")
    return x


def bernoulli(p_bc: float) -> HarvestProcess:
    """Paper-faithful i.i.d. arrivals (Eq. 3).  The arrivals are the
    injected bits; ``p_bc`` is what the draw source draws them with."""

    def init(bits: torch.Tensor, n: int):
        if bits.dim() != 2 or bits.shape[1] != n:
            raise ValueError(f"harvest bits must be (S, {n}); got {tuple(bits.shape)}")
        return None, bits, 0

    def step(state, battery: torch.Tensor):
        _, bits, s = state
        return bits[s].to(torch.int32), (None, bits, s + 1)

    def epoch_draw(g: torch.Generator, S: int, n: int) -> torch.Tensor:
        return torch.rand(S, n, generator=g) < p_bc

    return HarvestProcess("bernoulli", False, float(p_bc), init, step, _no_draw, epoch_draw)


def markov(p_bc: float, p_on: float = 0.8, sojourn: float = 8.0) -> HarvestProcess:
    """Gilbert–Elliott ON/OFF bursts: arrivals w.p. ``p_on`` while ON, none
    while OFF; stationary ON-fraction pi = p_bc / p_on (long-run rate
    ``p_bc``); ``sojourn`` = 1/(g2b + b2g) the phase-relaxation timescale.
    Carried state: the (N,) bool phases.  Draws: (N,) phase uniforms once,
    (2, S, N) uniforms per epoch (arrivals, flips)."""
    # the reference's clamps, in the same float64 arithmetic
    p_on = min(1.0, max(float(p_on), min(1.0, float(p_bc))))
    pi_on = 0.0 if p_on == 0.0 else min(1.0, float(p_bc) / p_on)
    sojourn = max(1.0, float(sojourn))
    g2b = (1.0 - pi_on) / sojourn  # ON -> OFF
    b2g = pi_on / sojourn  # OFF -> ON

    def init(u_z, n: int) -> torch.Tensor:
        return _need(u_z, "markov") < pi_on

    def step(state, battery: torch.Tensor):
        z, u, s = state
        # torch.where of two Python floats is float32, as jnp.where's
        charge = (u[0, s] < torch.where(z, p_on, 0.0)).to(torch.int32)
        flip = u[1, s] < torch.where(z, g2b, b2g)
        return charge, (z ^ flip, u, s + 1)

    def init_draw(rng: np.random.Generator, n: int) -> np.ndarray:
        return rng.random(n, dtype=np.float32)

    return HarvestProcess("markov", True, float(p_bc), init, step, init_draw, _uniforms(2))


def diurnal(p_bc: float, period: float = 240.0, day_frac: float = 0.5) -> HarvestProcess:
    """Solar-like intensity × Bernoulli thinning: one "day" is ``period``
    slots, the first ``day_frac`` of it daylight with half-sine intensity,
    renormalized so the day-averaged rate is ``p_bc`` for any p_bc in
    [0, 1].  Carried state: the slot clock, a Python int, so the rate p_t
    is a host scalar and the CPU and the GPU compare the draws with the
    same bits.  p_t follows the reference's float32 arithmetic; its sine is
    the float64 sine rounded to float32, where XLA's float32 sine can be
    one ulp apart (a uniform on its 2^-23 grid lands between the two with
    probability below 2^-23)."""
    period = max(1.0, float(period))
    day_frac = min(1.0, max(1e-6, float(day_frac)))
    p_bc = min(1.0, max(0.0, float(p_bc)))
    full_sine_mean = 2.0 / math.pi
    if p_bc <= day_frac * full_sine_mean:
        p_peak, base = p_bc / (day_frac * full_sine_mean), 0.0
    elif p_bc <= full_sine_mean:
        day_frac, p_peak, base = p_bc / full_sine_mean, 1.0, 0.0
    else:  # base + (1-base) * full-day sine, solved for the exact mean
        day_frac, p_peak = 1.0, 1.0
        base = (p_bc - full_sine_mean) / (1.0 - full_sine_mean)
    f32 = np.float32
    period32, day32, pi32 = f32(period), f32(day_frac), f32(math.pi)
    base32, scale32 = f32(base), f32((1.0 - base) * p_peak)

    def rate(clock: int) -> float:
        """p_t at slot ``clock``, a float32 value."""
        phase = f32(np.fmod(f32(clock), period32)) / period32  # [0, 1)
        intensity = f32(math.sin(float(pi32 * phase / day32))) if phase < day32 else f32(0.0)
        return float(base32 + scale32 * intensity)

    def init(draws, n: int) -> int:
        return 0

    def step(state, battery: torch.Tensor):
        clock, u, s = state
        return (u[s] < rate(clock)).to(torch.int32), (clock + 1, u, s + 1)

    return HarvestProcess("diurnal", True, float(p_bc), init, step, _no_draw, _uniforms())


def hetero(p_bc: float, concentration: float = 2.0) -> HarvestProcess:
    """Static per-client rates r_i ~ Beta(c*p_bc, c*(1-p_bc)), mean ``p_bc``;
    i.i.d. thinning per slot at each client's rate.  Carried state: the
    (N,) float32 rates, injected as drawn values (full ``p_bc`` when p_bc
    is 0 or 1, where the reference draws nothing)."""
    c = max(1e-3, float(concentration))
    degenerate = not (0.0 < p_bc < 1.0)

    def init(rates, n: int) -> torch.Tensor:
        if degenerate:
            return torch.full((n,), float(p_bc), dtype=torch.float32)
        return _need(rates, "hetero").to(torch.float32)

    def step(state, battery: torch.Tensor):
        rates, u, s = state
        return (u[s] < rates).to(torch.int32), (rates, u, s + 1)

    def init_draw(rng: np.random.Generator, n: int) -> np.ndarray | None:
        return None if degenerate else rng.beta(c * p_bc, c * (1.0 - p_bc), n).astype(np.float32)

    return HarvestProcess("hetero", True, float(p_bc), init, step, init_draw, _uniforms())


_FACTORIES: dict = {"bernoulli": bernoulli, "markov": markov, "diurnal": diurnal, "hetero": hetero}


def state_sharding_tree(name: str) -> bool | None:
    """Whether the process's carried state is per client (markov's phases,
    hetero's rates: a fleet shard holds its rows) or whole (diurnal's
    clock); None where it carries none.  With the draws injected and
    sliced (``core.draws.shard_draws``), the process's own ``init``/``step``
    on a shard's rows is its sharded form."""
    return {"bernoulli": None, "markov": True, "diurnal": False, "hetero": True}[name]


def make_process(name: str, p_bc: float, **params: float) -> HarvestProcess:
    """Build a named scenario; ``p_bc`` is the target mean rate for all of them."""
    if name not in _FACTORIES:
        raise ValueError(f"unknown harvest scenario {name!r}; known: {SCENARIOS}")
    return _FACTORIES[name](p_bc, **params)
