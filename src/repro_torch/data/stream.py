"""Streaming non-IID data: ``repro.data.stream``'s per-epoch data views,
fed by injected draws.

  * ``init(x, n) -> state``: the state carried across epochs, from the
    scenario's ``init_draw`` (``None`` where it carries nothing);
  * ``step(state, t, labels, draws) -> (idx, state)``: one epoch.  ``idx``
    is an (N, n_pool) int64 index map into each client's pool (the epoch's
    view), or ``None`` for the identity; ``labels`` are the pool labels
    (N, n_pool); ``draws`` is ``EpochDraws.stream``;
  * ``init_draw(rng, n)`` / ``epoch_draw(g, n, n_pool)`` draw what ``init``
    and ``step`` consume (``core.draws.TorchDraws`` calls them).

Views keep the pool shape, so every scenario trains on the same per-epoch
sample budget.

  static   the frozen partition (identity view; no state, no draws).
  drift    per-client label mixtures pi_i ~ Dir(alpha) (injected) rotating
           through class space with period ``period`` epochs; the view
           resamples the pool with weights pi_i(t)[label].
  arrival  samples arrive over time into a sliding window of the last
           ``window`` arrivals; the view wraps over the occupied window.
  shift    class-incremental: the active class group swaps every
           ``period`` epochs; the view resamples the pool restricted to it.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

SCENARIOS = ("static", "drift", "arrival", "shift")
# scenarios whose factories take a num_classes param: the simulator passes
# the backend's class count for these unless stream_params overrides it
CLASS_CONDITIONED = ("drift", "shift")


class DataStream(NamedTuple):
    name: str
    persistent: bool  # steps every epoch on its own draws (static does not)
    init: Callable[[Any, int], Any]
    step: Callable[[Any, int, torch.Tensor, Any], Tuple[Optional[torch.Tensor], Any]]
    init_draw: Callable[[np.random.Generator, int], Any]
    epoch_draw: Callable[[torch.Generator, int, int], Any]
    # (state, t, labels) -> (N, n_pool) sampling weights of the weighted
    # views (drift, shift), which ``step`` draws from through ``view_cdf``
    weights: Optional[Callable[[Any, int, torch.Tensor], torch.Tensor]] = None
    # the client axis of ``epoch_draw``'s tensor (a fleet shard takes its
    # rows there, ``core.draws.shard_draws``): 1 for arrival's (2, N)
    draw_axis: int = 0


def apply_view(idx: Optional[torch.Tensor], images: torch.Tensor, labels: torch.Tensor):
    """Gather the epoch view from per-client pools; ``idx=None`` = identity."""
    if idx is None:
        return images, labels
    rows = torch.arange(images.shape[0], device=images.device)[:, None]
    return images[rows, idx], torch.gather(labels, 1, idx)


def _no_init_draw(rng: np.random.Generator, n: int) -> None:
    return None


def _pool_uniforms(g: torch.Generator, n: int, n_pool: int) -> torch.Tensor:
    return torch.rand(n, n_pool, generator=g)


def _need(x: Any, what: str) -> Any:
    if x is None:
        raise ValueError(f"the {what} stream needs its draws (core.draws)")
    return x


def view_cdf(weights: torch.Tensor) -> torch.Tensor:
    """The float32 (N, n_pool) CDF of each row's weights; rows whose
    weights sum to <= 1e-12 fall back to a uniform view of the pool.

    The reference's float32 normalisation and cumsum, with the sums
    accumulated in float64 and rounded to float32 (torch's CPU cumsum
    already accumulates so): a float32 sum's value depends on its order,
    which differs between the CPU and the GPU, and a uniform near a CDF
    edge would then pick another sample on each."""

    def sum32(x: torch.Tensor) -> torch.Tensor:
        return x.to(torch.float64).sum(dim=1, keepdim=True).to(torch.float32)

    w = torch.where(sum32(weights) > 1e-12, weights, torch.ones_like(weights))
    w = w / sum32(w)
    return w.to(torch.float64).cumsum(dim=1).to(torch.float32)


def _sample_weighted(u: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """With-replacement categorical view ``idx[i, j] ~ weights[i, :]`` by
    inverse CDF (``searchsorted(side="right")``) over the explicit
    (N, n_pool) uniforms ``u``."""
    idx = torch.searchsorted(view_cdf(weights), u.contiguous(), right=True)
    return idx.clamp(max=weights.shape[1] - 1)


def static() -> DataStream:
    """The frozen partition: identity view, no state, no draws."""

    def step(state, t: int, labels: torch.Tensor, draws):
        return None, None

    return DataStream("static", False, lambda x, n: None, step, _no_init_draw, lambda g, n, n_pool: None)


def rotate_mixture(pi: torch.Tensor, t: int, period: float) -> torch.Tensor:
    """Circularly rotate per-client class mixtures ``pi`` (N, C) by
    ``t * C / period`` classes, linearly interpolating fractional shifts.
    The shift is the reference's float32 scalar arithmetic, on the host."""
    C = pi.shape[1]
    f32 = np.float32
    s = f32(np.fmod(f32(t), f32(period))) * f32(C / period)
    lo = int(np.floor(s))
    f = float(s - f32(lo))
    cols = torch.arange(C, device=pi.device)
    return (1.0 - f) * pi[:, (cols - lo) % C] + f * pi[:, (cols - lo - 1) % C]


def drift(alpha: float = 0.5, period: float = 100.0, num_classes: float = 10) -> DataStream:
    """Rotating per-client Dirichlet label mixtures: pi_i ~ Dir(alpha * 1_C)
    once (injected); at epoch t the view resamples the pool with weights
    ``rotate_mixture(pi, t, period)[label]``."""
    C = int(num_classes)
    period = max(1.0, float(period))
    a = max(1e-3, float(alpha))

    def init(pi, n: int) -> torch.Tensor:
        return _need(pi, "drift").to(torch.float32)

    def weights(pi, t: int, labels: torch.Tensor) -> torch.Tensor:
        return torch.gather(rotate_mixture(pi, t, period), 1, labels)

    def step(pi, t: int, labels: torch.Tensor, u):
        return _sample_weighted(_need(u, "drift"), weights(pi, t, labels)), pi

    def init_draw(rng: np.random.Generator, n: int) -> np.ndarray:
        return rng.dirichlet(np.full(C, a), n).astype(np.float32)

    return DataStream("drift", True, init, step, init_draw, _pool_uniforms, weights)


def arrival_occupancy(count: torch.Tensor, window: int, n_pool: int) -> torch.Tensor:
    """Occupied width of the sliding window: min(arrived, window), >= 1."""
    w = n_pool if window <= 0 else min(int(window), n_pool)
    return count.clamp(1, w)


def arrival(rate: float = 2.0, burst: float = 1.0, window: float = 0, warm: float = 1) -> DataStream:
    """Streaming arrivals into a sliding window: each epoch a burst of mean
    size ``b = max(1, burst, rate)`` arrives w.p. ``rate / b``; the view
    wraps over the most recent ``min(arrived, window)`` samples of the pool
    (the client's stream in arrival order).  State: the (N,) int32 arrival
    counts.  Draws: (2, N) uniforms per epoch (hit, extra)."""
    rate = max(0.0, float(rate))
    b = max(1.0, float(burst), rate)
    p_burst = 0.0 if b == 0 else rate / b
    base, frac = int(b), b - int(b)
    window = int(window)
    warm = max(1, int(warm))

    def init(draws, n: int) -> torch.Tensor:
        return torch.full((n,), warm, dtype=torch.int32)

    def step(count, t: int, labels: torch.Tensor, u):
        n_pool = labels.shape[1]
        u = _need(u, "arrival")
        hit, extra = u[0] < p_burst, u[1] < frac
        count = count + torch.where(hit, base + extra.to(torch.int32), 0).to(torch.int32)
        occ = arrival_occupancy(count, window, n_pool)
        j = torch.arange(n_pool, dtype=torch.int32, device=count.device)[None, :]
        # floor modulo of negative numbers, as jnp's %
        idx = torch.remainder(count[:, None] - 1 - torch.remainder(j, occ[:, None]), n_pool)
        return idx.to(torch.int64), count

    def epoch_draw(g: torch.Generator, n: int, n_pool: int) -> torch.Tensor:
        return torch.rand(2, n, generator=g)

    return DataStream("arrival", True, init, step, _no_init_draw, epoch_draw, draw_axis=1)


def class_group(labels: torch.Tensor, num_phases: int, num_classes: int) -> torch.Tensor:
    """Contiguous class group of each label: C classes -> P blocks."""
    return torch.div(labels * num_phases, num_classes, rounding_mode="floor")


def shift(period: float = 50.0, num_phases: float = 2, num_classes: float = 10) -> DataStream:
    """Class-incremental swaps: the active class group ``(t // period) %
    num_phases`` swaps every ``period`` epochs; the view resamples each pool
    restricted to active-class samples (uniform fallback when a client
    holds none)."""
    period = max(1, int(period))
    P = max(1, int(num_phases))
    C = int(num_classes)

    def weights(state, t: int, labels: torch.Tensor) -> torch.Tensor:
        phase = (int(t) // period) % P
        return (class_group(labels, P, C) == phase).to(torch.float32)

    def step(state, t: int, labels: torch.Tensor, u):
        return _sample_weighted(_need(u, "shift"), weights(state, t, labels)), None

    return DataStream("shift", True, lambda x, n: None, step, _no_init_draw, _pool_uniforms, weights)


_FACTORIES: dict = {"static": static, "drift": drift, "arrival": arrival, "shift": shift}


def state_sharding_tree(name: str) -> bool | None:
    """Whether the scenario's carried state is per client (a fleet shard
    holds its rows) or whole; None where it carries none.  With the draws
    injected and sliced (``core.draws.shard_draws``), the scenario's own
    ``init``/``step`` on a shard's rows is its sharded form."""
    return {"static": None, "drift": True, "arrival": True, "shift": None}[name]


def make_stream(name: str, **params: float) -> DataStream:
    """Build a named streaming scenario (config-side:
    ``EHFLConfig(stream="name", stream_params=(("k", v),))``)."""
    if name not in _FACTORIES:
        raise ValueError(f"unknown stream scenario {name!r}; known: {SCENARIOS}")
    return _FACTORIES[name](**params)
