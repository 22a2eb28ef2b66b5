"""Lossy-uplink channels: ``repro.core.channel``'s four scenarios, fed by
injected draws.

  * ``init(x, n) -> state``: the state carried across epochs, from the
    scenario's ``init_draw`` (``None`` where it draws nothing);
  * ``step(state, attempting, draws) -> (delivered, state)``: one epoch.
    ``attempting`` is the (N,) bool mask of clients that spent a
    transmission unit; ``delivered`` the subset whose message landed;
    ``draws`` is ``EpochDraws.channel``;
  * ``init_draw(rng, n)`` / ``epoch_draw(g, n)`` draw what ``init`` and
    ``step`` consume (``core.draws.TorchDraws`` calls them).

What happens to a failed upload (retry, capped exponential backoff,
re-aging, drop) is the simulator's retry machine, not the channel's.

  ideal    always delivers; no state, no draws (the default).
  erasure  i.i.d. loss at ``p_loss``; with ``concentration`` c > 0 static
           per-client rates from Beta(c·p_loss, c·(1−p_loss)), injected.
  aloha    ``num_channels``-channel slotted ALOHA: each attempting client
           is on its injected channel; a channel carrying exactly one
           upload delivers it, collisions destroy all of them.
  fading   Gilbert–Elliott good/bad link per client: good delivers, bad is
           outage; ``p_bad`` stationary bad fraction, ``sojourn`` the
           phase-relaxation timescale.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.profiler import record_function

SCENARIOS = ("ideal", "erasure", "aloha", "fading")


class ChannelProcess(NamedTuple):
    name: str
    persistent: bool  # state survives across epochs (ideal carries none)
    init: Callable[[Any, int], Any]
    step: Callable[[Any, torch.Tensor, Any], Tuple[torch.Tensor, Any]]
    init_draw: Callable[[np.random.Generator, int], Any]
    epoch_draw: Callable[[torch.Generator, int], Any]


def _no_init_draw(rng: np.random.Generator, n: int) -> None:
    return None


def _uniforms(g: torch.Generator, n: int) -> torch.Tensor:
    return torch.rand(n, generator=g)


def _need(x: Any, what: str) -> Any:
    if x is None:
        raise ValueError(f"the {what} channel needs its draws (core.draws)")
    return x


def ideal() -> ChannelProcess:
    """Always deliver: no state, no draws."""

    def step(state, attempting: torch.Tensor, draws):
        return attempting, None

    return ChannelProcess("ideal", False, lambda x, n: None, step, _no_init_draw, lambda g, n: None)


def erasure(p_loss: float = 0.2, concentration: float = 0.0) -> ChannelProcess:
    """i.i.d. per-upload erasures at mean rate ``p_loss``; ``concentration``
    c > 0 takes static per-client rates from Beta(c·p, c·(1−p)).  An upload
    is delivered where its uniform is >= its client's rate."""
    p = min(1.0, max(0.0, float(p_loss)))
    c = float(concentration)
    hetero = c > 0.0 and 0.0 < p < 1.0

    def init(rates, n: int) -> torch.Tensor:
        if hetero:
            return _need(rates, "erasure").to(torch.float32)
        return torch.full((n,), p, dtype=torch.float32)

    def step(rates, attempting: torch.Tensor, u):
        return attempting & (_need(u, "erasure") >= rates), rates

    def init_draw(rng: np.random.Generator, n: int) -> np.ndarray | None:
        return rng.beta(c * p, c * (1.0 - p), n).astype(np.float32) if hetero else None

    return ChannelProcess("erasure", True, init, step, init_draw, _uniforms)


def aloha(num_channels: float = 2, group: Any = None) -> ChannelProcess:
    """M-channel slotted ALOHA on the injected (N,) channel choices:
    exactly-one occupancy delivers, collisions destroy every colliding
    upload.  The reference's key is its only state; the port's is None.
    With a ``torch.distributed`` ``group`` (the fleet's shards), each
    shard's contention counts are all-reduced over the group before the
    exactly-one test: a collision can span shards."""
    M = max(1, int(num_channels))

    def step(state, attempting: torch.Tensor, choice):
        choice = _need(choice, "aloha")
        counts = torch.zeros(M, dtype=torch.int32, device=attempting.device)
        counts.index_add_(0, choice, attempting.to(torch.int32))
        if group is not None:
            with record_function("ehfl.fleet.channel"):
                dist.all_reduce(counts, group=group)
        return attempting & (counts[choice] == 1), None

    def epoch_draw(g: torch.Generator, n: int) -> torch.Tensor:
        return torch.randint(0, M, (n,), generator=g)

    return ChannelProcess("aloha", True, lambda x, n: None, step, _no_init_draw, epoch_draw)


def fading(p_bad: float = 0.3, sojourn: float = 4.0) -> ChannelProcess:
    """Gilbert–Elliott per-client link: good delivers, bad is outage.
    State: the (N,) bool link phases, good where the init uniform is below
    1 − p_bad; each epoch a phase flips where its uniform is below g2b
    (good) or b2g (bad)."""
    pb = min(1.0, max(0.0, float(p_bad)))
    sojourn = max(1.0, float(sojourn))
    g2b = pb / sojourn  # good -> bad
    b2g = (1.0 - pb) / sojourn  # bad -> good

    def init(u_good, n: int) -> torch.Tensor:
        return _need(u_good, "fading") < (1.0 - pb)

    def step(good, attempting: torch.Tensor, u):
        flip = _need(u, "fading") < torch.where(good, g2b, b2g)  # float32, as jnp.where's
        return attempting & good, good ^ flip

    def init_draw(rng: np.random.Generator, n: int) -> np.ndarray:
        return rng.random(n, dtype=np.float32)

    return ChannelProcess("fading", True, init, step, init_draw, _uniforms)


_FACTORIES: dict = {"ideal": ideal, "erasure": erasure, "aloha": aloha, "fading": fading}


def make_channel(name: str, **params: float) -> ChannelProcess:
    """Build a named channel scenario (config-side:
    ``EHFLConfig(channel="name", channel_params=(("k", v),))``)."""
    if name not in _FACTORIES:
        raise ValueError(f"unknown channel scenario {name!r}; known: {SCENARIOS}")
    return _FACTORIES[name](**params)


def make_sharded_channel(name: str, group: Any, **params: float) -> ChannelProcess:
    """The channel of a fleet shard: ``init``/``step`` on the shard's rows
    and its window of the global draws (``core.draws.shard_draws``).  Only
    ALOHA couples clients, so only its form differs from
    :func:`make_channel`'s: its contention counts are all-reduced over
    ``group``."""
    if name == "aloha":
        return aloha(group=group, **params)
    return make_channel(name, **params)


def state_sharding_tree(name: str) -> bool | None:
    """Whether the channel's carried state is per client (erasure's rates,
    fading's link phases: a fleet shard holds its rows); None where it
    carries none."""
    return {"ideal": None, "erasure": True, "aloha": None, "fading": True}[name]
