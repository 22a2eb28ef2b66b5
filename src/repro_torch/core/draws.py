"""Injected random draws (no counterpart in the JAX package).

``torch.Generator`` cannot reproduce ``jax.random``, so the port draws
nothing inside the simulator: each epoch takes an :class:`EpochDraws` from
a draw source, and ``init_carry`` takes the scenarios' one-off draws as an
:class:`InitDraws`.  Every draw the simulator consumes is data-independent,
so a test can replay the reference's key chains into :class:`ReplayDraws`
up front and hold the port to the reference bit for bit.

What each scenario draws, and its shape, belongs to the scenario: every
harvest, stream and channel process carries an ``init_draw`` (numpy
generator, N) and an ``epoch_draw`` (torch generator, shapes) function.
The reference's ``bernoulli(k, p, shape)`` is ``uniform(k, shape) < p``,
so the scenarios draw uniforms and compare them themselves; the Beta and
Dirichlet draws (``hetero``, ``erasure``, ``drift``) are injected as values.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Protocol

import numpy as np
import torch


class EpochDraws(NamedTuple):
    # (N,) float32 selection noise: the U[0, 1e-3) Alg. 2 tie-break for
    # ``vaoi``; standard Gumbel for ``vaoi_soft``; unread by other policies
    noise: torch.Tensor
    # per-slot harvest draws, slot axis second to last: (S, N) bool arrivals
    # for ``bernoulli``, (S, N) float32 uniforms for ``diurnal``/``hetero``,
    # (2, S, N) for ``markov`` (arrivals, phase flips)
    harvest: torch.Tensor
    perms: torch.Tensor  # (N, kappa*bs) int64 per-client SGD sample order
    # the stream's draws: (N, n_pool) uniforms (``drift``, ``shift``), (2, N)
    # (``arrival``: hit, extra); None for ``static``
    stream: Any = None
    # the channel's draws: (N,) uniforms (``erasure``, ``fading``), (N,)
    # int64 channel choices (``aloha``); None for ``ideal``
    channel: Any = None


class InitDraws(NamedTuple):
    """The scenarios' one-off draws at ``init_carry``, as numpy arrays (None
    where a scenario draws nothing): harvest (``markov`` phase uniforms,
    ``hetero`` Beta rates), stream (``drift`` Dirichlet mixtures), channel
    (``erasure`` Beta rates, ``fading`` link uniforms)."""

    harvest: Any = None
    stream: Any = None
    channel: Any = None


def _window(x: Any, axis: int, off: int, n: int) -> Any:
    """Rows ``[off, off + n)`` of ``x`` (a tensor or numpy array) along ``axis``."""
    if x is None:
        return None
    axis %= x.ndim
    return x[(slice(None),) * axis + (slice(off, off + n),)]


def shard_draws(draws: EpochDraws | InitDraws, off: int, n: int, stream_axis: int = 0) -> EpochDraws | InitDraws:
    """A fleet shard's window: clients ``[off, off + n)`` of the global
    draws, along each field's client axis (see :class:`EpochDraws`; every
    field of :class:`InitDraws` has it first).  ``stream_axis`` is the
    stream's (``DataStream.draw_axis``: 1 for ``arrival``'s (2, N)).
    Every rank draws the whole epoch from the same source and keeps its
    rows, so a sharded run consumes the solo run's draws bit for bit (the
    reference's global-draw-and-slice)."""
    if isinstance(draws, InitDraws):
        return InitDraws(*(_window(x, 0, off, n) for x in draws))
    return EpochDraws(
        noise=_window(draws.noise, 0, off, n),
        harvest=_window(draws.harvest, -1, off, n),
        perms=_window(draws.perms, 0, off, n),
        stream=_window(draws.stream, stream_axis, off, n),
        channel=_window(draws.channel, 0, off, n),
    )


def sgd_batch_size(kappa: int, n_samples: int) -> int:
    """Local minibatch size bs = n // kappa (at least 1)."""
    return max(1, n_samples // kappa)


class DrawSource(Protocol):
    def init(self, cfg, num_classes: int) -> InitDraws: ...

    def epoch(self, t: int, cfg, n_samples: int, device: torch.device) -> EpochDraws: ...


# torch's CPU generator keeps only the low 32 bits of its seed, so each
# seed's epochs start a golden-ratio step apart in that space: seed 0's
# epoch t is seeded with t, and no two (seed, epoch) pairs of a sweep meet
_SEED_STEP = 0x9E3779B9


def epoch_seed(seed: int, t: int) -> int:
    """The 32-bit ``torch.Generator`` seed of epoch ``t`` of run ``seed``."""
    return (int(t) + int(seed) * _SEED_STEP) & 0xFFFFFFFF


class TorchDraws:
    """The default source.  Epoch ``t`` draws on its own CPU
    ``torch.Generator`` seeded with ``epoch_seed(seed, t)`` in a fixed
    order (noise, harvest, perms, stream, channel), and the result moves to
    the device in one copy: a CPU and a GPU run with the same seed see the
    same bits.  The default scenarios draw no stream or channel draws.  The
    one-off draws come from numpy's ``default_rng([seed, 1])`` (a stream
    apart from the data's ``default_rng(seed)``), in the order harvest,
    stream, channel."""

    def __init__(self, seed: int = 0):
        self.seed = int(seed)

    def init(self, cfg, num_classes: int) -> InitDraws:
        rng = np.random.default_rng([self.seed, 1])
        n = cfg.num_clients
        return InitDraws(
            cfg.harvest_process().init_draw(rng, n),
            cfg.data_stream(num_classes).init_draw(rng, n),
            cfg.channel_process().init_draw(rng, n),
        )

    def epoch(self, t: int, cfg, n_samples: int, device: torch.device) -> EpochDraws:
        g = torch.Generator().manual_seed(epoch_seed(self.seed, t))
        n, s = cfg.num_clients, cfg.slots_per_epoch
        u = torch.rand(n, generator=g)
        if cfg.policy == "vaoi_soft":
            tiny = torch.finfo(torch.float32).tiny
            noise = -torch.log(-torch.log(u.clamp_min(tiny)))
        else:
            noise = u * 1e-3
        harvest = cfg.harvest_process().epoch_draw(g, s, n)
        m = cfg.kappa * sgd_batch_size(cfg.kappa, n_samples)
        perms = torch.argsort(torch.rand(n, n_samples, generator=g), dim=1)[:, :m]
        stream = cfg.data_stream().epoch_draw(g, n, n_samples)
        channel = cfg.channel_process().epoch_draw(g, n)
        return EpochDraws(
            noise.to(device), harvest.to(device), perms.to(device), _to(stream, device), _to(channel, device)
        )


def _to(x: torch.Tensor | None, device: torch.device) -> torch.Tensor | None:
    return None if x is None else x.to(device)


def _replay_array(x: Any) -> np.ndarray | None:
    """Keep a recorded draw's kind: bool stays bool, integers int64, floats float32."""
    if x is None:
        return None
    x = np.asarray(x)
    if x.dtype == bool:
        return x
    return x.astype(np.int64 if np.issubdtype(x.dtype, np.integer) else np.float32)


class ReplayDraws:
    """Replays given numpy draws: ``noise`` (T, N), ``harvest`` (T, ..., S,
    N), ``perms`` (T, N, kappa*bs), optionally ``stream`` (T, ...) and
    ``channel`` (T, N); epoch ``t`` takes row ``t`` of each.  ``init`` holds
    the one-off draws (numpy arrays) for ``init_carry``."""

    def __init__(
        self,
        noise: np.ndarray,
        harvest: np.ndarray,
        perms: np.ndarray,
        stream: np.ndarray | None = None,
        channel: np.ndarray | None = None,
        init: InitDraws | None = None,
    ):
        self.noise = np.asarray(noise, np.float32)
        self.harvest = _replay_array(harvest)
        self.perms = np.asarray(perms, np.int64)
        self.stream, self.channel = _replay_array(stream), _replay_array(channel)
        self.init_draws = InitDraws(*(_replay_array(x) for x in (init or InitDraws())))
        lengths = {len(x) for x in (self.noise, self.harvest, self.perms, self.stream, self.channel) if x is not None}
        if len(lengths) != 1:
            raise ValueError("the recorded draws must cover the same epochs")

    def init(self, cfg, num_classes: int) -> InitDraws:
        return self.init_draws

    def epoch(self, t: int, cfg, n_samples: int, device: torch.device) -> EpochDraws:
        if t >= len(self.noise):
            raise IndexError(f"no draws recorded for epoch {t} (have {len(self.noise)})")
        n, s = cfg.num_clients, cfg.slots_per_epoch
        m = cfg.kappa * sgd_batch_size(cfg.kappa, n_samples)
        noise, harvest, perms = self.noise[t], self.harvest[t], self.perms[t]
        if noise.shape != (n,) or harvest.shape[-2:] != (s, n) or perms.shape != (n, m):
            raise ValueError(
                f"epoch {t} draws have shapes {noise.shape}, {harvest.shape}, {perms.shape}; "
                f"expected {(n,)}, (..., {s}, {n}), {(n, m)}"
            )
        rows = [noise, harvest, perms] + [None if x is None else x[t] for x in (self.stream, self.channel)]
        return EpochDraws(*(None if x is None else torch.from_numpy(x).to(device) for x in rows))
