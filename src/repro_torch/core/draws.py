"""Injected random draws (no counterpart in the JAX package).

``torch.Generator`` cannot reproduce ``jax.random``, so the port draws
nothing inside the epoch: each epoch takes an :class:`EpochDraws` from a
draw source.  Every draw the main path consumes is data-independent, so a
test can replay the reference's key chain into :class:`ReplayDraws` up
front and hold the port to the reference bit for bit.
"""
from __future__ import annotations

from typing import NamedTuple, Protocol

import numpy as np
import torch


class EpochDraws(NamedTuple):
    # (N,) float32 selection noise: the U[0, 1e-3) Alg. 2 tie-break for
    # ``vaoi``; standard Gumbel for ``vaoi_soft``; unread by other policies
    noise: torch.Tensor
    harvest: torch.Tensor  # (S, N) bool per-slot Bernoulli arrivals
    perms: torch.Tensor  # (N, kappa*bs) int64 per-client SGD sample order


def sgd_batch_size(kappa: int, n_samples: int) -> int:
    """Local minibatch size bs = n // kappa (at least 1)."""
    return max(1, n_samples // kappa)


class DrawSource(Protocol):
    def epoch(self, t: int, cfg, n_samples: int, device: torch.device) -> EpochDraws: ...


class TorchDraws:
    """The default source.  Epoch ``t`` draws on its own CPU
    ``torch.Generator`` seeded from ``(seed, t)`` in a fixed order, and the
    result moves to the device in one copy: a CPU and a GPU run with the
    same seed see the same bits."""

    def __init__(self, seed: int = 0):
        self.seed = int(seed)

    def epoch(self, t: int, cfg, n_samples: int, device: torch.device) -> EpochDraws:
        g = torch.Generator().manual_seed((self.seed << 32) + int(t))
        n, s = cfg.num_clients, cfg.slots_per_epoch
        u = torch.rand(n, generator=g)
        if cfg.policy == "vaoi_soft":
            tiny = torch.finfo(torch.float32).tiny
            noise = -torch.log(-torch.log(u.clamp_min(tiny)))
        else:
            noise = u * 1e-3
        harvest = torch.rand(s, n, generator=g) < cfg.p_bc
        m = cfg.kappa * sgd_batch_size(cfg.kappa, n_samples)
        perms = torch.argsort(torch.rand(n, n_samples, generator=g), dim=1)[:, :m]
        return EpochDraws(noise.to(device), harvest.to(device), perms.to(device))


class ReplayDraws:
    """Replays given numpy draws: ``noise`` (T, N), ``harvest`` (T, S, N),
    ``perms`` (T, N, kappa*bs); epoch ``t`` takes row ``t`` of each."""

    def __init__(self, noise: np.ndarray, harvest: np.ndarray, perms: np.ndarray):
        self.noise = np.asarray(noise, np.float32)
        self.harvest = np.asarray(harvest, bool)
        self.perms = np.asarray(perms, np.int64)
        if not (len(self.noise) == len(self.harvest) == len(self.perms)):
            raise ValueError("noise, harvest and perms must cover the same epochs")

    def epoch(self, t: int, cfg, n_samples: int, device: torch.device) -> EpochDraws:
        if t >= len(self.noise):
            raise IndexError(f"no draws recorded for epoch {t} (have {len(self.noise)})")
        n, s = cfg.num_clients, cfg.slots_per_epoch
        m = cfg.kappa * sgd_batch_size(cfg.kappa, n_samples)
        noise, harvest, perms = self.noise[t], self.harvest[t], self.perms[t]
        if noise.shape != (n,) or harvest.shape != (s, n) or perms.shape != (n, m):
            raise ValueError(
                f"epoch {t} draws have shapes {noise.shape}, {harvest.shape}, {perms.shape}; "
                f"expected {(n,)}, {(s, n)}, {(n, m)}"
            )
        return EpochDraws(
            torch.from_numpy(noise).to(device),
            torch.from_numpy(harvest).to(device),
            torch.from_numpy(perms).to(device),
        )
