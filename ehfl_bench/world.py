"""What a cell is made of, from its files and the seed: the simulator's
configuration and a draw source that draws each epoch afresh on the device.  The model's part (data, weights, the
port's backend, the plain reference) comes from ``families/<family>.py``.

Every input is made here from ``--seed`` and handed alike to the port and
to the reference.  Nothing here is timed: it is set-up.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict

import torch

BENCH = Path(__file__).resolve().parent


def load_json(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def merged(base: Dict[str, Any], over: Dict[str, Any]) -> Dict[str, Any]:
    """``base`` with ``over``'s keys laid on it, nested dicts key by key."""
    out = dict(base)
    for k, v in over.items():
        out[k] = merged(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


def load_cell(name: str, tiny: bool = False, bench: Path = BENCH) -> Dict[str, Any]:
    """The cell ``workloads/<name>.json`` with its configuration
    ``configs/<config>.json`` under ``"model_config"``; ``tiny`` lays each
    file's ``"tiny"`` section over it (the CPU tests' size)."""
    path = bench / "workloads" / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no cell {name!r}: {path} is missing")
    cell = load_json(path)
    config = load_json(bench / "configs" / f"{cell['config']}.json")
    if tiny:
        cell, config = merged(cell, cell.get("tiny", {})), merged(config, config.get("tiny", {}))
    cell.pop("tiny", None)
    config.pop("tiny", None)
    cell["name"], cell["model_config"] = name, config
    return cell


def seed_words(seed: int, salt: int) -> int:
    """A 63-bit generator seed for one stream of draws of run ``seed``
    (any whole number, also one past 32 bits)."""
    return (int(seed) * 0x9E3779B97F4A7C15 + salt * 0xBF58476D1CE4E5B9) % (1 << 63)


def ehfl_config(cell: Dict[str, Any], seed: int):
    """The port's ``EHFLConfig`` of the cell: the configuration's EHFL
    settings, then the cell's ``sim`` keys."""
    from repro_torch.core.simulator import EHFLConfig

    settings = dict(cell["model_config"]["ehfl"])
    settings.update(cell["sim"])
    keys = EHFLConfig.__dataclass_fields__
    kw = {k: v for k, v in settings.items() if k in keys}
    return EHFLConfig(seed=int(seed) % (1 << 31), epochs=1 << 30, **kw)


class FreshDraws:
    """The source's draws, fresh every epoch as ``TorchDraws`` makes them,
    but on the device: epoch ``t`` draws (noise, harvest, perms) in that
    order from a device generator seeded with (seed, t), so a run's epochs
    never repeat and the reference can draw any epoch again.  Every seed
    gets the same shapes.  Bernoulli arrivals, static stream and the ideal
    channel draw nothing else, and nothing at the start (``InitDraws()``)."""

    def __init__(self, cfg, n_samples: int, seed: int, device: torch.device):
        self.n, self.s, self.p_bc, self.seed, self.device = cfg.num_clients, cfg.slots_per_epoch, cfg.p_bc, seed, device
        self.n_samples, self.m = n_samples, cfg.kappa * max(1, n_samples // cfg.kappa)

    def init(self, cfg, num_classes: int):
        from repro_torch.core.draws import InitDraws

        return InitDraws()

    def draw(self, t: int):
        g = torch.Generator(device=self.device).manual_seed(seed_words(self.seed, 16 + t))
        noise = torch.rand(self.n, generator=g, device=self.device) * 1e-3
        harvest = torch.rand(self.s, self.n, generator=g, device=self.device) < self.p_bc
        perms = torch.argsort(torch.rand(self.n, self.n_samples, generator=g, device=self.device), dim=-1)
        return noise, harvest, perms[:, : self.m]

    def epoch(self, t: int, cfg, n_samples: int, device: torch.device):
        from repro_torch.core.draws import EpochDraws

        noise, harvest, perms = self.draw(t)
        return EpochDraws(noise=noise, harvest=harvest, perms=perms)

    def host(self, t: int) -> Dict[str, Any]:
        """Epoch ``t``'s draws again, as numpy arrays, for the reference."""
        noise, harvest, perms = self.draw(t)
        return {"noise": noise.cpu().numpy(), "harvest": harvest.cpu().numpy(), "perms": perms.cpu().numpy()}


def make_draws(cfg, n_samples: int, seed: int, device: torch.device) -> FreshDraws:
    for name in ("harvest", "stream", "channel"):
        want = {"harvest": "bernoulli", "stream": "static", "channel": "ideal"}[name]
        if getattr(cfg, name) != want:
            raise ValueError(f"the draw source makes {want} draws only; the cell asks for {name} {getattr(cfg, name)!r}")
    if cfg.policy not in ("vaoi", "fedavg"):
        raise ValueError(f"policy {cfg.policy!r}: the reference follows vaoi and fedavg")
    return FreshDraws(cfg, n_samples, seed, device)
