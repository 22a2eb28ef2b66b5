"""The shared EHFL sweep behind the torch Fig. 4 / 5 / 6 benchmarks: the
PyTorch/CUDA port's counterpart of ``benchmarks/ehfl_grid.py``.

The same protocol (§V) cut to size: N, T and the samples per client shrink,
every structural constant stays (S=30, kappa=20, E_max=kappa+5, k scaled to
N, mu=0.5, the Dirichlet alpha grid, the p_bc grid).  Each (policy, alpha,
p_bc, scenario) cell is one multi-seed ``repro_torch.core.run_batch`` (the
seeds one after another on one device); its record has the JAX grid's keys,
scalar fields ("f1", "avg_age", "energy_per_epoch", "total_energy") the
means across seeds and per-seed values under ``*_per_seed``.

The data partition is the port's own (``repro_torch.data``): a torch
generator cannot replay ``jax.random``, so a cell's numbers are the same
experiment as the JAX grid's, not the same draws.  ``run_cell`` takes
``data``, ``draws`` and ``params`` to run a cell on given inputs instead.

Results are cached to experiments/ehfl_grid_torch/<tag>.json (delete the
directory to force a fresh run).  Runs on the GPU unless ``--device`` says
otherwise:

  PYTHONPATH=src python benchmarks/ehfl_grid_torch.py --quick            # scenario gallery
  PYTHONPATH=src python benchmarks/ehfl_grid_torch.py --quick --grid     # + the policy grid
  PYTHONPATH=src python benchmarks/ehfl_grid_torch.py --quick --device cpu
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path
from typing import Sequence

import torch

from repro_torch.configs.cifar_cnn import CNNConfig
from repro_torch.core import SCENARIOS, EHFLConfig, run_batch
from repro_torch.data import make_federated_dataset
from repro_torch.device import resolve_device
from repro_torch.fl import cnn_backend

CACHE = Path(__file__).resolve().parent.parent / "experiments" / "ehfl_grid_torch"

BENCH_CNN = CNNConfig(name="bench", image_size=16, conv_channels=(8, 8, 16, 16, 32, 32), fc_dims=(64, 32))

POLICIES = ("vaoi", "fedavg", "fedbacys", "fedbacys_odd")

# the partition depends only on (N, samples, alpha, seed, device): cells
# that share it reuse it
_DATA_CACHE: dict = {}


def _bench_data(num_clients: int, samples: int, alpha: float, seed: int, device: torch.device):
    key = (num_clients, samples, alpha, seed, str(device))
    if key not in _DATA_CACHE:
        _DATA_CACHE[key] = make_federated_dataset(
            seed, num_clients=num_clients, samples_per_client=samples, alpha=alpha, test_size=300,
            image_size=BENCH_CNN.image_size, device=device,
        )
    return _DATA_CACHE[key]


def grid_settings(quick: bool):
    if quick:
        return dict(alphas=(0.1, 1.0), pbcs=(0.1, 1.0), num_clients=16, samples=40, epochs=30, eval_every=6, k=4,
                    seeds=(0, 1))
    return dict(alphas=(0.1, 1.0, 10.0), pbcs=(0.01, 0.1, 1.0), num_clients=40, samples=120, epochs=120,
                eval_every=10, k=8, seeds=(0, 1, 2))


def cell_config(policy: str, alpha: float, p_bc: float, st: dict, seed: int = 0,
                scenario: str = "bernoulli") -> EHFLConfig:
    """The simulator config of one cell (the JAX grid's fields)."""
    return EHFLConfig(
        num_clients=st["num_clients"], epochs=st["epochs"], slots_per_epoch=30, kappa=20, p_bc=p_bc, k=st["k"],
        mu=0.5, e_max=25, policy=policy, alpha=alpha, seed=seed, eval_every=st["eval_every"], probe_size=20,
        harvest=scenario,
    )


def run_cell(
    policy: str,
    alpha: float,
    p_bc: float,
    st: dict,
    seed: int = 0,
    scenario: str = "bernoulli",
    seeds: Sequence[int] | None = None,
    *,
    data: dict | None = None,
    draws: Sequence | None = None,
    params: Sequence | None = None,
    device: str | torch.device | None = None,
) -> dict:
    """One sweep cell: all ``seeds`` through one ``run_batch``.

    ``seed`` is the base seed (data partition and the sweep's offset);
    ``seeds`` defaults to ``st["seeds"]`` shifted by it.  ``data`` (client
    pools and test set), ``draws`` and ``params`` (one per seed) replace
    the port's own partition, random draws and initial models; a cell run
    on given inputs is neither read from nor written to the cache."""
    if seeds is None:
        seeds = tuple(s + seed for s in st.get("seeds", (0,)))
    seeds = tuple(int(s) for s in seeds)
    device = resolve_device(device)
    given = data is not None or draws is not None or params is not None
    tag = (  # d<seed> = data-partition seed; s<...> = sweep seeds
        f"{policy}_{scenario}_a{alpha}_p{p_bc}_N{st['num_clients']}_T{st['epochs']}"
        f"_n{st['samples']}_d{seed}_s{'-'.join(map(str, seeds))}"
    )
    f = CACHE / f"{tag}.json"
    if not given and f.exists():
        return json.loads(f.read_text())
    if data is None:
        data = _bench_data(st["num_clients"], st["samples"], alpha, seed, device)
    cfg = cell_config(policy, alpha, p_bc, st, seed, scenario)
    t0 = time.time()
    out = run_batch(cfg, cnn_backend(BENCH_CNN), data, seeds, draws=draws, params=params, device=device)
    m = {k: v.cpu() for k, v in out["metrics"].items()}  # every entry has a leading (len(seeds),) axis
    f1 = m["f1"].double()
    rec = {
        "policy": policy,
        "alpha": alpha,
        "p_bc": p_bc,
        "scenario": scenario,
        "seeds": list(seeds),
        "wall_s": time.time() - t0,
        "f1": f1.mean(0).tolist(),
        "f1_std": f1.std(0, unbiased=False).tolist(),
        "f1_per_seed": f1.tolist(),
        "f1_epochs": m["f1_epochs"].tolist(),
        "avg_age": m["avg_age"].double().mean(0).tolist(),
        "energy_per_epoch": m["energy"].double().mean(0).tolist(),
        "total_energy": float(m["total_energy"].double().mean()),
        "total_energy_per_seed": m["total_energy"].tolist(),
        "n_started": float(m["n_started"].sum(-1).double().mean()),
        "n_uploaded": float(m["n_uploaded"].sum(-1).double().mean()),
    }
    if not given:
        CACHE.mkdir(parents=True, exist_ok=True)
        f.write_text(json.dumps(rec))
    return rec


def run_grid(quick: bool = True, seed: int = 0, device: str | torch.device | None = None):
    st = grid_settings(quick)
    cells = {}
    for alpha in st["alphas"]:
        for p_bc in st["pbcs"]:
            for policy in POLICIES:
                cells[(policy, alpha, p_bc)] = run_cell(policy, alpha, p_bc, st, seed, device=device)
    return cells, st


def run_scenarios(quick: bool = True, seed: int = 0, policy: str = "vaoi",
                  device: str | torch.device | None = None):
    """Harvest-scenario gallery at the paper's hardest cell (small alpha,
    scarce energy): every scenario at the same mean rate, a multi-seed cell
    each."""
    st = grid_settings(quick)
    alpha = st["alphas"][0]
    p_bc = st["pbcs"][0] if quick else 0.1  # the full grid's 0.01 is ultra-scarce
    cells = {}
    for scenario in SCENARIOS:
        cells[scenario] = run_cell(policy, alpha, p_bc, st, seed, scenario=scenario, device=device)
    return cells, st


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--quick", action="store_true", help="the cut protocol (N=16, T=30, 2 seeds)")
    ap.add_argument("--grid", action="store_true", help="also run the policy grid")
    ap.add_argument("--policy", default="vaoi", choices=POLICIES)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cells, st = run_scenarios(args.quick, args.seed, args.policy, device)
    print(f"{'scenario':<11} {'final F1':>9} {'f1 std':>8} {'energy':>9} {'wall_s':>7}")
    for scenario, rec in cells.items():
        print(
            f"{scenario:<11} {rec['f1'][-1]:>9.4f} {rec['f1_std'][-1]:>8.4f} "
            f"{rec['total_energy']:>9.0f} {rec['wall_s']:>7.1f}"
        )
    grid = None
    if args.grid:
        grid, _ = run_grid(args.quick, args.seed, device)
        for (policy, alpha, p_bc), rec in grid.items():
            print(
                f"grid {policy:<13} a={alpha:<5} p={p_bc:<5} "
                f"f1={rec['f1'][-1]:.4f} energy={rec['total_energy']:.0f}"
            )
    return cells, grid


if __name__ == "__main__":
    main()
