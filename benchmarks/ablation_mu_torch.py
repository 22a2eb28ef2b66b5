"""Beyond-paper ablation on the PyTorch/CUDA port: the significance
threshold mu (the Eq. 7 gate) and the stochastic (Gumbel top-k) selection,
``vaoi_soft``, at the paper's hardest cell (alpha=0.1, p_bc=0.1), through
the port's ``run_simulation``; ``benchmarks/ablation_mu.py``'s rows.
Records are cached beside the torch grid's (experiments/ehfl_grid_torch/)."""
from __future__ import annotations

import json

from benchmarks import ehfl_grid_torch as grid
from repro_torch.core import EHFLConfig, run_simulation
from repro_torch.data import make_federated_dataset
from repro_torch.device import resolve_device
from repro_torch.fl import cnn_backend

SETTINGS = (("vaoi", 0.1), ("vaoi", 0.5), ("vaoi", 2.0), ("vaoi_soft", 0.5))


def run(quick: bool = True, device=None):
    st = grid.grid_settings(quick)
    device = resolve_device(device)
    data = make_federated_dataset(
        0, num_clients=st["num_clients"], samples_per_client=st["samples"], alpha=0.1, test_size=300,
        image_size=grid.BENCH_CNN.image_size, device=device,
    )
    backend = cnn_backend(grid.BENCH_CNN)
    rows = []
    for policy, mu in SETTINGS:
        f = grid.CACHE / f"abl_{policy}_mu{mu}_N{st['num_clients']}_T{st['epochs']}.json"
        if f.exists():
            rec = json.loads(f.read_text())
        else:
            cfg = EHFLConfig(
                num_clients=st["num_clients"], epochs=st["epochs"], p_bc=0.1, k=st["k"], mu=mu, policy=policy,
                alpha=0.1, eval_every=st["eval_every"], probe_size=20,
            )
            m = run_simulation(cfg, backend, data, device=device)["metrics"]
            rec = {
                "f1": float(m["f1"][-1]),
                "energy": float(m["total_energy"]),
                "mean_age": float(m["avg_age"].double().mean()),
            }
            grid.CACHE.mkdir(parents=True, exist_ok=True)
            f.write_text(json.dumps(rec))
        rows.append({
            "name": f"ablation/{policy}/mu{mu}",
            "us_per_call": 0.0,
            "derived": f"final_f1={rec['f1']:.4f};energy={rec['energy']:.0f};mean_age={rec['mean_age']:.3f}",
        })
    return rows
