"""Paper Fig. 6 on the PyTorch/CUDA port: network-wide energy, normalised
within each p_bc group by the largest of the 4 schemes, from the torch grid
(``benchmarks/ehfl_grid_torch.py``); ``benchmarks/fig6_energy.py``'s rows.

Claims checked: (i) energy follows participation, not alpha; (ii) VAoI
spends less than greedy FedAvg at high p_bc (paper: up to 37% less); (iii)
FedBacys-Odd spends least.  Beyond the paper: VAoI's energy and F1 across
the harvest scenarios at one mean arrival rate."""
from __future__ import annotations

from benchmarks.ehfl_grid_torch import POLICIES, run_grid, run_scenarios


def run(quick: bool = True, device=None):
    cells, st = run_grid(quick, device=device)
    rows = []
    alphas = sorted({a for (_, a, _) in cells})
    pbcs = sorted({p for (_, _, p) in cells})
    a_ref = alphas[0]  # the paper uses alpha=0.1 for Fig. 6
    for p_bc in pbcs:
        totals = {pol: cells[(pol, a_ref, p_bc)]["total_energy"] for pol in POLICIES}
        mx = max(totals.values()) or 1.0
        for pol, e in totals.items():
            rows.append(
                {
                    "name": f"fig6/{pol}/p{p_bc}",
                    "us_per_call": 0.0,
                    "derived": f"energy={e:.0f};normalized={e/mx:.3f}",
                }
            )
        if totals["fedavg"] > 0:
            red = 1.0 - totals["vaoi"] / totals["fedavg"]
            rows.append(
                {
                    "name": f"fig6/vaoi_vs_fedavg_reduction/p{p_bc}",
                    "us_per_call": 0.0,
                    "derived": f"reduction={red:.3f}",
                }
            )
    # alpha-invariance of energy (claim i): VAoI's energy across alphas
    if len(alphas) > 1:
        for p_bc in pbcs:
            es = [cells[("vaoi", a, p_bc)]["total_energy"] for a in alphas]
            spread = (max(es) - min(es)) / (max(es) or 1.0)
            rows.append(
                {
                    "name": f"fig6/alpha_invariance/p{p_bc}",
                    "us_per_call": 0.0,
                    "derived": f"rel_spread={spread:.3f}",
                }
            )
    scen_cells, _ = run_scenarios(quick, device=device)
    rows.extend(scenario_rows(scen_cells, st["epochs"]))
    return rows


def scenario_rows(scen_cells: dict, epochs: int) -> list:
    bern = scen_cells["bernoulli"]["total_energy"]
    rows = []
    for scenario, rec in scen_cells.items():
        # bernoulli's self-ratio is 1 by definition (covers the 0/0 cell)
        vs = 1.0 if scenario == "bernoulli" else rec["total_energy"] / (bern or 1.0)
        rows.append(
            {
                "name": f"fig6/scenario/{scenario}",
                "us_per_call": rec["wall_s"] * 1e6 / max(epochs, 1),
                "derived": (
                    f"energy={rec['total_energy']:.0f};"
                    f"vs_bernoulli={vs:.3f};"
                    f"final_f1={rec['f1'][-1]:.4f}"
                ),
            }
        )
    return rows
