"""Paper Fig. 4 on the PyTorch/CUDA port: F1 against epochs for every
(alpha, p_bc) cell and policy, from the torch grid
(``benchmarks/ehfl_grid_torch.py``); ``benchmarks/fig4_f1.py``'s rows.

Claim checked: the VAoI scheme wins (or ties) under severe heterogeneity
(small alpha) with scarce energy (small p_bc)."""
from __future__ import annotations

from benchmarks.ehfl_grid_torch import POLICIES, run_grid


def run(quick: bool = True, device=None):
    cells, st = run_grid(quick, device=device)
    rows = []
    for (policy, alpha, p_bc), rec in cells.items():
        rows.append(
            {
                "name": f"fig4/{policy}/a{alpha}/p{p_bc}",
                "us_per_call": rec["wall_s"] * 1e6 / max(st["epochs"], 1),  # per epoch
                "derived": f"final_f1={rec['f1'][-1]:.4f}",
            }
        )
    # the paper's headline cell: alpha small, p_bc small -> VAoI best
    alphas = sorted({a for (_, a, _) in cells})
    pbcs = sorted({p for (_, _, p) in cells})
    a0, p0 = alphas[0], pbcs[0]
    final = {pol: cells[(pol, a0, p0)]["f1"][-1] for pol in POLICIES}
    best = max(final, key=final.get)
    rows.append(
        {
            "name": f"fig4/headline_cell_a{a0}_p{p0}",
            "us_per_call": 0.0,
            "derived": f"winner={best};" + ";".join(f"{k}={v:.4f}" for k, v in final.items()),
        }
    )
    return rows
