"""Paper Fig. 5 on the PyTorch/CUDA port: the VAoI policy's average version
age across clients against epochs, per (alpha, p_bc) cell of the torch grid
(``benchmarks/ehfl_grid_torch.py``); ``benchmarks/fig5_vaoi.py``'s rows.

Claim checked: the proposed scheme keeps the average VAoI low (the baseline
policies do not track it: their simulator ages stay 0)."""
from __future__ import annotations

import numpy as np

from benchmarks.ehfl_grid_torch import run_grid


def run(quick: bool = True, device=None):
    cells, st = run_grid(quick, device=device)
    rows = []
    alphas = sorted({a for (_, a, _) in cells})
    pbcs = sorted({p for (_, _, p) in cells})
    for alpha in alphas:
        for p_bc in pbcs:
            rec = cells[("vaoi", alpha, p_bc)]
            ages = np.asarray(rec["avg_age"])
            rows.append(
                {
                    "name": f"fig5/vaoi/a{alpha}/p{p_bc}",
                    "us_per_call": rec["wall_s"] * 1e6 / max(st["epochs"], 1),
                    "derived": (
                        f"mean_age={ages.mean():.3f};final_age={ages[-1]:.3f};"
                        f"max_age={ages.max():.3f}"
                    ),
                }
            )
    return rows
