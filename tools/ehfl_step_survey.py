#!/usr/bin/env python3
"""Survey of the teacher-forced GPU-against-CPU comparison of the EHFL
epoch at paper width, the basis of ``chip_smoke.py``'s ``STEP_ATOL``.

    python3 tools/ehfl_step_survey.py [--epochs 8]

Runs ``chip_smoke.phase_cpu_vs_gpu(forced=True)`` with its tolerances
switched off (it records and does not stop) under each of phase 9a's three
scenario combinations and the default scenario, at phase 4's width, and
prints one JSON line per run: per epoch, the largest difference of a CPU
SGD step from the GPU's step when both start from the GPU's weights, the
largest step itself, and the free-running spreads of h (the GPU against
itself, the GPU against the unforced CPU).  Needs one NVIDIA GPU.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--epochs", type=int, default=8, help="epochs compared per scenario")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("ehfl_step_survey: CUDA is not available; this script needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as cs
    from repro_torch.configs import CONFIG
    from repro_torch.core import simulator as sim
    from repro_torch.core.draws import TorchDraws
    from repro_torch.data import make_federated_dataset
    from repro_torch.fl import cnn_backend
    from repro_torch.kernels import build

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip())
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    build.build(verbose=False)
    cs.STEP_ATOL = cs.PARAM_ATOL = float("inf")  # record every epoch, stop at none
    cfg = sim.EHFLConfig(
        num_clients=100, epochs=args.epochs, slots_per_epoch=30, kappa=20, p_bc=0.1, k=10, mu=0.5,
        lr=0.01, probe_size=20, e_max=25, policy="vaoi", eval_every=args.epochs, seed=0,
    )
    backend = cnn_backend(CONFIG)
    data = make_federated_dataset(0, num_clients=100, samples_per_client=300, test_size=500, device="cpu")
    for name, kw in cs.SCENARIO_RUNS + (("default", {}),):
        row = cs.phase_cpu_vs_gpu(torch, sim, dataclasses.replace(cfg, **kw), backend, data, TorchDraws,
                                  torch.device("cuda"), name=name, forced=True,
                                  exact=cs.EXACT + ("retries", "backoff", "harvest", "stream", "channel"))
        row.pop("profile")
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
