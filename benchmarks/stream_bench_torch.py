"""Streaming-scenario bench on the PyTorch/CUDA port: F1 + VAoI dynamics for
every data-stream scenario × selection policy; the counterpart of
``benchmarks/stream_bench.py``.

The same world (the micro CNN, N × samples at Dirichlet α 0.3, a test set of
64, from the port's ``make_federated_dataset``), the same ``EHFLConfig``
constants, grid and row keys.  Each cell is one ``run_simulation``; its row
records the final macro-F1, the VAoI trajectory summary and epoch
throughput.  Rows go to stdout CSV (the ``benchmarks/run_torch.py``
protocol) and to ``BENCH_stream_torch.json`` at the repo root, with the
card's name and power limit.

Every run is under cuDNN's deterministic algorithms (``"deterministic":
true`` in the file): the channel bench's ideal rows must repeat the static
rows bit for bit, and on the card cuDNN's default backward does not repeat
itself.  One untimed epoch runs before the grid.  ``bench_one`` takes
``draws`` and ``params`` to run a cell on given random draws and initial
model.  Runs on the GPU unless ``--device`` says
otherwise:

  PYTHONPATH=src python benchmarks/stream_bench_torch.py                 # quick grid
  PYTHONPATH=src python benchmarks/stream_bench_torch.py --full          # larger protocol
  PYTHONPATH=src python benchmarks/stream_bench_torch.py --device cpu
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import time
from pathlib import Path
from typing import Any, Dict, Iterator

import torch

from repro_torch.configs.cifar_cnn import CNNConfig
from repro_torch.core import STREAM_SCENARIOS, EHFLConfig, run_simulation
from repro_torch.core.policies import POLICIES, make_policy
from repro_torch.core.simulator import resolve_compact_cap
from repro_torch.data import make_federated_dataset
from repro_torch.device import resolve_device
from repro_torch.fl import cnn_backend

ROOT = Path(__file__).resolve().parent.parent
OUT = ROOT / "BENCH_stream_torch.json"

MICRO = CNNConfig(name="stream-micro", image_size=8, conv_channels=(2, 2, 2, 2, 2, 2), fc_dims=(8,))

# mean-matched streaming params sized to the quick protocol's T
STREAM_PARAMS = {
    "static": (),
    "drift": (("period", 8.0), ("alpha", 0.3)),
    "arrival": (("rate", 4.0), ("burst", 2.0), ("window", 16.0)),
    "shift": (("period", 4.0), ("num_phases", 2.0)),
}


def protocol(quick: bool) -> tuple:
    """(N, samples per client, epochs)."""
    return (16, 32, 8) if quick else (64, 64, 32)


def world(num_clients: int, samples: int, device: torch.device):
    data = make_federated_dataset(
        0, num_clients=num_clients, samples_per_client=samples, alpha=0.3, test_size=64,
        image_size=MICRO.image_size, device=device,
    )
    return data, cnn_backend(MICRO)


@contextlib.contextmanager
def deterministic() -> Iterator[None]:
    """cuDNN's deterministic algorithms inside the block, so that a run
    repeats bit for bit on the card as it does on the CPU."""
    prev = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = prev


def sim_config(n: int, epochs: int, policy: str, compact: bool, **axes) -> EHFLConfig:
    """The stream bench's protocol constants; the channel bench's too, so
    that its ideal rows repeat the static rows."""
    return EHFLConfig(
        num_clients=n, epochs=epochs, slots_per_epoch=8, kappa=4, p_bc=0.4, k=max(1, n // 4), mu=0.3, e_max=8,
        policy=policy, eval_every=epochs, probe_size=4, compact="auto" if compact else False, **axes,
    )


def bench_config(scenario: str, policy: str, epochs: int, n: int, compact: bool = False) -> EHFLConfig:
    return sim_config(n, epochs, policy, compact, stream=scenario, stream_params=STREAM_PARAMS[scenario])


def run_cell(cfg: EHFLConfig, backend, data, *, draws=None, params=None, device=None) -> tuple:
    """One timed ``run_simulation`` under deterministic cuDNN: (metrics on
    the host, wall seconds)."""
    with deterministic():
        t0 = time.time()
        out = run_simulation(cfg, backend, data, draws=draws, params=params, device=device)
        wall = time.time() - t0
    return {k: v.cpu() for k, v in out["metrics"].items()}, wall


def warm_up(backend, data, n: int, device: torch.device) -> None:
    """One untimed epoch before a grid, so that the first row's time holds
    no one-off start-up (CUDA context, cuDNN handles, first allocations)."""
    with deterministic():
        run_simulation(bench_config("static", "vaoi", 1, n), backend, data, device=device)


def outcome(m: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """The fields an ideal channel row repeats from its static stream row,
    rounded as the JAX benches round them."""
    return {
        "f1": round(float(m["f1"][-1]), 4),
        "avg_age_mean": round(float(m["avg_age"].double().mean()), 4),
        "avg_m_mean": round(float(m["avg_m"].double().mean()), 5),
        "n_uploaded": int(m["n_uploaded"].sum()),
    }


def timing(n: int, epochs: int, wall: float) -> Dict[str, Any]:
    return {"epoch_s": round(wall / epochs, 4), "clients_per_s": round(n * epochs / max(wall, 1e-9), 1)}


def bench_one(
    scenario: str, policy: str, data, backend, epochs: int, n: int, compact: bool = False,
    *, draws=None, params=None, device: str | torch.device | None = None,
) -> dict:
    cfg = bench_config(scenario, policy, epochs, n, compact)
    m, wall = run_cell(cfg, backend, data, draws=draws, params=params, device=device)
    return {"scenario": scenario, "policy": policy, "compact": compact, "epochs": epochs, "N": n, **outcome(m),
            **timing(n, epochs, wall)}


def compacts(policy: str, n: int) -> tuple:
    """Row variants per cell: always dense; plus a compact row when the
    policy's slab is below N (fedavg's would be the whole fleet)."""
    cfg = EHFLConfig(num_clients=n, k=max(1, n // 4), policy=policy)
    spec = make_policy(policy, num_clients=n, k=cfg.k)
    return (False, True) if resolve_compact_cap(cfg, spec) else (False,)


def device_info(device: torch.device) -> Dict[str, Any]:
    """The card's name and power limit as nvidia-smi prints them (none on
    the CPU)."""
    if device.type != "cuda":
        return {"name": "cpu", "power_limit": None}
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[torch.cuda.current_device()]
    name, limit = (s.strip() for s in line.rsplit(",", 1))
    return {"name": name, "power_limit": limit}


def header(bench: str, quick: bool, device: torch.device) -> Dict[str, Any]:
    """The fields every torch BENCH file opens with (``tools/check_bench.py``'s
    schema: ``bench``, ``devices``, ``backend``)."""
    return {
        "bench": bench,
        "devices": torch.cuda.device_count() if device.type == "cuda" else 1,
        "backend": device.type,
        "cpus": os.cpu_count(),
        "device": device_info(device),
        "quick": quick,
    }


def write(out: Path, doc: Dict[str, Any]) -> None:
    Path(out).write_text(json.dumps(doc, indent=2))


def run(quick: bool = True, device: str | torch.device | None = None) -> list:
    """``benchmarks/run_torch.py`` suite entry: the scenario × policy ×
    {dense, compact} grid, written to BENCH_stream_torch.json, returned as
    harness CSV rows."""
    device = resolve_device(device)
    n, samples, epochs = protocol(quick)
    data, backend = world(n, samples, device)
    warm_up(backend, data, n, device)
    rows = [
        bench_one(sc, pol, data, backend, epochs, n, compact=c, device=device)
        for sc in STREAM_SCENARIOS
        for pol in POLICIES
        for c in compacts(pol, n)
    ]
    write(OUT, {**header("stream", quick, device), "deterministic": True, "rows": rows})
    return [
        {
            "name": f"stream/{r['scenario']}_{r['policy']}" + ("_compact" if r["compact"] else ""),
            "us_per_call": r["epoch_s"] * 1e6,
            "derived": f"f1={r['f1']};age={r['avg_age_mean']};m={r['avg_m_mean']}",
        }
        for r in rows
    ]


def print_rows(rows: list) -> None:
    print("name,us_per_call,derived")
    for r in rows:
        print(f"{r['name']},{r['us_per_call']:.1f},{r['derived']}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--full", action="store_true", help="larger N/T protocol")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    print_rows(run(quick=not args.full, device=args.device))
    print(f"wrote {OUT}")


if __name__ == "__main__":
    main()
