"""Fleet-scale epoch throughput on the PyTorch/CUDA port: the client-sharded
simulator (``repro_torch/core/fleet.py``) swept over N; the counterpart of
``benchmarks/fleet_bench.py``.

The JAX bench shards its client axis over virtual host devices; the port
over the ranks of a ``torch.distributed`` group that
``launch/mesh.py::spawn_fleet`` starts: by default NCCL, one rank per
visible card; ``--backend gloo --shards R`` puts R ranks on one card or, with
``--device cpu``, on the CPU (NCCL refuses two ranks on one GPU; the CPU's
default is 2 gloo ranks).  Each rank builds the epoch once
(``fleet.make_fleet_epoch_fn``), runs a first epoch, then ``reps`` more; a
row's ``epoch_s`` is the mean of those, each ended by a device sync and
taken on the slowest rank, and ``first_epoch_s`` the first's (the JAX
bench's ``compile_s``).  Every (N, dense/compact) row runs in one spawn.

Rows go to stdout CSV and to ``BENCH_fleet_torch.json`` at the repo root,
which records the device, the process-group backend and the rank count.

  PYTHONPATH=src python benchmarks/fleet_bench_torch.py                   # N=1k, 4k; NCCL, a rank a card
  PYTHONPATH=src python benchmarks/fleet_bench_torch.py --full            # N up to 64k
  PYTHONPATH=src python benchmarks/fleet_bench_torch.py --backend gloo --shards 4   # 4 ranks on one card
  PYTHONPATH=src python benchmarks/fleet_bench_torch.py --device cpu --shards 2
"""
from __future__ import annotations

import argparse
import json
import tempfile
import time
from pathlib import Path
from typing import Sequence

import torch
import torch.distributed as dist

try:  # harness mode (python -m benchmarks.run_torch) vs script mode
    from benchmarks import stream_bench_torch as stream_bench
except ImportError:  # script mode: benchmarks/ itself is sys.path[0]
    import stream_bench_torch as stream_bench

from repro_torch.configs.cifar_cnn import CNNConfig
from repro_torch.core import fleet
from repro_torch.core import simulator as sim
from repro_torch.core.draws import TorchDraws
from repro_torch.data import make_federated_dataset
from repro_torch.device import resolve_device
from repro_torch.fl import cnn_backend
from repro_torch.launch.mesh import spawn_fleet

OUT = stream_bench.ROOT / "BENCH_fleet_torch.json"

# micro CNN: 3 pools need 6 convs; image 8 -> 1x1 spatial, ~360 params, so
# the message stack stays ~100 MB even at N=64k
MICRO = CNNConfig(name="fleet-micro", image_size=8, conv_channels=(2, 2, 2, 2, 2, 2), fc_dims=(8,))
CPU_SHARDS = 2
TIMEOUT_S = 1800.0


def sizes(quick: bool) -> tuple:
    return (1024, 4096) if quick else (1024, 4096, 16384, 65536)


def world(num_clients: int, samples: int = 8):
    """The whole fleet's pools and test set on the host: a rank moves its
    rows to its device."""
    return make_federated_dataset(
        0, num_clients=num_clients, samples_per_client=samples, alpha=0.5, test_size=64,
        image_size=MICRO.image_size, device="cpu",
    )


def fleet_config(num_clients: int, policy: str, compact: bool, epochs: int) -> sim.EHFLConfig:
    return sim.EHFLConfig(
        num_clients=num_clients, epochs=epochs, slots_per_epoch=8, kappa=4, p_bc=0.3, k=10, mu=0.5, e_max=8,
        policy=policy, eval_every=epochs, probe_size=4, compact="auto" if compact else False,
    )


def time_epochs(num_clients: int, policy: str, compact: bool, reps: int, device: torch.device) -> dict:
    """On every rank of the world group: one first epoch and ``reps`` more
    of the fleet at this N; the row, with each time the slowest rank's."""
    rank, shards = dist.get_rank(), dist.get_world_size()
    cfg = fleet_config(num_clients, policy, compact, epochs=1 + reps)
    backend = cnn_backend(MICRO)
    n_loc = fleet.shard_size(num_clients, shards)
    data, rows = world(num_clients), slice(rank * n_loc, (rank + 1) * n_loc)
    local = sim.to_device_data({"images": data["images"][rows], "labels": data["labels"][rows],
                                "test_images": data["test_images"], "test_labels": data["test_labels"]}, device)
    draws = TorchDraws(cfg.seed)
    carry = fleet.init_carry(cfg, backend, device=device, draws=draws)
    epoch = fleet.make_fleet_epoch_fn(cfg, backend, local)
    n_samples = local["images"].shape[1]

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def run(carry, ts):
        sync()
        t0 = time.perf_counter()
        for t in ts:
            carry, _ = epoch(carry, t, draws.epoch(t, cfg, n_samples, device))
            sync()
        slowest = torch.tensor([time.perf_counter() - t0], dtype=torch.float64, device=device)
        dist.all_reduce(slowest, op=dist.ReduceOp.MAX)
        return carry, slowest.item()

    carry, first_s = run(carry, [0])
    carry, wall = run(carry, range(1, 1 + reps))
    epoch_s = wall / reps
    return {
        "N": num_clients,
        "shards": shards,
        "policy": policy,
        "compact": compact,
        "k": cfg.k,
        "epoch_s": round(epoch_s, 4),
        "first_epoch_s": round(first_s, 4),
        "clients_per_s": round(num_clients / epoch_s, 1),
    }


def rank_main(rank: int, workdir: str, cells: Sequence[tuple], reps: int, device: str) -> None:
    """A spawned rank: every (N, policy, compact) cell in turn; rank 0
    writes the rows to ``workdir/rows.json``."""
    rows = [time_epochs(n, policy, compact, reps, torch.device(device)) for n, policy, compact in cells]
    if rank == 0:
        (Path(workdir) / "rows.json").write_text(json.dumps(rows))


def bench(
    ns: Sequence[int], *, shards: int | None = None, backend: str | None = None,
    device: str | torch.device | None = None, reps: int = 3, policy: str = "vaoi",
) -> tuple:
    """The rows of N in ``ns`` × {dense, compact} from one spawn of
    ``shards`` ranks over ``backend``; returns (rows, backend, shards)."""
    device = resolve_device(device)
    cuda = device.type == "cuda"
    backend = backend or ("nccl" if cuda else "gloo")
    if backend == "nccl" and not cuda:
        raise ValueError("NCCL runs on the card; on the CPU take --backend gloo")
    cards = torch.cuda.device_count() if cuda else 0
    shards = shards or (cards if backend == "nccl" else CPU_SHARDS)
    if backend == "nccl" and shards > cards:
        raise ValueError(f"NCCL takes one rank a card: {shards} ranks on {cards} cards (take --backend gloo)")
    cells = [(n, policy, c) for n in ns for c in (False, True)]
    with tempfile.TemporaryDirectory(prefix="fleet-bench-") as tmp:
        spawn_fleet(rank_main, shards, backend, args=(tmp, cells, reps, device.type), timeout_s=TIMEOUT_S)
        rows = json.loads((Path(tmp) / "rows.json").read_text())
    return rows, backend, shards


def run(
    quick: bool = True, device: str | torch.device | None = None, *, shards: int | None = None,
    backend: str | None = None,
) -> list:
    """``benchmarks/run_torch.py`` suite entry: sweep N × {dense, compact},
    write BENCH_fleet_torch.json, return the harness CSV rows."""
    device = resolve_device(device)
    rows, backend, shards = bench(sizes(quick), shards=shards, backend=backend, device=device)
    stream_bench.write(OUT, {**stream_bench.header("fleet", quick, device), "dist_backend": backend,
                             "ranks": shards, "rows": rows})
    return [
        {
            "name": f"fleet/N{r['N']}_shards{r['shards']}" + ("_compact" if r["compact"] else ""),
            "us_per_call": r["epoch_s"] * 1e6,
            "derived": f"{r['clients_per_s']:.0f}clients/s",
        }
        for r in rows
    ]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--full", action="store_true", help="sweep N up to 64k")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--shards", type=int, default=None,
                    help="ranks (default: one a visible card over NCCL; 2 gloo ranks on the CPU)")
    ap.add_argument("--backend", default=None, choices=("nccl", "gloo"),
                    help="process-group backend (default nccl on the card, gloo on the CPU)")
    args = ap.parse_args(argv)
    stream_bench.print_rows(run(quick=not args.full, device=args.device, shards=args.shards, backend=args.backend))
    print(f"wrote {OUT}")


if __name__ == "__main__":
    main()
