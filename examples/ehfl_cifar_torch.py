"""End-to-end run of the PyTorch/CUDA port: the paper's §V experiment,
``examples/ehfl_cifar.py``'s counterpart with the same flags and defaults.

Trains the 6-conv CNN federatedly for a few hundred global rounds under
energy harvesting with VAoI scheduling, on the synthetic CIFAR-10-like
dataset (Dirichlet non-IID), on the GPU unless ``--device`` says otherwise.
Pass --paper-scale for the full N=100 / T=500 protocol.

  PYTHONPATH=src python examples/ehfl_cifar_torch.py --policy vaoi --rounds 200
  PYTHONPATH=src python examples/ehfl_cifar_torch.py --device cpu --rounds 4 \\
      --clients 6 --samples 20 --num-seeds 2 --channel erasure --k 2

``--fleet`` runs the client-sharded fleet (``repro_torch.core.fleet``), one
process per shard.  Started plainly it starts them itself: one per visible
card over NCCL (``--shards`` picks fewer), or ``--shards`` processes over
gloo with ``--device cpu``.  Under ``torchrun`` each process it starts is
one shard (NCCL on its card, gloo with ``--device cpu``):

  PYTHONPATH=src python examples/ehfl_cifar_torch.py --fleet --rounds 20
  PYTHONPATH=src torchrun --standalone --nproc-per-node 2 examples/ehfl_cifar_torch.py \\
      --fleet --device cpu --rounds 4 --clients 6 --samples 20 --k 2

It writes ``<tag>_model.npz`` (the global model in the JAX package's
layout, readable by ``repro.checkpoint``) and ``<tag>_metrics.json`` with
the JAX example's keys (a fleet: rank 0 writes them).
"""
import argparse
import datetime
import json
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint.convert import params_to_reference
from repro_torch.checkpoint.npz import save_pytree
from repro_torch.configs.cifar_cnn import CONFIG as PAPER_CNN
from repro_torch.configs.cifar_cnn import CNNConfig
from repro_torch.core import (
    CHANNEL_SCENARIOS,
    SCENARIOS,
    STREAM_SCENARIOS,
    EHFLConfig,
    run_batch,
    run_simulation,
)
from repro_torch.core.fleet import run_fleet
from repro_torch.data import make_federated_dataset
from repro_torch.device import resolve_device
from repro_torch.fl import cnn_backend
from repro_torch.launch.mesh import fleet_shards, spawn_fleet

# how long a rank of the fleet waits on a collective before it fails
FLEET_TIMEOUT_S = 1800.0


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--policy", default="vaoi", choices=["vaoi", "fedavg", "fedbacys", "fedbacys_odd"])
    ap.add_argument("--rounds", type=int, default=200)
    ap.add_argument("--clients", type=int, default=30)
    ap.add_argument("--samples", type=int, default=100)
    ap.add_argument("--alpha", type=float, default=0.1)
    ap.add_argument("--p-bc", type=float, default=0.1)
    ap.add_argument("--k", type=int, default=6)
    ap.add_argument("--mu", type=float, default=0.5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--harvest", default="bernoulli", choices=list(SCENARIOS),
                    help="energy-arrival scenario (repro_torch.core.harvest)")
    ap.add_argument("--stream", default="static", choices=list(STREAM_SCENARIOS),
                    help="streaming-data scenario (repro_torch.data.stream): static is the "
                         "paper's frozen partition; drift/arrival/shift make client data "
                         "non-stationary over epochs")
    ap.add_argument("--stream-period", type=float, default=0.0,
                    help="override the drift/shift period (epochs; 0 = scenario default)")
    ap.add_argument("--channel", default="ideal", choices=list(CHANNEL_SCENARIOS),
                    help="uplink channel scenario (repro_torch.core.channel): ideal is the "
                         "paper's lossless uplink; erasure/aloha/fading drop uploads, which "
                         "retry with capped exponential backoff and re-age their VAoI")
    ap.add_argument("--channel-params", default="",
                    help="comma list of k=v channel knobs, e.g. 'p_loss=0.3,concentration=1.0' "
                         "(erasure), 'num_channels=4' (aloha), 'p_bad=0.4,sojourn=2' (fading)")
    ap.add_argument("--num-seeds", type=int, default=1,
                    help=">1: a multi-seed sweep through run_batch, seed means reported")
    ap.add_argument("--fleet", action="store_true",
                    help="the client-sharded fleet simulator (repro_torch.core.fleet), one process per "
                         "shard: under torchrun each process is a shard, else it starts --shards of them")
    ap.add_argument("--shards", type=int, default=0,
                    help="--fleet started plainly: the shard count (default: every visible card; 1 with "
                         "--device cpu), clamped to a divisor of --clients")
    ap.add_argument("--paper-scale", action="store_true",
                    help="full paper protocol: N=100, T=500, 300 samples, 32px CNN")
    ap.add_argument("--out", default="experiments/ehfl_cifar")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; without CUDA this fails, it does not "
                         "fall back to the CPU)")
    args = ap.parse_args(argv)
    if args.fleet and args.num_seeds > 1:
        ap.error("--fleet runs a single seed; drop --num-seeds "
                 "(seed sweeps go through run_batch, fleets through run_fleet)")
    if args.paper_scale:
        args.clients, args.rounds, args.samples, args.k = 100, 500, 300, 10
    return args


def setup(args, device):
    """The CNN, the data (on ``device``) and the configuration the flags name."""
    if args.paper_scale:
        cnn, image = PAPER_CNN, 32
    else:
        cnn = CNNConfig(name="example", image_size=16, conv_channels=(16, 16, 32, 32, 64, 64), fc_dims=(128, 64))
        image = 16
    data = make_federated_dataset(
        args.seed, num_clients=args.clients, samples_per_client=args.samples, alpha=args.alpha,
        test_size=500, image_size=image, device=device,
    )
    cfg = EHFLConfig(
        num_clients=args.clients, epochs=args.rounds, slots_per_epoch=30,
        kappa=20, p_bc=args.p_bc, k=args.k, mu=args.mu, e_max=25,
        policy=args.policy, alpha=args.alpha, seed=args.seed,
        eval_every=max(args.rounds // 10, 1), probe_size=20, lr=0.01,
        harvest=args.harvest, stream=args.stream,
        stream_params=(("period", args.stream_period),)
        if args.stream_period > 0 and args.stream in ("drift", "shift") else (),
        channel=args.channel,
        channel_params=tuple(
            (k, float(v)) for k, v in (kv.split("=", 1) for kv in args.channel_params.split(",") if kv)
        ),
    )
    return cnn, data, cfg


def fleet_rank(rank: int, args) -> None:
    """One shard of the fleet, inside its process group: the run; rank 0
    reports and writes the files."""
    device = torch.device(args.device) if args.device else torch.device("cuda", torch.cuda.current_device())
    # the client pools stay on the host: run_fleet moves only this rank's rows to the device
    cnn, data, cfg = setup(args, torch.device("cpu"))
    if rank == 0:
        header(args, cnn, f"{device}, a fleet of {dist.get_world_size()} ranks over {dist.get_backend()}")
    t0 = time.time()
    out = run_fleet(cfg, cnn_backend(cnn), data, device=device)
    if rank == 0:
        report(args, out["metrics"], out["global_params"], time.time() - t0)


def main(argv=None) -> None:
    args = parse_args(argv)
    if args.fleet and "RANK" in os.environ and "WORLD_SIZE" in os.environ:  # started by torchrun
        if args.device is None:
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        device = resolve_device(args.device)
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                                timeout=datetime.timedelta(seconds=FLEET_TIMEOUT_S))
        try:
            fleet_rank(dist.get_rank(), args)
        finally:
            dist.destroy_process_group()
        return
    device = resolve_device(args.device)
    if args.fleet:
        shards = fleet_shards(args.clients, args.shards or (None if device.type == "cuda" else 1))
        spawn_fleet(fleet_rank, shards, "nccl" if device.type == "cuda" else "gloo", args=(args,),
                    timeout_s=FLEET_TIMEOUT_S)
        return
    cnn, data, cfg = setup(args, device)
    header(args, cnn, str(device))
    backend = cnn_backend(cnn)
    t0 = time.time()
    if args.num_seeds > 1:
        seeds = [args.seed + i for i in range(args.num_seeds)]
        out = run_batch(cfg, backend, data, seeds, device=device)
        wall = time.time() - t0
        # seed means (every metric has a leading seed axis except the shared
        # eval schedule); seed 0's model goes to the checkpoint
        m = {k: v if k == "f1_epochs" else v.double().mean(0) for k, v in out["metrics"].items()}
        params = {k: v[0] for k, v in out["global_params"].items()}
    else:
        out = run_simulation(cfg, backend, data, device=device)
        wall = time.time() - t0
        m, params = out["metrics"], out["global_params"]
    report(args, m, params, wall)


def header(args, cnn, where: str) -> None:
    print(f"EHFL example (torch, {where}): policy={args.policy} N={args.clients} T={args.rounds} "
          f"alpha={args.alpha} p_bc={args.p_bc} harvest={args.harvest} "
          f"stream={args.stream} cnn={cnn.conv_channels}")


def report(args, m, params, wall) -> None:
    m = {k: v.cpu().numpy() for k, v in m.items()}
    outdir = Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)
    tag = f"{args.policy}_{args.harvest}_{args.stream}_a{args.alpha}_p{args.p_bc}"
    save_pytree(params_to_reference(params), outdir / f"{tag}_model.npz")
    (outdir / f"{tag}_metrics.json").write_text(json.dumps({
        "f1": m["f1"].tolist(),
        "f1_epochs": m["f1_epochs"].tolist(),
        "avg_age": m["avg_age"].tolist(),
        "energy": m["energy"].tolist(),
        "total_energy": float(m["total_energy"]),
        "num_seeds": args.num_seeds,
        "wall_s": wall,
    }))
    print(f"f1 trajectory: {[round(float(x), 4) for x in m['f1']]}")
    print(f"total energy: {float(m['total_energy']):.0f} units | "
          f"trainings: {int(np.asarray(m['n_started']).sum())} | wall: {wall:.1f}s")
    print(f"saved model+metrics -> {outdir}/{tag}_*")


if __name__ == "__main__":
    sys.exit(main())
