"""At-scale EHFL training over LM clients: the port of ``repro.launch.train``.

VAoI-scheduled federated rounds whose clients train one of the registered
LMs (``--arch``).  Each round: a probe forward of the global model on every
client's probe batch (one batched forward, ``decoder.feature_vectors``,
attention through the ``swa_attention`` kernel on the card), Alg. 2's
top-k selection and the fused Eq. 5 + Eq. 7 through the ``vaoi_distance``
kernel, ``--steps-per-round`` local SGD steps per selected client
(``launch.steps.make_train_step``, plain forms under autograd), the
clients' models written into one preallocated (k, ...) slab per leaf, and
their mean through the ``fedavg_reduce`` leaf-table kernel (fp32 sums,
rounded to each leaf's dtype once); then each trained client's feature
moment is refreshed from its probe batch.  Runs on the card unless
``--device cpu``.

Example (CPU, reduced):
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b --reduced --device cpu \\
      --clients 8 --rounds 3 --k 2 --steps-per-round 4
"""
from __future__ import annotations

import argparse
import time
from typing import Callable, Dict, List, Tuple

import torch
from torch.profiler import record_function

from repro_torch.checkpoint.convert import decoder_params_to_reference
from repro_torch.checkpoint.npz import save_pytree
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import ModelConfig
from repro_torch.core.simulator import leaf_mean
from repro_torch.core.vaoi import select_topk
from repro_torch.data import make_token_dataset
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.launch.steps import make_train_step
from repro_torch.models import decoder
from repro_torch.models.common import Params


def run_rounds(
    cfg: ModelConfig,
    params: Params,
    data: torch.Tensor,
    noise: torch.Tensor,
    *,
    k: int,
    mu: float,
    lr: float,
    steps_per_round: int,
    batch: int,
    log: Callable[[str], None] = print,
) -> Tuple[Params, List[Dict]]:
    """``noise.shape[0]`` rounds from the global ``params`` over the clients'
    tokens ``data`` (N, steps_per_round · batch, S), on their device;
    ``noise`` (R, N) is each round's U[0, 1e-3) selection tie-break.
    Returns the final global params and one record per round: the selected
    clients (ascending), their mean local loss, the mean age and mean
    distance M after selection, and the round's wall seconds (ended by a
    synchronize on the card)."""
    N, _, S = data.shape
    device = data.device
    step = make_train_step(cfg, lr=lr, remat=False)  # the reference's local_round: loss_fn without remat
    probe_toks = data[:, :batch].long()
    age = torch.zeros(N, device=device)
    h = torch.zeros(N, cfg.vocab_size, device=device)
    # one (k, ...) row per selected client and leaf, reused every round
    slab = {name: torch.empty((k,) + t.shape, dtype=t.dtype, device=device)
            for name, t in decoder.flat_params(params).items()}
    weights = torch.full((k,), 1.0 / k, device=device)
    history = []
    for r in range(noise.shape[0]):
        t0 = time.perf_counter()
        with record_function("lm.train.probe"):  # Alg. 2 line 7: the global model on every probe batch
            v = decoder.feature_vectors(cfg, params, probe_toks, use_kernel=True)
        with record_function("lm.train.select"):
            selected = select_topk(age, k, noise[r])
            m, age = kops.vaoi_distance(v, h, age, selected.float(), mu)
        idx = torch.nonzero(selected).flatten().tolist()
        losses = []
        for lane, i in enumerate(idx):
            toks = data[i].long().reshape(steps_per_round, batch, S)
            p, step_losses = params, []
            with record_function("lm.train.local"):
                for s in range(steps_per_round):
                    loss, p = step(p, {"tokens": toks[s], "labels": toks[s]})
                    step_losses.append(loss)
            for name, t in decoder.flat_params(p).items():
                slab[name][lane].copy_(t)
            with record_function("lm.train.refresh"):
                h[i] = decoder.feature_vector(cfg, p, probe_toks[i], use_kernel=True)
            losses.append(torch.stack(step_losses).mean().item())
        with record_function("lm.train.fedavg"):
            params = decoder.nest_params(leaf_mean([slab], [weights]))
        rec = {"selected": idx, "loss": sum(losses) / len(losses), "avg_age": age.mean().item(),
               "avg_m": m.mean().item()}
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        rec["round_s"] = time.perf_counter() - t0
        history.append(rec)
        log(f"round {r}: selected={idx} loss={rec['loss']:.4f} avg_age={rec['avg_age']:.2f} avg_M={rec['avg_m']:.4f}")
    return params, history


def main(argv: List[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--k", type=int, default=2)
    ap.add_argument("--steps-per-round", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--mu", type=float, default=0.001)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--save", default=None, help="write the final params as the reference's .npz layout")
    ap.add_argument("--device", default=None, help="cpu, or a CUDA device (default: the GPU; raises without one)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    print(f"arch={cfg.name} layers={cfg.num_layers} d={cfg.d_model} vocab={cfg.vocab_size}")
    g = torch.Generator().manual_seed(args.seed)
    data = make_token_dataset(
        g, args.clients, args.batch * args.steps_per_round, args.seq, cfg.vocab_size
    )["tokens"].to(device)  # (N, n, S)
    noise = torch.rand(args.rounds, args.clients, generator=g).mul_(1e-3).to(device)
    params = decoder.init_params(cfg, args.seed, device, max_seq=args.seq)
    params, _ = run_rounds(
        cfg, params, data, noise, k=args.k, mu=args.mu, lr=args.lr,
        steps_per_round=args.steps_per_round, batch=args.batch,
    )
    if args.save:
        save_pytree(decoder_params_to_reference(params, cfg), args.save)
        print(f"saved -> {args.save}")


if __name__ == "__main__":
    main()
