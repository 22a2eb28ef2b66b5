"""The rank side of the port's fleet tests (``tests/test_torch_fleet*.py``).

A test pickles a job (cases and their numpy inputs), starts one process per
rank with ``repro_torch.launch.mesh.spawn_fleet`` on gloo, and each rank
runs every case whose shard count covers it, over a group of the first
``shards`` ranks, then saves what it got to ``rank<r>.pt``.  The test
gathers the ranks' rows and compares.  This module imports torch and the
port only, so that a rank starts without the JAX package.

The scenario runners take the client window ``(off, n)`` and a group: the
test calls them with ``(0, N)`` and no group for the global forms.
"""
from __future__ import annotations

import pickle
import time
from pathlib import Path
from typing import Any, Dict

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import CNNConfig
from repro_torch.core import channel as channel_lib
from repro_torch.core import harvest as harvest_lib
from repro_torch.core import policies as policy_lib
from repro_torch.core import simulator as sim
from repro_torch.core.draws import EpochDraws, InitDraws, shard_draws
from repro_torch.core.fleet import run_fleet
from repro_torch.data import stream as stream_lib
from repro_torch.fl import cnn_backend

TINY = dict(name="tiny", image_size=16, conv_channels=(4, 4, 8, 8, 8, 8), fc_dims=(32, 16))


def _t(x):
    return None if x is None else torch.as_tensor(x)


def select(case: Dict[str, Any], off: int, n: int, group: Any) -> torch.Tensor:
    spec = policy_lib.make_policy(case["policy"], num_clients=len(case["age"]), k=case["k"])
    age, noise = _t(case["age"])[off : off + n], _t(case["noise"])[off : off + n]
    if group is None:
        return policy_lib.epoch_selection(spec, age, case["t"], case["k"], noise)
    return policy_lib.epoch_selection_sharded(spec, age, case["t"], case["k"], noise, group=group)


def harvest(case: Dict[str, Any], off: int, n: int, group: Any) -> Dict[str, torch.Tensor]:
    """Two epochs of the process on clients [off, off + n): each slot's
    charge, and the carried state after each epoch."""
    proc = harvest_lib.make_process(case["name"], p_bc=case["p_bc"], **case["params"])
    init = shard_draws(InitDraws(harvest=case["init"]), off, n).harvest
    state = proc.init(_t(init), n) if proc.persistent else None
    out = {}
    for e, u in enumerate(case["epochs"]):
        u = shard_draws(EpochDraws(noise=None, harvest=_t(u), perms=None), off, n).harvest
        st = harvest_lib.begin(state, u, n, u.shape[-2]) if proc.persistent else proc.init(u, n)
        charges = []
        for _ in range(u.shape[-2]):
            c, st = proc.step(st, torch.zeros(n, dtype=torch.int32))
            charges.append(c)
        out[f"charge{e}"] = torch.stack(charges, dim=1)  # (n, S): clients first
        if proc.persistent:
            state = st[0]
            out[f"state{e}"] = torch.as_tensor(state)
    return out


def stream(case: Dict[str, Any], off: int, n: int, group: Any) -> Dict[str, torch.Tensor]:
    """Three epochs of the stream's view on clients [off, off + n)."""
    s = stream_lib.make_stream(case["name"], **case["params"])
    state = s.init(_t(shard_draws(InitDraws(stream=case["init"]), off, n).stream), n)
    labels = _t(case["labels"])[off : off + n]
    out = {}
    for e, u in enumerate(case["epochs"]):
        u = shard_draws(EpochDraws(None, None, None, stream=_t(u)), off, n, s.draw_axis).stream
        idx, state = s.step(state, e, labels, u)
        out[f"idx{e}"] = idx
        if state is not None:
            out[f"state{e}"] = state
    return out


def channel(case: Dict[str, Any], off: int, n: int, group: Any) -> Dict[str, torch.Tensor]:
    """Three epochs of the channel on clients [off, off + n): what was
    delivered, and the carried state."""
    if group is None:
        ch = channel_lib.make_channel(case["name"], **case["params"])
    else:
        ch = channel_lib.make_sharded_channel(case["name"], group, **case["params"])
    state = ch.init(_t(shard_draws(InitDraws(channel=case["init"]), off, n).channel), n)
    out = {}
    for e, (att, u) in enumerate(zip(case["attempting"], case["epochs"])):
        u = shard_draws(EpochDraws(None, None, None, channel=_t(u)), off, n).channel
        out[f"delivered{e}"], state = ch.step(state, _t(att)[off : off + n], u)
        if state is not None:
            out[f"state{e}"] = state
    return out


def fedavg(case: Dict[str, Any], rank: int, shards: int, group: Any) -> Dict[str, torch.Tensor]:
    """The FedAvg of the fleet on this rank: its slab and its rows of the
    old-carrier stack (compacted), and its rows of the dense stack, each
    one leaf-table reduce and all-reduces."""
    n = len(case["old_mask"]) // shards
    rows = slice(rank * n, (rank + 1) * n)
    tree = lambda d, sl: {k: _t(v[sl]) for k, v in d.items()}
    fb = tree(case["fallback"], slice(None))
    all_sum = lambda x: (dist.all_reduce(x, group=group), x)[1]
    compact = sim._compact_mean(
        tree(case["slabs"][rank], slice(None)), _t(case["slab_masks"][rank]), tree(case["old"], rows),
        _t(case["old_mask"][rows]), fb, reduce_sum=all_sum,
    )
    dense = sim._masked_mean(tree(case["old"], rows), _t(case["old_mask"][rows]), fb, reduce_sum=all_sum)
    return {**{f"compact_{k}": v for k, v in compact.items()}, **{f"dense_{k}": v for k, v in dense.items()}}


def fleet(case: Dict[str, Any], rank: int, shards: int, group: Any) -> Dict[str, Any]:
    """``run_fleet`` on this rank: its metrics, the global model and the
    rank's carry fields."""
    with np.load(case["data"]) as z:
        data = {k: z[k] for k in z.files}
    params = None if case.get("params") is None else {k: _t(v) for k, v in case["params"].items()}
    out = run_fleet(
        sim.EHFLConfig(**case["cfg"]), cnn_backend(CNNConfig(**TINY)), data, group=group,
        draws=case.get("draws"), params=params, device="cpu",
    )
    return {"metrics": out["metrics"], "global_params": out["global_params"],
            "carry": out["carry"]._asdict(), "num_shards": out["num_shards"]}


def refuse(case: Dict[str, Any], rank: int, shards: int, group: Any) -> str:
    """``run_fleet`` at an N that does not divide over the group: the message."""
    cfg = sim.EHFLConfig(num_clients=case["n"] + 2)
    try:
        run_fleet(cfg, cnn_backend(CNNConfig(**TINY)), {}, group=group, device="cpu")
    except ValueError as e:
        return str(e)
    raise AssertionError("run_fleet ran a fleet that does not divide over its shards")


WINDOWED = {"select": select, "harvest": harvest, "stream": stream, "channel": channel}
BY_RANK = {"fedavg": fedavg, "fleet": fleet, "refuse": refuse}


def rank_main(rank: int, job_path: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    job = pickle.loads(Path(job_path).read_bytes())
    shard_counts = sorted({c["shards"] for c in job["cases"]})
    groups = {s: dist.new_group(list(range(s))) for s in shard_counts}  # every rank, same order
    out = {}
    for i, case in enumerate(job["cases"]):
        s = case["shards"]
        if rank >= s:
            continue
        if case["kind"] in WINDOWED:
            n = case["n"] // s
            out[i] = WINDOWED[case["kind"]](case, rank * n, n, groups[s])
        else:
            out[i] = BY_RANK[case["kind"]](case, rank, s, groups[s])
    torch.save(out, Path(out_dir) / f"rank{rank}.pt")


def fail_or_hang(rank: int, how: str) -> None:
    """Rank 1 raises (``how="raise"``) or never reaches the collective
    (``"hang"``); rank 0 waits in an all-reduce for it."""
    if rank == 1:
        if how == "raise":
            raise RuntimeError("rank 1 fails")
        time.sleep(600)
    dist.all_reduce(torch.zeros(1))


def run_job(cases, tmp: Path, world: int = 4, timeout_s: float = 300.0):
    """Run ``cases`` over ``world`` gloo ranks; returns each rank's results
    (``results[rank][case index]``)."""
    from repro_torch.launch.mesh import spawn_fleet

    job = tmp / "job.pkl"
    job.write_bytes(pickle.dumps({"cases": cases}))
    spawn_fleet(rank_main, world, "gloo", args=(str(job), str(tmp)), timeout_s=timeout_s)
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(world)]
