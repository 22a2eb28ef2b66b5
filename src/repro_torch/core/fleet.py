"""Client-sharded fleet: Alg. 1 with the client axis split over the ranks of
a ``torch.distributed`` group (the counterpart of ``repro.core.fleet``).

``run_simulation`` keeps every per-client tensor on one device; at fleet
scale ``msg_params`` alone is N model copies.  :func:`run_fleet` runs the
SAME ``simulator.epoch_body`` on each rank over its n_loc = N / shards
clients (rank r holds clients ``[r·n_loc, (r+1)·n_loc)``): the global model
and the clocks are whole on every rank, while ``msg_params``, ``h``,
``age``, ``battery``, ``pending``, ``counter``, ``retries``, ``backoff``,
the client pools and the per-client scenario state are the rank's rows.
Only the :class:`~repro_torch.core.simulator.EpochOps` points differ from
the solo path:

  * Alg. 2 selection: the distributed top-k (``vaoi.select_topk_sharded``);
  * FedAvg: each rank's one ``fedavg_reduce`` launch over its slab and its
    old-carrier stack (or its dense rows), then one all-reduce of the (P,)
    partial and one of the count;
  * metrics: one all-reduce of a vector of the epoch's sums and the
    zero-padded selection mask;
  * ALOHA's contention counts (``channel.make_sharded_channel``).

Draws follow the reference's global-draw-and-slice: every rank draws the
whole epoch from the same source and keeps its rows
(``draws.shard_draws``), so a fleet run consumes the solo run's draws.
Contract (``tests/test_torch_fleet.py``): for N divisible by the shard
count, the fleet matches the solo run: integer slot dynamics, ages and
selections exactly; floats to fp32 rounding (the FedAvg partials are summed
across ranks in the backend's order).  The collectives run under
``record_function("ehfl.fleet.*")`` ranges: ``select``, ``fedavg``,
``metrics`` and ``channel``.
"""
from __future__ import annotations

from typing import Any, Dict, List, Sequence

import torch
import torch.distributed as dist
from torch.profiler import record_function

from repro_torch.core import channel as channel_lib
from repro_torch.core import harvest as harvest_lib
from repro_torch.core import policies as policy_lib
from repro_torch.core import simulator as sim
from repro_torch.core.draws import DrawSource, TorchDraws, shard_draws
from repro_torch.data import stream as stream_lib
from repro_torch.device import resolve_device

Params = Dict[str, torch.Tensor]


def _all_sum(x: torch.Tensor, group: Any, what: str) -> torch.Tensor:
    with record_function(f"ehfl.fleet.{what}"):
        dist.all_reduce(x, group=group)
    return x


def shard_size(num_clients: int, shards: int) -> int:
    """n_loc; raises unless the fleet divides evenly over the shards."""
    if num_clients % shards:
        raise ValueError(f"num_clients={num_clients} must divide over {shards} shards")
    return num_clients // shards


def _group(group: Any) -> Any:
    if not dist.is_initialized():
        raise RuntimeError(
            "the fleet runs inside an initialized torch.distributed process group (one rank per shard; "
            "launch.mesh.spawn_fleet or torchrun); use simulator.run_simulation for a solo run"
        )
    return dist.group.WORLD if group is None else group


def fleet_ops(cfg: sim.EHFLConfig, group: Any) -> sim.EpochOps:
    """The distributed :class:`~repro_torch.core.simulator.EpochOps` of a
    rank of ``group``: the sharded selection, the all-reduce of the FedAvg
    partials, and the metrics folded in one all-reduce."""
    rank, shards = dist.get_rank(group), dist.get_world_size(group)
    N = cfg.num_clients
    n_loc = shard_size(N, shards)

    def select(spec, age, t, k, noise):
        return policy_lib.epoch_selection_sharded(spec, age, t, k, noise, group=group)

    def reduce_metrics(local: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        # one float64 vector: the sums (integer counts and integer-valued
        # ages stay exact in float64), then the selection mask, zero-padded
        # to (N,) with this rank's rows at its offset
        names = [k for k in local if k != "selected"]
        sel = local["selected"]
        vec = torch.zeros(len(names) + N, dtype=torch.float64, device=sel.device)
        vec[: len(names)] = torch.stack([local[k].double() for k in names])
        vec[len(names) + rank * n_loc : len(names) + (rank + 1) * n_loc] = sel.double()
        vec = _all_sum(vec, group, "metrics")
        out = {k: vec[i].to(local[k].dtype) for i, k in enumerate(names)}
        out["selected"] = vec[len(names):] > 0.5
        return out

    return sim.EpochOps(
        select=select,
        reduce_sum=lambda x: _all_sum(x, group, "fedavg"),
        reduce_metrics=reduce_metrics,
    )


def make_fleet_epoch_fn(
    cfg: sim.EHFLConfig, backend: sim.Backend, data: Dict[str, torch.Tensor], group: Any = None
):
    """One epoch of Alg. 1 on this rank's shard as a ``(carry, t, draws) ->
    (carry, metrics)`` function: ``data`` holds the rank's client pools,
    ``carry`` its shard, ``draws`` the epoch's GLOBAL draws (the function
    keeps the rank's window); ``metrics`` are fleet-wide."""
    group = _group(group)
    rank, shards = dist.get_rank(group), dist.get_world_size(group)
    n_loc = shard_size(cfg.num_clients, shards)
    spec = policy_lib.make_policy(cfg.policy, num_clients=cfg.num_clients, k=cfg.k, num_groups=cfg.num_groups)
    process, stream = cfg.harvest_process(), cfg.data_stream(backend.num_classes)
    channel = channel_lib.make_sharded_channel(cfg.channel, group, **dict(cfg.channel_params))
    ops = fleet_ops(cfg, group)
    off = rank * n_loc
    return lambda carry, t, draws: sim.epoch_body(
        carry, t, data["images"], data["labels"], shard_draws(draws, off, n_loc, stream.draw_axis),
        cfg=cfg, backend=backend, spec=spec, process=process, stream=stream, channel=channel, ops=ops,
    )


_CLIENT_FIELDS = ("msg_params", "h", "age", "battery", "pending", "counter", "retries", "backoff")


def carry_sharding(cfg: sim.EHFLConfig) -> Dict[str, bool | None]:
    """Per :class:`~repro_torch.core.simulator.EpochCarry` field: True where
    it is per client (a shard holds its rows), False where it is whole on
    every rank (the global model; diurnal's clock), None where it is None
    (the stateless scenarios)."""
    return {
        "global_params": False,
        **{f: True for f in _CLIENT_FIELDS},
        "harvest": harvest_lib.state_sharding_tree(cfg.harvest),
        "stream": stream_lib.state_sharding_tree(cfg.stream),
        "channel": channel_lib.state_sharding_tree(cfg.channel),
    }


def shard_carry(cfg: sim.EHFLConfig, carry: sim.EpochCarry, rank: int, shards: int) -> sim.EpochCarry:
    """Rank ``rank``'s shard of a whole (solo) carry: its rows of every
    per-client field, the rest as it is (the same objects)."""
    n_loc = shard_size(cfg.num_clients, shards)
    rows = slice(rank * n_loc, (rank + 1) * n_loc)
    return carry._replace(**{
        f: sim._tree_map(lambda x: x[rows], getattr(carry, f))
        for f, sharded in carry_sharding(cfg).items() if sharded
    })


def gather_carry(cfg: sim.EHFLConfig, shards: Sequence[sim.EpochCarry]) -> sim.EpochCarry:
    """The whole carry from every rank's shard, in rank order (the inverse of
    :func:`shard_carry`; whole fields from rank 0's)."""
    def cat(parts: List[Any]) -> Any:
        first = parts[0]
        if isinstance(first, torch.Tensor):
            return torch.cat(parts)
        if isinstance(first, dict):
            return {k: cat([p[k] for p in parts]) for k in first}
        raise TypeError(f"a per-client carry leaf must be a tensor or a dict of them; got {type(first)}")

    return shards[0]._replace(**{
        f: cat([getattr(s, f) for s in shards]) for f, sharded in carry_sharding(cfg).items() if sharded
    })


def init_carry(
    cfg: sim.EHFLConfig,
    backend: sim.Backend,
    group: Any = None,
    device: str | torch.device | None = None,
    params: Params | None = None,
    seed: int | None = None,
    draws: DrawSource | None = None,
) -> sim.EpochCarry:
    """This rank's shard of the initial carry, born sharded: the rank builds
    only its n_loc message copies and its rows of the scenario state (from
    its window of the global init draws), never the N of a solo carry.
    Equals ``shard_carry`` of the solo ``init_carry``."""
    group = _group(group)
    rank, shards = dist.get_rank(group), dist.get_world_size(group)
    n_loc = shard_size(cfg.num_clients, shards)
    return sim.init_carry(cfg, backend, device, params=params, seed=seed, draws=draws, rows=(rank * n_loc, n_loc))


def run_fleet(
    cfg: sim.EHFLConfig,
    backend: sim.Backend,
    data: Dict[str, Any],
    *,
    group: Any = None,
    draws: DrawSource | None = None,
    params: Params | None = None,
    device: str | torch.device | None = None,
) -> Dict[str, Any]:
    """Run T epochs of Alg. 1 with the client axis sharded over ``group``
    (default the whole world), on this rank's ``device`` (``None``: the
    current GPU).  Every rank of the group calls it with the same arguments.

    ``data`` holds the GLOBAL client pools (N, ...) and test set, as tensors
    or numpy arrays (a memory map will do: only the rank's rows are read).
    Returns ``run_simulation``'s contract on every rank: fleet-wide metric
    trajectories (``selected`` (T, N)), the replicated global model, and
    this rank's carry; plus ``num_shards``.  Raises outside an initialized
    process group and when N does not divide over the shards; it never
    runs solo instead."""
    group = _group(group)
    rank, shards = dist.get_rank(group), dist.get_world_size(group)
    n_loc = shard_size(cfg.num_clients, shards)
    device = resolve_device(device)
    rows = slice(rank * n_loc, (rank + 1) * n_loc)
    local = sim.to_device_data(
        {"images": data["images"][rows], "labels": data["labels"][rows],
         "test_images": data["test_images"], "test_labels": data["test_labels"]},
        device,
    )
    draws = draws or TorchDraws(cfg.seed)
    carry = init_carry(cfg, backend, group, device, params=params, draws=draws)
    epoch_fn = make_fleet_epoch_fn(cfg, backend, local, group)
    out = sim.drive_epochs(epoch_fn, carry, cfg, backend, local, draws)
    out["num_shards"] = shards
    return out
