"""The fleet's process group: how many shards, and the processes that run them.

The counterpart of ``repro.launch.mesh.make_fleet_mesh``: the JAX package
shards the client axis over a 1-D ``data`` mesh, the port over the ranks of
a ``torch.distributed`` group, one process per shard (``core.fleet``).  No
``DeviceMesh`` is needed: the fleet axis is the group itself.

:func:`spawn_fleet` starts the processes of a fleet on one host: NCCL with
one rank per card, or gloo, on the CPU or with several ranks on one card
(NCCL refuses two ranks on one GPU).  Under ``torchrun`` the launcher has
started the processes already, and each calls
``torch.distributed.init_process_group`` itself.
"""
from __future__ import annotations

import datetime
import os
import tempfile
import time
from typing import Any, Callable, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def fleet_shards(num_clients: int, num_shards: int | None = None) -> int:
    """The fleet's shard count: ``num_shards`` (default: every visible
    card), clamped to the largest divisor of ``num_clients`` not above it,
    so that the fleet divides evenly."""
    n = num_shards or torch.cuda.device_count()
    if n < 1:
        raise ValueError("no CUDA device is visible: pass num_shards to run the fleet on the CPU")
    n = min(n, num_clients)
    while num_clients % n:
        n -= 1
    return n


def _rank_main(rank: int, fn: Callable, shards: int, backend: str, store: str, timeout_s: float, args: tuple) -> None:
    # each rank takes its share of the host's cores: ranks that each run the
    # whole count of intra-op threads spin against each other (torchrun
    # sets one thread a process)
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // shards))
    if backend == "nccl":  # one rank per card
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(
        backend, init_method=f"file://{store}", world_size=shards, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s),
    )
    try:
        fn(rank, *args)
    finally:
        dist.destroy_process_group()


def spawn_fleet(
    fn: Callable[..., Any], shards: int, backend: str, args: Sequence[Any] = (), timeout_s: float = 600.0
) -> None:
    """Run ``fn(rank, *args)`` in ``shards`` new processes, each inside an
    initialized process group of ``backend`` ("nccl" or "gloo") over all of
    them, through a file store in a fresh temporary directory (no port to
    pick).  ``fn`` must be importable by the children (a module-level
    function); results go through files it writes.  A collective that
    waits longer than ``timeout_s`` fails its rank.  Returns when every
    rank has returned; raises if a rank fails or the fleet runs past
    ``timeout_s``, after ending the processes."""
    with tempfile.TemporaryDirectory(prefix="fleet-") as tmp:
        store = os.path.join(tmp, "store")
        ctx = mp.start_processes(
            _rank_main, args=(fn, shards, backend, store, timeout_s, tuple(args)), nprocs=shards,
            join=False, start_method="spawn",
        )
        deadline = time.monotonic() + timeout_s
        try:
            while not ctx.join(timeout=max(0.0, min(5.0, deadline - time.monotonic()))):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"the fleet of {shards} ranks ran past {timeout_s} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
                p.join(timeout=30)
