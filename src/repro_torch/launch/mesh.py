"""Meshes of the port: the fleet's process group, the production and host
``DeviceMesh``es of the launch layer, and the H100's roofline constants.

The counterpart of ``repro.launch.mesh.make_fleet_mesh``: the JAX package
shards the client axis over a 1-D ``data`` mesh, the port over the ranks of
a ``torch.distributed`` group, one process per shard (``core.fleet``).  No
``DeviceMesh`` is needed: the fleet axis is the group itself.

:func:`spawn_fleet` starts the processes of a fleet on one host: NCCL with
one rank per card, or gloo, on the CPU or with several ranks on one card
(NCCL refuses two ranks on one GPU).  Under ``torchrun`` the launcher has
started the processes already, and each calls
``torch.distributed.init_process_group`` itself.

The counterparts of ``repro.launch.mesh.make_production_mesh`` and
``make_host_mesh`` are ``DeviceMesh``es over the ranks of the process
group the caller initialized: 256 or 512 ranks of the ``fake`` backend for
the dry-run (``launch/dryrun.py``), or real ranks (gloo on the CPU, NCCL a
rank a card) for a sharded step.  They are functions, so importing this
module touches no process group.
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

# Roofline constants of one NVIDIA H100 SXM5 80GB, the cluster the dry-run
# models (they replace the reference's TPU v5e figures).  From NVIDIA's H100
# data sheet, dense rates without sparsity, at the 700 W limit:
PEAK_FLOPS_BF16 = 989e12  # bf16 tensor-core FLOP/s
PEAK_FLOPS_FP32 = 67e12  # fp32 FLOP/s outside the tensor cores
HBM_BW = 3.35e12  # HBM3 bytes/s
# The collective term's rate per GPU: one 400 Gb/s NDR InfiniBand port
# (ConnectX-7) per GPU in a DGX H100, 50e9 bytes/s.  A 16-wide ``model``
# axis spans two 8-GPU nodes, so the inter-node link bounds its
# collectives.  Inside a node NVLink 4 gives 450e9 bytes/s a direction.
NET_BW = 50e9


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


def data_axes(mesh) -> tuple:
    """The batch-sharding axes of a mesh: ("pod", "data") when multi-pod."""
    return ("pod", "data") if "pod" in mesh.mesh_dim_names else ("data",)


def _mesh(device_type: str, shape: tuple, names: tuple):
    from torch.distributed.device_mesh import init_device_mesh

    n = 1
    for s in shape:
        n *= s
    if not dist.is_initialized():
        raise RuntimeError(f"a {shape} mesh needs an initialized process group of {n} ranks (real or fake)")
    if dist.get_world_size() != n:
        raise ValueError(f"a {shape} mesh needs {n} ranks; the process group has {dist.get_world_size()}")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a cuda mesh needs CUDA; pass device_type='cpu' for a CPU mesh")
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """(16, 16) over ("data", "model") = 256 GPUs, or (2, 16, 16) over
    ("pod", "data", "model") = 512, over the initialized process group."""
    if multi_pod:
        return _mesh(device_type, (2, 16, 16), ("pod", "data", "model"))
    return _mesh(device_type, (16, 16), ("data", "model"))


def make_host_mesh(model_parallel: int = 1, device_type: str = "cuda"):
    """(world / model_parallel, model_parallel) over ("data", "model"): every
    rank of the initialized process group."""
    if not dist.is_initialized():
        raise RuntimeError("make_host_mesh needs an initialized process group")
    world = dist.get_world_size()
    if world % model_parallel:
        raise ValueError(f"model_parallel={model_parallel} does not divide {world} ranks")
    return _mesh(device_type, (world // model_parallel, model_parallel), ("data", "model"))
