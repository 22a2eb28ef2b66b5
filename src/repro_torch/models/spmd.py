"""The models' few places that need a layout when their inputs are DTensors.

The launch layer runs the same model code on DTensors laid out by
``launch/sharding.py`` (the dry-run on a fake mesh, the sharded steps on
real ranks).  Most ops propagate their sharding by themselves.  The ones
below do not, or do so only through a layout the propagation cannot take
(a gather over a vocab-sharded axis, heads split inside an einsum, the MoE
dispatch's scatter), and name their layout here.  On plain tensors every
function in this module is the identity or calls its function directly,
so the single-device path is unchanged bit for bit.

A spec is the sharding rule's form (``launch/sharding.py``): one entry per
tensor dim, ``None``, a mesh axis name or a tuple of them; ``BATCH`` stands
for the mesh's data axes when the leading dim divides over them.
"""
from __future__ import annotations

from typing import Any, Callable, Optional, Sequence

import torch
from torch.distributed.tensor import DTensor

BATCH = "<batch>"
# an out spec: a scalar that is the mean of the batch shards' values
PARTIAL_AVG = "<partial avg over the batch>"


def is_dtensor(x: Any) -> bool:
    return isinstance(x, DTensor)


def mesh_of(*xs: Any):
    """The mesh of the first DTensor among ``xs``, or None."""
    for x in xs:
        if isinstance(x, DTensor):
            return x.device_mesh
    return None


def model_size(mesh) -> int:
    names = mesh.mesh_dim_names
    return mesh.shape[names.index("model")] if "model" in names else 1


def placements(mesh, spec: Sequence[Any], batch: int = 0) -> tuple:
    """``spec``'s placements on ``mesh``; ``BATCH`` becomes the data axes
    when ``batch`` divides over them, else ``None``."""
    from repro_torch.launch.sharding import to_placements

    entry = _batch_axes(mesh, batch) or None
    return to_placements(tuple(entry if e == BATCH else e for e in spec), mesh)


def _batch_axes(mesh, batch: int) -> tuple:
    """The data axes when ``batch`` divides over them, else ()."""
    from repro_torch.launch.sharding import batch_spec

    return batch_spec(mesh, batch, 0)[0] or ()


def _out_placements(mesh, spec, batch: int) -> tuple:
    """A PARTIAL_AVG output is a partial sum of each shard's value over the
    shard count (a ``Partial("avg")`` would hand each shard the whole
    gradient in the backward, not its share)."""
    if spec != PARTIAL_AVG:
        return placements(mesh, spec, batch)
    from torch.distributed.tensor import Partial, Replicate

    axes = _batch_axes(mesh, batch)
    return tuple(Partial() if n in axes else Replicate() for n in mesh.mesh_dim_names)


def _grad_placements(mesh, pl: tuple, summed: Optional[str], batch: int) -> tuple:
    """``pl`` with the mesh dims over which a local gradient is only a
    partial sum made ``Partial``: ``summed`` names "batch" (the data axes,
    when the batch is sharded over them), "model", or both."""
    if summed is None:
        return pl
    from torch.distributed.tensor import Partial

    axes = (_batch_axes(mesh, batch) if "batch" in summed else ()) + (("model",) if "model" in summed else ())
    return tuple(Partial() if n in axes else q for n, q in zip(mesh.mesh_dim_names, pl))


def local(
    fn: Callable,
    out_specs,
    in_specs: Sequence[Optional[Sequence[Any]]],
    *args,
    batch: Optional[int] = None,
    grad_sums: Optional[Sequence[Optional[str]]] = None,
):
    """``fn(*args)`` on plain tensors.  With a DTensor among ``args``: each
    DTensor argument redistributed to its spec in ``in_specs`` (None for a
    plain or non-tensor argument), ``fn`` on the local shards, and its
    outputs (a tensor, or a tuple of them) wrapped as DTensors of
    ``out_specs`` (a spec, ``PARTIAL_AVG``, or a list of them for a
    tuple).  ``batch`` resolves ``BATCH``; by default the first DTensor
    argument's leading dim.

    ``grad_sums`` names, per argument, where the local gradient ``fn``'s
    backward gives it is only a partial sum: "batch" for a replicated
    weight used on a batch shard (the shards' gradients add up), "model"
    for an input every model rank uses for its own heads, "batch+model"
    for both; None where the local gradient is the whole gradient of the
    local input."""
    mesh = mesh_of(*args)
    if mesh is None:
        return fn(*args)
    from torch.distributed.tensor.experimental import local_map

    if batch is None:
        batch = next(a.shape[0] for a in args if isinstance(a, DTensor))
    ins = tuple(None if s is None else placements(mesh, s, batch) for s in in_specs)
    grads = None
    if grad_sums is not None:
        grads = tuple(None if pl is None else _grad_placements(mesh, pl, g, batch) for pl, g in zip(ins, grad_sums))
    specs = out_specs if isinstance(out_specs, list) else [out_specs]
    outs = tuple(_out_placements(mesh, s, batch) for s in specs)
    if PARTIAL_AVG in specs:
        shards = 1
        for n in _batch_axes(mesh, batch):
            shards *= mesh.shape[mesh.mesh_dim_names.index(n)]
        inner = fn

        def fn(*a):
            res = inner(*a)
            return tuple(r / shards if s == PARTIAL_AVG else r for r, s in zip(res, specs))

    return local_map(fn, outs, ins, grads, device_mesh=mesh, redistribute_inputs=True)(*args)


def to_batch_layout(x: torch.Tensor) -> torch.Tensor:
    """A DTensor redistributed to the activations' layout: the leading dim
    over the data axes, the rest whole.  The identity on a plain tensor."""
    if not isinstance(x, DTensor):
        return x
    return x.redistribute(x.device_mesh, placements(x.device_mesh, (BATCH,) + (None,) * (x.dim() - 1), x.shape[0]))


def replicate(x: torch.Tensor) -> torch.Tensor:
    """A DTensor whole on every rank; the identity on a plain tensor."""
    if not isinstance(x, DTensor):
        return x
    return x.redistribute(x.device_mesh, placements(x.device_mesh, (None,) * x.dim()))


def tp_input(x: torch.Tensor) -> torch.Tensor:
    """The input of a tensor-parallel sublayer: the identity forward; in the
    backward its gradient, a partial sum over ``model`` after a
    column-parallel weight, is reduced back to ``x``'s layout here (one
    all-reduce, Megatron's f operator) instead of travelling on as a
    partial sum into the products below.  The identity on a plain tensor."""
    if not isinstance(x, DTensor):
        return x
    return DTensor.from_local(
        x.to_local(), x.device_mesh, x.placements, run_check=False, shape=x.shape, stride=x.stride()
    )


def gather_fsdp(tree: Any) -> Any:
    """A layer's params with their FSDP factor gathered: each DTensor leaf
    redistributed whole over the data axes (keeping its ``model`` shards),
    as FSDP gathers a layer's weights before it runs; the gradients come
    back reduce-scattered by the redistribution's backward.  Plain leaves
    (and a tree with none sharded over the data axes) pass unchanged."""
    from torch.distributed.tensor import Replicate

    def one(t):
        if not isinstance(t, DTensor):
            return t
        names = t.device_mesh.mesh_dim_names
        pl = tuple(Replicate() if n in ("pod", "data") else q for n, q in zip(names, t.placements))
        return t if pl == tuple(t.placements) else t.redistribute(t.device_mesh, pl)

    if isinstance(tree, dict):
        return {k: gather_fsdp(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [gather_fsdp(v) for v in tree]
    return one(tree)


def arange_like_last(x: DTensor) -> DTensor:
    """``arange(x.shape[-1])`` as a DTensor laid out like the DTensor
    ``x``'s last dim, so that a compare against it stays on each rank's
    columns."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    last = x.dim() - 1
    pl = tuple(Shard(0) if isinstance(q, Shard) and q.dim == last else Replicate() for q in x.placements)
    return distribute_tensor(torch.arange(x.shape[-1], device=x.device), x.device_mesh, pl, src_data_rank=None)
