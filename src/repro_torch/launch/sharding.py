"""Sharding rules for every architecture: the port of
``repro.launch.sharding``.

The rules are the reference's, in the reference's form: a spec is a tuple
with one entry per tensor dim, ``None``, a mesh axis name, or a tuple of
axis names (the entries of a ``jax.sharding.PartitionSpec``).
:func:`to_placements` turns a spec into DTensor ``Placement``s, one per
mesh dim, for ``torch.distributed.tensor``.

Baseline layout ("fsdp" mode, MaxText-style):
  * batch dims            -> ("pod", "data") / ("data",)
  * attention/MLP weights -> tensor-parallel on the feature axis over
                             "model", parameter-sharded ("FSDP") on the
                             other axis over "data" when divisible;
  * MoE expert stacks     -> expert-parallel over "model" (leading E axis),
                             FSDP over "data" on d;
  * KV caches             -> batch over "data", KV heads or head_dim over
                             "model";
  * SSM states            -> batch over "data", ssm heads over "model";
  * scheduler state       -> client-sharded over the data axes
                             (``scheduler_pspec``).

"tp" mode drops the FSDP factor (params replicated over "data").

The port's params and caches are per layer (``layers/3/attn/wq``); the
reference stacks them in super-blocks with a leading axis.  A leaf's rule
here is the reference's rule for the stacked leaf with that leading
``None`` dropped.  Paths are the '/'-joined keys of the tree
(:func:`repro_torch.models.decoder.flat_params`' dotted names with '/').
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from repro_torch.launch.mesh import data_axes

Spec = Tuple[Any, ...]


def _axis_size(mesh, name: str) -> int:
    names = mesh.mesh_dim_names
    return mesh.shape[names.index(name)] if name in names else 1


def _div(n: int, mesh, axis: str) -> Optional[str]:
    """Shard a dim of size n over axis only if it divides evenly."""
    return axis if n % _axis_size(mesh, axis) == 0 else None


def _batch_entry(mesh, batch: int):
    dp = data_axes(mesh)
    total = 1
    for a in dp:
        total *= _axis_size(mesh, a)
    return dp if batch % total == 0 else None


def batch_spec(mesh, batch: int, extra_dims: int = 1) -> Spec:
    return (_batch_entry(mesh, batch), *([None] * extra_dims))


def param_pspec(path: str, shape: Sequence[int], mesh, mode: str = "fsdp", embed_mode: str | None = None) -> Spec:
    """The rule by parameter name and rank for one per-layer leaf.

    ``embed_mode`` overrides the embedding/LM-head rule:
      None / "fsdp" : (V->model, d->data)  -- d-dim FSDP (baseline)
      "vocab_only"  : (V->model, None)     -- no contraction-dim sharding.
    """
    shape = tuple(shape)
    fsdp = mode == "fsdp"

    def d(n):  # data/fsdp factor
        return _div(n, mesh, "data") if fsdp else None

    def m(n):
        return _div(n, mesh, "model")

    name = path.split("/")[-1]
    rank = len(shape)
    none = (None,) * rank
    if name in ("embed", "lm_head"):
        if embed_mode == "vocab_only":
            return (m(shape[0]), None)
        return (m(shape[0]), d(shape[1]))
    if name in ("pos_embed", "enc_pos_embed"):
        return (None, m(shape[1]))
    if "norm" in name or name in ("scale", "bias", "A_log", "dt_bias", "D", "conv_b", "bo"):
        return none
    if "/moe/" in f"/{path}/" and "/shared/" not in f"/{path}/":
        if name == "router":
            return none
        if name in ("w_gate", "w_up", "w_down") and rank >= 3:
            # (E, a, b): expert-parallel over model, FSDP on a
            return (*(None,) * (rank - 3), m(shape[-3]), d(shape[-2]), None)
    if name in ("wq", "wk", "wv", "w_up", "w_gate", "in_proj", "shared_w_up"):
        return (*(None,) * (rank - 2), d(shape[-2]), m(shape[-1]))
    if name in ("bq", "bk", "bv"):
        return (*(None,) * (rank - 1), m(shape[-1]))
    if name in ("wo", "w_down", "out_proj"):
        return (*(None,) * (rank - 2), m(shape[-2]), d(shape[-1]))
    if name == "conv_w":  # (width, channels)
        return (*(None,) * (rank - 2), None, m(shape[-1]))
    return none


def cache_pspec(path: str, shape: Sequence[int], mesh, batch_only: bool = False) -> Spec:
    """A decode cache's leaf, per layer: (B, ...) here where the reference
    stacks (n_blocks, B, ...)."""
    name = path.split("/")[-1]
    shape = tuple(shape)
    bdim = _batch_entry(mesh, shape[0])
    if name in ("k", "v", "ck", "cv"):  # (B, W|S_enc, nkv, hd)
        if batch_only:
            return (bdim, None, None, None)
        kv = _div(shape[2], mesh, "model")
        hd = _div(shape[3], mesh, "model")
        if kv and _axis_size(mesh, "model") <= shape[2]:
            return (bdim, None, kv, None)
        return (bdim, None, None, hd)
    if name == "conv":  # (B, w-1, ch)
        return (bdim, None, _div(shape[2], mesh, "model"))
    if name == "ssm":  # (B, nh, hp, ds)
        return (bdim, _div(shape[1], mesh, "model"), None, None)
    return (None,) * len(shape)


def replicated(mesh) -> Spec:
    return ()


def scheduler_pspec(mesh) -> Spec:
    """Per-client scheduler/fleet state: the leading N axis over the data
    axes (``core/fleet.py``); the global model and keys stay replicated."""
    return (data_axes(mesh),)


def to_placements(spec: Spec, mesh) -> tuple:
    """DTensor placements of a spec, one per mesh dim: ``Shard(d)`` on each
    mesh dim that tensor dim d names (a tuple entry ("pod", "data") shards
    d over both, in that order), ``Replicate()`` on a mesh dim the spec
    does not name."""
    from torch.distributed.tensor import Replicate, Shard

    names = mesh.mesh_dim_names
    out = [Replicate() for _ in names]
    seen = set()
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        for axis in entry if isinstance(entry, tuple) else (entry,):
            if axis in seen:
                raise ValueError(f"spec {spec} maps mesh axis {axis!r} twice")
            if axis not in names:
                raise ValueError(f"spec {spec} names {axis!r}, not an axis of {names}")
            seen.add(axis)
            out[names.index(axis)] = Shard(dim)
    return tuple(out)


def _slash(name: str) -> str:
    return name.replace(".", "/")


def params_shardings(params, mesh, mode: str = "fsdp", embed_mode: str | None = None) -> Dict[str, tuple]:
    """The placements of every leaf, keyed by its dotted name
    (``decoder.flat_params``)."""
    from repro_torch.models.decoder import flat_params

    return {
        k: to_placements(param_pspec(_slash(k), v.shape, mesh, mode, embed_mode), mesh)
        for k, v in flat_params(params).items()
    }


def input_shardings(specs: Dict[str, torch.Tensor], mesh) -> Dict[str, tuple]:
    return {k: to_placements(batch_spec(mesh, v.shape[0], v.dim() - 1), mesh) for k, v in specs.items()}


def cache_shardings(cache, mesh, batch_only: bool = False) -> list:
    """The placements of a per-layer cache (``decoder.init_cache``): one
    dict a layer."""
    return [{k: to_placements(cache_pspec(k, v.shape, mesh, batch_only), mesh) for k, v in c.items()} for c in cache]


def distribute(t: torch.Tensor, mesh, placements) -> torch.Tensor:
    """``t`` as a DTensor of ``placements``, each rank keeping its own
    chunk of the whole ``t`` it holds (no communication: every rank holds
    the same ``t``, as after ``init_params`` from one seed)."""
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(t, mesh, placements, src_data_rank=None)


def distribute_params(params, mesh, mode: str = "fsdp", embed_mode: str | None = None):
    """The param tree as DTensors laid out by :func:`params_shardings`."""
    from repro_torch.models.decoder import flat_params, nest_params

    shard = params_shardings(params, mesh, mode, embed_mode)
    return nest_params({k: distribute(v, mesh, shard[k]) for k, v in flat_params(params).items()})


def distribute_inputs(batch: Dict[str, torch.Tensor], mesh) -> Dict[str, torch.Tensor]:
    shard = input_shardings(batch, mesh)
    return {k: distribute(v, mesh, shard[k]) for k, v in batch.items()}


def distribute_cache(cache, mesh, batch_only: bool = False) -> list:
    shard = cache_shardings(cache, mesh, batch_only)
    return [{k: distribute(v, mesh, s[k]) for k, v in c.items()} for c, s in zip(cache, shard)]
