"""Public kernel entry points: CPU tensors go to the plain versions in
``kernels.ref``; CUDA tensors go to the Hopper kernels, which launch or
raise.  There is no fallback from a CUDA tensor to a plain version."""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels import conv_lanes as _conv
from repro_torch.kernels import ref
from repro_torch.kernels.mla_attention import mla_attention as _mla_attention
from repro_torch.kernels.mla_attention import takes_kernel as _mla_takes_kernel
from repro_torch.kernels.fedavg_reduce import fedavg_reduce as _fedavg_reduce
from repro_torch.kernels.fedavg_reduce import fedavg_reduce_leaves as _fedavg_reduce_leaves
from repro_torch.kernels.ssd_scan import ssd_scan as _ssd_scan
from repro_torch.kernels.swa_attention import swa_attention as _swa_attention
from repro_torch.kernels.vaoi_distance import vaoi_distance as _vaoi_distance

KERNELS = {
    "vaoi_distance": _vaoi_distance,
    "fedavg_reduce": _fedavg_reduce,
    "ssd_scan": _ssd_scan,
    "swa_attention": _swa_attention,
    "conv_lanes": _conv.conv_lanes,
    "mla_attention": _mla_attention,
}


def _on_cpu(*tensors: torch.Tensor) -> bool:
    kinds = {t.device.type for t in tensors}
    if len(kinds) != 1:
        raise ValueError(f"inputs span devices {sorted(kinds)}; put them on one device")
    return kinds == {"cpu"}


def vaoi_distance(v, h, age, q, mu):
    if _on_cpu(v, h, age, q):
        return ref.vaoi_distance_ref(v, h, age, q, mu)
    return _vaoi_distance(v, h, age, q, mu)


def fedavg_reduce(msgs, weights):
    """Weighted (K, P) -> (P,) reduce.  K may be the full client axis N or
    the compacted ``cap``-sized training slab."""
    if _on_cpu(msgs, weights):
        return ref.fedavg_reduce_ref(msgs, weights)
    return _fedavg_reduce(msgs, weights)


def fedavg_reduce_leaves(groups):
    """The same reduce read from the client leaves in place: one or two
    (stacked (K_g, ...) leaves, (K_g,) weights) groups -> (P,), leaf j in
    the next prod(shape_j) columns, the groups added in order.  Any number
    of leaves: the kernel takes them in runs of 32, one launch each."""
    # the kernel's wrapper checks every tensor of a table whose first weights are on the card
    if not (groups and groups[0][1].is_cuda) and _on_cpu(*(t for leaves, w in groups for t in (*leaves, w))):
        return ref.fedavg_reduce_leaves_ref(groups)
    return _fedavg_reduce_leaves(groups)


def ssd_scan(x, dt, A, Bm, Cm, chunk: int = 128):
    """Mamba2 SSD scan -> (y fp32, final state fp32).  On the CPU the plain
    version is the exact recurrence, which needs no ``chunk``."""
    if _on_cpu(x, dt, A, Bm, Cm):
        return ref.ssd_scan_ref(x, dt, A, Bm, Cm)
    return _ssd_scan(x, dt, A, Bm, Cm, chunk=chunk)


def swa_attention(q, k, v, window: int = 0, causal: bool = True):
    """Causal / sliding-window attention: q (B, H, S, D), k and v
    (B, Hkv, S, D) with Hkv dividing H -> (B, H, S, D) in q's dtype."""
    if _on_cpu(q, k, v):
        return ref.swa_attention_ref(q, k, v, window=window, causal=causal)
    return _swa_attention(q, k, v, window=window, causal=causal)


def conv_lanes(x, w, b):
    """A 3x3 convolution, stride 1, padding 1, of lanes that each hold
    their own weights: x (L, B, Cin, H, W), w (L, Cout, Cin, 3, 3), b
    (L, Cout) or None -> (L, B, Cout, H, W)."""
    if _on_cpu(*((x, w) if b is None else (x, w, b))):
        return ref.conv_lanes_ref(x, w, b)
    return _conv.forward(x, w, b)


def conv_lanes_input_grad(g, x, w):
    """dL/dx (L, B, Cin, H, W) of :func:`conv_lanes` from g = dL/dy; x gives the shape."""
    if _on_cpu(g, x, w):
        return ref.conv_lanes_input_grad_ref(g, x, w)
    return _conv.input_grad(g, w)


def conv_lanes_weight_grad(g, x, w):
    """(dL/dw (L, Cout, Cin, 3, 3), dL/db (L, Cout)) of :func:`conv_lanes`; w gives the shape."""
    if _on_cpu(g, x, w):
        return ref.conv_lanes_weight_grad_ref(g, x, w)
    return _conv.weight_grad(g, x, kernel_size=tuple(w.shape[-2:]))


def mla_attention(q, k, v, scale: float):
    """The causal core of multi-head latent attention: q, k (B, S, H, 192),
    v (B, S, H, 128) -> (B, S, H*128) in q's dtype; differentiable, and one
    launch a direction under ``torch.func.vmap`` on the card.  CUDA bf16
    inputs take the kernel, everything else (the CPU, fp32) the plain
    version, chosen from what q shows, with no fallback."""
    if _mla_takes_kernel(q):
        return _mla_attention(q, k, v, scale)
    return ref.mla_attention_ref(q, k, v, scale)


# kernels with more than one route, and the counter of each
ROUTES = {
    "ssd_scan": ("launches_tc", "launches_fma"),
    "swa_attention": ("launches_tc", "launches_fma"),
}


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def route_launch_counts() -> Dict[str, Dict[str, int]]:
    return {name: {r: getattr(KERNELS[name], r) for r in routes} for name, routes in ROUTES.items()}


def row_group_count() -> int:
    """Row groups the fedavg_reduce kernel reduced: a compacted epoch's one
    launch reduces two (the slab and the old-carrier stack)."""
    return _fedavg_reduce.row_groups


def reset_launch_counts() -> None:
    """Zero every kernel's counters: ``launches`` and each ``launches_*``
    (a route's, or one of conv_lanes' or mla_attention's directions)."""
    for fn in KERNELS.values():
        for counter in [a for a in vars(fn) if a.startswith("launches")]:
            setattr(fn, counter, 0)
    _fedavg_reduce.row_groups = 0


__all__ = [
    "vaoi_distance", "fedavg_reduce", "fedavg_reduce_leaves", "ssd_scan", "swa_attention", "conv_lanes",
    "conv_lanes_input_grad", "conv_lanes_weight_grad", "mla_attention", "launch_counts",
    "route_launch_counts", "row_group_count", "reset_launch_counts", "ref",
]
