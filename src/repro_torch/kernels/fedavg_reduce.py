"""Hopper kernel: weighted FedAvg reduce, out[p] = Σ_k w_k·msgs[k, p], read
from the client leaves in place.

Replaces ``src/repro/kernels/fedavg_reduce.py::fedavg_reduce`` (Pallas, body
``_kernel``).  Source: ``csrc/fedavg_reduce.cu``, CUDA C++ for sm_90a.
Bound: the bytes it moves, Σ_g K_g·P·elt + 4·Σ_g K_g + 4·P, over the card's
memory rate; 2·Σ_g K_g·P flops are far below the compute roof.  The TPU
kernel reads one (K, P) matrix that its caller concatenates from the
model's leaves; a copy of the (100, 845,738) old-carrier stack moves more
bytes than the reduce itself.  So the kernel takes a table instead: one or
two row groups (the compacted path's slab and its old-carrier stack), each
a list of stacked (K, *shape) leaves in ``flatten``'s order (sorted names)
and a (K,) fp32 weight vector, and leaf j fills the next cols_j columns of
the (P,) output.  Both groups go in one launch with one fp32 accumulator
each, added as acc_0 + acc_1, the rounding of two reduces and an add.  A
launch's table holds up to 32 leaves: a table that fits goes in one
launch, a larger model in runs of 32, one launch each.
Each thread owns 4 columns of a leaf and reads them with one 16-byte (fp32)
or 8-byte (bf16) load per row, 4 rows in flight; blocks of 64 threads under
a 32-register budget keep all of the main path's ~3,300 blocks resident at
once, so no tail wave trails the reduce.  Leaves whose rows are not aligned
for that load are read with scalar loads.
Zero-weight rows are read like the others: skipping them would turn the
reference's 0·Inf = NaN into 0.

:func:`fedavg_reduce` (one (K, P) matrix, the TPU kernel's signature) is the
one-group, one-leaf case of :func:`fedavg_reduce_leaves`.  Both only launch
the kernel: they take tensors on the current CUDA device and raise on
anything else.  ``kernels.ops`` routes CPU tensors to the plain versions in
``kernels.ref``.  ``fedavg_reduce.launches`` counts launches and
``fedavg_reduce.row_groups`` the row groups they reduced (a group once per
launch that reads it).
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import List, Sequence, Tuple

import torch

from repro_torch.kernels import build

_DTYPES = (torch.float32, torch.bfloat16)
MAX_GROUPS, MAX_LEAVES = 2, 32  # kMaxGroups, kMaxLeaves of csrc/fedavg_reduce.cu

Group = Tuple[Sequence[torch.Tensor], torch.Tensor]  # (stacked (K, ...) leaves, (K,) fp32 weights)


@functools.cache
def _launcher():
    fn = build.library("fedavg_reduce").fedavg_leaves_launch
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [i, i, ctypes.POINTER(p), ctypes.POINTER(p), ctypes.POINTER(i), ctypes.POINTER(i), i, p, p]
    fn.restype = i
    return fn


def check_leaves(groups: Sequence[Group]) -> Tuple[List[int], List[int], int]:
    """One pass over the table: raise on what the kernel does not take.
    Returns each leaf's column count, the leaves' data pointers (group by
    group) and the device index all of them share (-1 on the CPU)."""
    if not 1 <= len(groups) <= MAX_GROUPS:
        raise ValueError(f"the kernel takes 1 to {MAX_GROUPS} row groups; got {len(groups)}")
    first = groups[0][0]
    if not first:
        raise ValueError("the table has no leaves")
    dtype = first[0].dtype
    if dtype not in _DTYPES:
        raise TypeError(f"leaves must be one of {_DTYPES}; got {dtype}")
    shapes = [leaf.shape[1:] for leaf in first]
    cols = [math.prod(s) for s in shapes]
    if sum(cols) >= 2**31:
        raise ValueError("P must fit in a 32-bit int")
    ptrs, devices = [], set()
    for g, (leaves, w) in enumerate(groups):
        if w.dim() != 1 or w.dtype != torch.float32 or not w.is_contiguous() or w.shape[0] >= 2**31:
            raise ValueError(f"group {g}'s weights must be a contiguous (K,) float32; got {tuple(w.shape)} {w.dtype}")
        if len(leaves) != len(first):
            raise ValueError(f"group {g} has {len(leaves)} leaves; group 0 has {len(first)}")
        k = w.shape[0]
        devices.add(w.get_device())
        for j, leaf in enumerate(leaves):
            if leaf.dtype != dtype:
                raise TypeError(f"group {g} leaf {j} is {leaf.dtype}; the leaves must share {dtype}")
            shape = leaf.shape
            if not shape or shape[0] != k or (g and shape[1:] != shapes[j]):
                raise ValueError(f"group {g} leaf {j} must be ({k}, *{tuple(shapes[j])}); got {tuple(shape)}")
            if not leaf.is_contiguous():
                raise ValueError(f"group {g} leaf {j} must be contiguous; strides {leaf.stride()}")
            devices.add(leaf.get_device())
            ptrs.append(leaf.data_ptr())
    if len(devices) != 1:
        raise ValueError(f"the fedavg_reduce kernel needs its table on one CUDA device; got devices {sorted(devices)}")
    return cols, ptrs, devices.pop()


def fedavg_reduce_leaves(groups: Sequence[Group]) -> torch.Tensor:
    """groups: one or two (leaves, weights) pairs; each group's leaves are
    stacked (K_g, *shape_j) tensors, shape_j shared by the groups, and its
    weights (K_g,) fp32.  -> (P,) fp32, P = Σ_j prod(shape_j): leaf j's
    Σ_g Σ_k w_g[k]·leaf_gj[k] flattened into the next prod(shape_j)
    columns, the groups added in their order.

    One launch takes up to ``MAX_LEAVES`` leaves (the by-value table's
    room): a table that fits goes in one launch, its argument arrays built
    from the whole table at once; a model with more (qwen1.5-0.5b's 290)
    goes in runs of ``MAX_LEAVES`` (:func:`reduce_in_runs`)."""
    cols, ptrs, index = check_leaves(groups)
    stream = build.launch_stream("fedavg_reduce", index)
    out = torch.empty(sum(cols), dtype=torch.float32, device=groups[0][1].device)
    if out.numel() == 0:
        return out
    if len(cols) > MAX_LEAVES:
        return reduce_in_runs(groups, cols, ptrs, stream, out)
    ng, nl = len(groups), len(cols)
    err = _launcher()(
        ng, nl, (ctypes.c_void_p * (ng * nl))(*ptrs), (ctypes.c_void_p * ng)(*[w.data_ptr() for _, w in groups]),
        (ctypes.c_int * ng)(*[w.shape[0] for _, w in groups]), (ctypes.c_int * nl)(*cols),
        int(groups[0][0][0].dtype == torch.bfloat16), out.data_ptr(), stream,
    )
    if err != 0:
        raise RuntimeError(f"fedavg_reduce kernel launch failed: CUDA error {err}")
    fedavg_reduce.launches += 1
    fedavg_reduce.row_groups += ng
    return out


def reduce_in_runs(groups: Sequence[Group], cols: List[int], ptrs: List[int], stream: int,
                   out: torch.Tensor) -> torch.Tensor:
    """The table (checked by :func:`check_leaves`) in runs of
    ``MAX_LEAVES`` leaves on ``stream``, one launch each, each writing its
    own slice of ``out``.  A run whose slice does not start on a 16-byte
    boundary (the kernel's wide stores assume one) is written to a buffer
    of its own and copied in."""
    ng, nl = len(groups), len(cols)
    weights = (ctypes.c_void_p * ng)(*[w.data_ptr() for _, w in groups])
    rows = (ctypes.c_int * ng)(*[w.shape[0] for _, w in groups])
    is_bf16 = int(groups[0][0][0].dtype == torch.bfloat16)
    off = 0
    for j0 in range(0, nl, MAX_LEAVES):
        run = range(j0, min(j0 + MAX_LEAVES, nl))
        n = sum(cols[j] for j in run)
        dst = out[off : off + n] if off % 4 == 0 else torch.empty_like(out[:n])
        err = _launcher()(
            ng, len(run), (ctypes.c_void_p * (ng * len(run)))(*[ptrs[g * nl + j] for g in range(ng) for j in run]),
            weights, rows, (ctypes.c_int * len(run))(*[cols[j] for j in run]), is_bf16, dst.data_ptr(), stream,
        )
        if err != 0:
            raise RuntimeError(f"fedavg_reduce kernel launch failed: CUDA error {err}")
        fedavg_reduce.launches += 1
        fedavg_reduce.row_groups += ng
        if off % 4:
            out[off : off + n].copy_(dst)
        off += n
    return out


def fedavg_reduce(msgs: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """msgs: (K, P) fp32 or bf16; weights: (K,) fp32 -> (P,) fp32 weighted sum."""
    if msgs.dim() != 2:
        raise ValueError(f"msgs must be (K, P); got {tuple(msgs.shape)}")
    return fedavg_reduce_leaves([([msgs], weights)])


fedavg_reduce.launches = 0
fedavg_reduce.row_groups = 0
