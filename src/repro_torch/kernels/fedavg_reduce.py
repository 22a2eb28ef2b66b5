"""Hopper kernel: weighted FedAvg column reduce, out[p] = Σ_k w_k·msgs[k, p].

Replaces ``src/repro/kernels/fedavg_reduce.py::fedavg_reduce`` (Pallas, body
``_kernel``).  Source: ``csrc/fedavg_reduce.cu``, CUDA C++ for sm_90a.
Bound: the bytes it moves, K·P·elt + 4·K + 4·P, over the card's memory
rate; 2·K·P flops are far below the compute roof.  Design: one thread per
output column looping over K with an fp32 accumulator, so no sum crosses
blocks (the TPU kernel's sequential K grid axis has no counterpart on 132
SMs running in parallel), and neighbouring threads read neighbouring
columns so each row's load is coalesced.  Any K and P, fp32 or bf16
messages.  Zero-weight rows are read like the others: skipping them would
turn the reference's 0·Inf = NaN into 0.

:func:`fedavg_reduce` only launches the kernel: it takes CUDA tensors and
raises on anything else.  ``kernels.ops`` routes CPU tensors to the plain
version in ``kernels.ref``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

_DTYPES = (torch.float32, torch.bfloat16)


@functools.cache
def _launcher():
    fn = build.library("fedavg_reduce").fedavg_reduce_launch
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, i, i, i, p, p]
    fn.restype = i
    return fn


def check_inputs(msgs: torch.Tensor, weights: torch.Tensor) -> None:
    """Raise on what the kernel does not take (device aside)."""
    if msgs.dim() != 2:
        raise ValueError(f"msgs must be (K, P); got {tuple(msgs.shape)}")
    if msgs.dtype not in _DTYPES:
        raise TypeError(f"msgs must be one of {_DTYPES}; got {msgs.dtype}")
    k, p = msgs.shape
    if weights.shape != (k,) or weights.dtype != torch.float32:
        raise ValueError(f"weights must be ({k},) float32; got {tuple(weights.shape)} {weights.dtype}")
    if not msgs.is_contiguous() or not weights.is_contiguous():
        raise ValueError("msgs and weights must be contiguous")
    if p >= 2**31 or k >= 2**31:
        raise ValueError("K and P must each fit in a 32-bit int")


def fedavg_reduce(msgs: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """msgs: (K, P) fp32 or bf16; weights: (K,) fp32 -> (P,) fp32 weighted sum."""
    check_inputs(msgs, weights)
    dev = msgs.device
    if dev.type != "cuda" or weights.device != dev:
        raise ValueError(
            "the fedavg_reduce kernel needs msgs and weights on one CUDA device; "
            "kernels.ops.fedavg_reduce takes CPU tensors"
        )
    k, p = msgs.shape
    out = torch.empty(p, dtype=torch.float32, device=dev)
    if p == 0:
        return out
    with torch.cuda.device(dev):
        err = _launcher()(
            msgs.data_ptr(), weights.data_ptr(), k, p, int(msgs.dtype == torch.bfloat16),
            out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"fedavg_reduce kernel launch failed: CUDA error {err}")
    fedavg_reduce.launches += 1
    return out


fedavg_reduce.launches = 0
