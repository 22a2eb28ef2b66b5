"""Hopper kernel: fused fleet-wide VAoI proxy (Eq. 5 + Eq. 7).

Replaces ``src/repro/kernels/vaoi_distance.py::vaoi_distance`` (Pallas, body
``_make_kernel``).  Source: ``csrc/vaoi_distance.cu``, CUDA C++ for sm_90a.
Bound: the bytes it moves, 2·N·F·elt + 16·N (v and h read, age and q read,
m and new_age written).  At the main path's (100, 10) that is about 9.6 KB,
so the launch bounds it.  Design: one warp per client row, lanes striding
over F with an fp32 accumulator and a warp-shuffle reduce, in place of the
TPU's sequential F grid axis and VMEM accumulator; any N and F, no padding.

:func:`vaoi_distance` only launches the kernel: it takes CUDA tensors and
raises on anything else.  ``kernels.ops`` routes CPU tensors to the plain
version in ``kernels.ref``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.kernels import build

_DTYPES = (torch.float32, torch.bfloat16)


@functools.cache
def _launcher():
    fn = build.library("vaoi_distance").vaoi_distance_launch
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, ctypes.c_float, i, i, i, p, p, p]
    fn.restype = i
    return fn


def check_inputs(v: torch.Tensor, h: torch.Tensor, age: torch.Tensor, q: torch.Tensor) -> None:
    """Raise on what the kernel does not take (device aside)."""
    if v.dim() != 2 or h.shape != v.shape:
        raise ValueError(f"v and h must both be (N, F); got {tuple(v.shape)} and {tuple(h.shape)}")
    if v.dtype not in _DTYPES or h.dtype != v.dtype:
        raise TypeError(f"v and h must share one dtype of {_DTYPES}; got {v.dtype} and {h.dtype}")
    n = v.shape[0]
    for name, t in (("age", age), ("q", q)):
        if t.shape != (n,) or t.dtype != torch.float32:
            raise ValueError(f"{name} must be ({n},) float32; got {tuple(t.shape)} {t.dtype}")
    for name, t in (("v", v), ("h", h), ("age", age), ("q", q)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if v.numel() >= 2**31:
        raise ValueError("N·F must fit in a 32-bit int")


def vaoi_distance(
    v: torch.Tensor, h: torch.Tensor, age: torch.Tensor, q: torch.Tensor, mu: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """v, h: (N, F) fp32 or bf16; age, q: (N,) fp32 -> (m, new_age), (N,) fp32 each."""
    check_inputs(v, h, age, q)
    dev = v.device
    if dev.type != "cuda" or any(t.device != dev for t in (h, age, q)):
        raise ValueError(
            "the vaoi_distance kernel needs all inputs on one CUDA device; "
            "kernels.ops.vaoi_distance takes CPU tensors"
        )
    n, f = v.shape
    m = torch.empty(n, dtype=torch.float32, device=dev)
    new_age = torch.empty(n, dtype=torch.float32, device=dev)
    if n == 0:
        return m, new_age
    with torch.cuda.device(dev):
        err = _launcher()(
            v.data_ptr(), h.data_ptr(), age.data_ptr(), q.data_ptr(), float(mu), n, f,
            int(v.dtype == torch.bfloat16), m.data_ptr(), new_age.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"vaoi_distance kernel launch failed: CUDA error {err}")
    vaoi_distance.launches += 1
    return m, new_age


vaoi_distance.launches = 0
