"""Hopper kernel: fused fleet-wide VAoI proxy (Eq. 5 + Eq. 7).

Replaces ``src/repro/kernels/vaoi_distance.py::vaoi_distance`` (Pallas, body
``_make_kernel``).  Source: ``csrc/vaoi_distance.cu``, CUDA C++ for sm_90a.
Bound: the bytes it moves, 2·N·F·elt + 16·N (v and h read, age and q read,
m and new_age written), or one launch, whichever is longer.  At the main
path's (100, 10) the bytes are about 9.6 KB, so the launch bounds it:
:func:`launch_floor` runs this wrapper's whole path into an empty kernel on
the same grid, and that time is the bound.  Design: two routes, chosen by F
in the launcher.  For F <= 32 (the main path's F is 10) one thread per
client row runs its F values through an fp32 ``fmaf`` chain, so no lane of
a warp idles; above 32 one warp per row strides its lanes over F and
reduces with warp shuffles.  Either replaces the TPU's sequential F grid
axis and VMEM accumulator; any N and F, no padding.  At this size the host
path is most of a call, so the wrapper keeps it lean: one check pass, no
device context, the stream's raw handle, the two outputs as ``empty_like``
of ``age``, and the launcher's arguments packed into one parameter block
(one pointer for ctypes to convert in place of eleven).

:func:`vaoi_distance` only launches the kernel: it takes tensors on the
current CUDA device and raises on anything else.  ``kernels.ops`` routes
CPU tensors to the plain version in ``kernels.ref``.
"""
from __future__ import annotations

import ctypes
import functools
import struct
from typing import Tuple

import torch

from repro_torch.kernels import build

_DTYPES = (torch.float32, torch.bfloat16)
# VaoiArgs of csrc/vaoi_distance.cu: v, h, age, q, m_out, age_out, stream; mu; n, f, is_bf16
_ARGS = struct.Struct("7Qf3i")


@functools.cache
def _launcher(name: str):
    fn = getattr(build.library("vaoi_distance"), name)
    fn.argtypes = [ctypes.c_char_p]
    fn.restype = ctypes.c_int
    return fn


def check_inputs(v: torch.Tensor, h: torch.Tensor, age: torch.Tensor, q: torch.Tensor) -> None:
    """Raise on what the kernel does not take (device aside)."""
    if v.dim() != 2 or h.shape != v.shape:
        raise ValueError(f"v and h must both be (N, F); got {tuple(v.shape)} and {tuple(h.shape)}")
    if v.dtype not in _DTYPES or h.dtype != v.dtype:
        raise TypeError(f"v and h must share one dtype of {_DTYPES}; got {v.dtype} and {h.dtype}")
    n = (v.shape[0],)
    if age.shape != n or q.shape != n or age.dtype != torch.float32 or q.dtype != torch.float32:
        raise ValueError(f"age and q must be {n} float32; got {tuple(age.shape)} {age.dtype}, "
                         f"{tuple(q.shape)} {q.dtype}")
    if not (v.is_contiguous() and h.is_contiguous() and age.is_contiguous() and q.is_contiguous()):
        raise ValueError("v, h, age and q must be contiguous")
    if v.numel() >= 2**31:
        raise ValueError("N·F must fit in a 32-bit int")


def _call(launcher: str, v, h, age, q, mu) -> Tuple[torch.Tensor, torch.Tensor]:
    """The wrapper path: checks, the stream, the outputs, the launch."""
    check_inputs(v, h, age, q)
    index = v.get_device()
    if h.get_device() != index or age.get_device() != index or q.get_device() != index:
        index = -2  # more than one device: launch_stream raises
    stream = build.launch_stream("vaoi_distance", index)
    n, f = v.shape
    m, new_age = torch.empty_like(age), torch.empty_like(age)  # age: (N,) fp32, contiguous, on the card
    if n:
        err = _launcher(launcher)(_ARGS.pack(
            v.data_ptr(), h.data_ptr(), age.data_ptr(), q.data_ptr(), m.data_ptr(), new_age.data_ptr(), stream,
            float(mu), n, f, v.dtype == torch.bfloat16,
        ))
        if err != 0:
            raise RuntimeError(f"vaoi_distance kernel launch failed: CUDA error {err}")
    return m, new_age


def vaoi_distance(
    v: torch.Tensor, h: torch.Tensor, age: torch.Tensor, q: torch.Tensor, mu: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """v, h: (N, F) fp32 or bf16; age, q: (N,) fp32 -> (m, new_age), (N,) fp32 each."""
    out = _call("vaoi_distance_launch", v, h, age, q, mu)
    if v.shape[0]:
        vaoi_distance.launches += 1
    return out


def launch_floor(
    v: torch.Tensor, h: torch.Tensor, age: torch.Tensor, q: torch.Tensor, mu: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`vaoi_distance`'s whole path (checks, stream, outputs, launch,
    the count's test) into an empty kernel on the same grid: the least time
    a call can take.  The outputs are uninitialised."""
    out = _call("vaoi_empty_launch", v, h, age, q, mu)
    if v.shape[0]:
        launch_floor.launches += 1
    return out


vaoi_distance.launches = 0
launch_floor.launches = 0  # not a kernel of the main path: kernels.ops neither lists nor resets it
