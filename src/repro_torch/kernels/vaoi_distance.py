"""Hopper kernel: fused fleet-wide VAoI proxy (Eq. 5 + Eq. 7).

Replaces ``src/repro/kernels/vaoi_distance.py::vaoi_distance`` (Pallas, body
``_make_kernel``).  Source: ``csrc/vaoi_distance.cu``, CUDA C++ for sm_90a.
Bound: the bytes it moves, 2·N·F·elt + 16·N (v and h read, age and q read,
m and new_age written) over 3.35 TB/s, or one launch, whichever is longer.
At the main path's (100, 10) the bytes are about 9.6 KB, so the launch
bounds it: :func:`launch_floor` runs this wrapper's whole path into an
empty kernel on the same grid and cluster shape, and that time is the
floor.  At an LM's vocabulary-wide features ((8, 151,936) fp32 is 9.7 MB)
the bytes bound it.

Design: the route follows from F.  F <= 32 (the main path's F is 10):
one thread per client row, an fp32 ``fmaf`` chain, so no lane of a warp
idles.  F > 32: the cluster route.  Each row is cut into S of
{1, 2, 4, 8, 16} segments (:func:`split_plan`, passed to the launcher,
which derives the grid from N and S) so that a few rows still spread over
the card; the S blocks of a row run as one thread-block cluster, and rank
0 adds their partials in rank order from its shared memory, so two calls
give the same bits.  Many rows take S = 1, a block a row.  Rows are read
by 16-byte loads, four of v and four of h in flight a thread, each
segment with a scalar head and tail around its 16-byte body (any base
offset, any F).  (One warp a row for every F > 32, the route before it,
put (8, 151,936) on one block of one SM.)  Every route replaces the TPU's
sequential F grid axis and VMEM accumulator; any N and F, no padding.  At
the small shapes the host path is most of a call, so the wrapper keeps it
lean: one check pass, no device context, the stream's raw handle, the two
outputs as ``empty_like`` of ``age``, the plan cached, and the launcher's
arguments packed into one parameter block (one pointer for ctypes to
convert in place of twelve).

:func:`vaoi_distance` only launches the kernel: it takes tensors on the
current CUDA device and raises on anything else, a refused launch
included; nothing falls back to another route.  ``kernels.ops`` routes CPU
tensors to the plain version in ``kernels.ref``.
"""
from __future__ import annotations

import ctypes
import functools
import struct
from typing import Tuple

import torch

from repro_torch.kernels import build

_DTYPES = (torch.float32, torch.bfloat16)
# VaoiArgs of csrc/vaoi_distance.cu: v, h, age, q, m_out, age_out, stream; mu;
# n, f, is_bf16, segments
_ARGS = struct.Struct("7Qf4i")

MAX_ROW_F = 32  # the thread route's largest F (kMaxRowF in the .cu)
CLUSTER_THREADS = 256  # the cluster route's block, one a segment (kClusterThreads in the .cu)
MIN_VECS = 4  # 16-byte vectors a thread: one batch of loads in flight
SEGMENTS = (1, 2, 4, 8, 16)  # cluster sizes; above 8 is non-portable on sm_90


@functools.cache
def split_plan(n: int, f: int, elt_bytes: int, sms: int) -> int:
    """The segments S a row of (n, f) rows of ``elt_bytes`` is cut into on a
    card of ``sms`` SMs: 1 on the thread route (F <= MAX_ROW_F); on the
    cluster route the most S (at most 16) that keeps n·S within half the
    SMs and every segment CLUSTER_THREADS · MIN_VECS 16-byte vectors long.
    More, smaller clusters measured slower on an H100 (at (8, 151,936)
    fp32, S = 16 against S = 8: ``tools/vaoi_plan_sweep.py``, PERF.md §6)."""
    if f <= MAX_ROW_F:
        return 1
    row_vecs = -(-f * elt_bytes // 16)
    s = 1
    while s < SEGMENTS[-1] and 2 * n * (2 * s) <= sms and -(-row_vecs // (2 * s)) >= CLUSTER_THREADS * MIN_VECS:
        s *= 2
    return s


@functools.cache
def sm_count(index: int) -> int:
    """The SMs of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def plan_of(v: torch.Tensor) -> dict:
    """The route and segments a call on the CUDA tensor ``v`` (N, F) launches."""
    n, f = v.shape
    return {"route": "thread" if f <= MAX_ROW_F else "cluster",
            "segments": split_plan(n, f, v.element_size(), sm_count(v.get_device()))}


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
            float(mu), n, f, v.dtype == torch.bfloat16, split_plan(n, f, v.element_size(), sm_count(index)),
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
    """:func:`vaoi_distance`'s whole path (checks, stream, plan, outputs,
    launch, the count's test) into an empty kernel on the same grid and
    cluster shape: the least time a call can take.  The outputs are
    uninitialised."""
    out = _call("vaoi_empty_launch", v, h, age, q, mu)
    if v.shape[0]:
        launch_floor.launches += 1
    return out


vaoi_distance.launches = 0
launch_floor.launches = 0  # not a kernel of the main path: kernels.ops neither lists nor resets it
