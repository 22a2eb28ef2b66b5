"""Hopper kernel: the Mamba2 SSD chunked scan.

Replaces ``src/repro/kernels/ssd_scan.py::ssd_scan`` (Pallas, body
``_make_kernel``).  Source: ``csrc/ssd_scan.cu``, CUDA C++ for sm_90a.
Bound: operations.  At the prefill shape (4, 2048, 64, 64, 128, L=256) the
chunked form needs ~26 GFLOP of fp32 multiply-adds (C·Bᵀ once per batch row
and chunk, causal triangles only) against ~0.22 GB of traffic.  Design: one
thread block per (batch, head) walks the chunks in order with the (hp, ds)
fp32 state in shared memory, in place of the TPU's sequential chunk grid
axis and VMEM scratch; inside a chunk, 64-row tiles with per-thread register
tiles on the fp32 FMA units; a block-wide scan gives ``a_cum``.

It takes ``L = min(chunk, S)`` as the Pallas wrapper does; a ragged last
chunk is masked inside the kernel (rows at or past S count as dt = 0, as the
Pallas zero padding does), so nothing is padded or copied.  x, Bm and Cm are
read through their strides: in ``models.ssd.ssd_forward`` they are slices of
one projection and go in as views.  There is no backward kernel, so inputs
that require grad are refused.

:func:`ssd_scan` only launches the kernel: it takes CUDA tensors and raises
on anything else.  ``kernels.ops`` routes CPU tensors to the plain version
in ``kernels.ref``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.kernels import build

_DTYPES = (torch.float32, torch.bfloat16)
# the kernel's instances: the reference configs' widths (mamba2-1.3b hp 64,
# ds 128; jamba 64, 16) and reduced()'s (32, 16)
HEAD_DIMS = (32, 64)
STATE_DIMS = (16, 128)
SMEM_LIMIT = 232_448  # bytes of shared memory one block may use on sm_90


@functools.cache
def _lib():
    lib = build.library("ssd_scan")
    p, i, q = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ssd_scan_launch.argtypes = [p] * 7 + [i] * 7 + [q] * 13 + [p]
    lib.ssd_scan_launch.restype = i
    lib.ssd_scan_smem_bytes.argtypes = [i, i, i]
    lib.ssd_scan_smem_bytes.restype = q
    return lib


def check_inputs(x, dt, A, Bm, Cm, chunk: int) -> None:
    """Raise on what the kernel does not take (device aside)."""
    if x.dim() != 4:
        raise ValueError(f"x must be (B, S, nh, hp); got {tuple(x.shape)}")
    b, s, nh, hp = x.shape
    if dt.shape != (b, s, nh):
        raise ValueError(f"dt must be {(b, s, nh)}; got {tuple(dt.shape)}")
    if A.shape != (nh,):
        raise ValueError(f"A must be ({nh},); got {tuple(A.shape)}")
    if Bm.dim() != 3 or Bm.shape[:2] != (b, s) or Cm.shape != Bm.shape:
        raise ValueError(f"Bm and Cm must both be ({b}, {s}, ds); got {tuple(Bm.shape)} and {tuple(Cm.shape)}")
    if x.dtype not in _DTYPES or Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        raise TypeError(f"x, Bm and Cm must share one dtype of {_DTYPES}; got {x.dtype}, {Bm.dtype}, {Cm.dtype}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise TypeError(f"dt and A must be float32; got {dt.dtype} and {A.dtype}")
    if hp not in HEAD_DIMS or Bm.shape[-1] not in STATE_DIMS:
        raise ValueError(f"the kernel takes hp in {HEAD_DIMS} and ds in {STATE_DIMS}; got {hp}, {Bm.shape[-1]}")
    if s < 1 or b < 1 or nh < 1:
        raise ValueError(f"B, S and nh must be at least 1; got {(b, s, nh)}")
    if b > 65_535 or s >= 2**31 or chunk < 1:
        raise ValueError(f"need 1 <= chunk, B <= 65535 and S < 2**31; got chunk={chunk}, B={b}, S={s}")
    if any(t.requires_grad for t in (x, dt, A, Bm, Cm)):
        raise ValueError("ssd_scan has no backward kernel: call it on inputs that do not require grad")


def ssd_scan(
    x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor, chunk: int = 128
) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, nh, hp) fp32/bf16; dt (B, S, nh) fp32 post-softplus; A (nh,)
    fp32 < 0; Bm, Cm (B, S, ds) like x.  Returns (y (B, S, nh, hp) fp32,
    final state (B, nh, hp, ds) fp32), from a zero initial state."""
    check_inputs(x, dt, A, Bm, Cm, chunk)
    dev = x.device
    if dev.type != "cuda" or any(t.device != dev for t in (dt, A, Bm, Cm)):
        raise ValueError(
            "the ssd_scan kernel needs all inputs on one CUDA device; kernels.ops.ssd_scan takes CPU tensors"
        )
    b, s, nh, hp = x.shape
    ds = Bm.shape[-1]
    L = min(chunk, s)
    lib = _lib()
    smem = lib.ssd_scan_smem_bytes(hp, ds, L)
    if smem > SMEM_LIMIT:
        raise ValueError(f"chunk {L} with hp={hp}, ds={ds} needs {smem} B of shared memory (> {SMEM_LIMIT})")
    y = torch.empty(b, s, nh, hp, dtype=torch.float32, device=dev)
    state = torch.empty(b, nh, hp, ds, dtype=torch.float32, device=dev)
    A = A.contiguous()
    with torch.cuda.device(dev):
        err = lib.ssd_scan_launch(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
            y.data_ptr(), state.data_ptr(), b, s, nh, hp, ds, L, int(x.dtype == torch.bfloat16),
            *x.stride(), *dt.stride(), *Bm.stride(), *Cm.stride(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: CUDA error {err}")
    ssd_scan.launches += 1
    return y, state


ssd_scan.launches = 0
