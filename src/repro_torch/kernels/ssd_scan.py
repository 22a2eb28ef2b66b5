"""Hopper kernel: the Mamba2 SSD chunked scan.

Replaces ``src/repro/kernels/ssd_scan.py::ssd_scan`` (Pallas, body
``_make_kernel``).  Source: ``csrc/ssd_scan.cu``, CUDA C++ for sm_90a.  At
the prefill shape (4, 2048, 64, 64, 128, L=256) the chunked form needs
26.07 GFLOP against 0.216 GB of traffic: 0.389 ms on the fp32 FMA units,
while on the bf16 tensor cores the bytes bound it, at 0.0645 ms.  One thread
block per (batch, head) walks the sequence in order with the (hp, ds) fp32
state on chip, in place of the TPU's sequential chunk grid axis and VMEM
scratch.

Two routes, chosen by dtype, neither a fallback for the other (a route that
fails to launch raises):

- bf16, the model's route: ``wgmma`` on the tensor cores (bf16 in, fp32
  accumulators) over 64-row tiles: G = C·Bᵀ, P = G ∘ exp(a_i − a_j) ∘ dt_j
  rounded to bf16, Y = exp(a_i)·C·Sᵀ + P·X with a bf16 copy of the fp32
  state, S ← S·exp(a_last) + (X∘w)ᵀ·B with X∘w rounded to bf16.  x, B and C
  tiles arrive by TMA into two stages, each loaded once.  Its chunk is its
  64-row tile whatever ``chunk`` asks: the chunked form is the recurrence
  for every chunk length, so the function is the same and only where it
  rounds moves; :func:`ssd_bf16_limit` bounds that, for any chunking.  TMA
  needs the last dim contiguous, a 16-byte-aligned base and 16-byte-multiple
  strides: :func:`check_inputs` refuses the rest.  Counted in
  ``ssd_scan.launches_tc``.
- fp32, the correctness route: fp32 FMA tiles over chunks of
  ``L = min(chunk, S)``, any strides.  Counted in ``ssd_scan.launches_fma``.

``ssd_scan.launches`` counts both.  A ragged last chunk or tile is masked
inside the kernel (rows at or past S count as dt = 0, as the Pallas zero
padding does), so nothing is padded or copied.  x, Bm and Cm are read
through their strides: in ``models.ssd.ssd_forward`` they are slices of one
projection and go in as views.  There is no backward kernel, so inputs that
require grad are refused.

:func:`ssd_scan` only launches the kernel: it takes CUDA tensors and raises
on anything else.  ``kernels.ops`` routes CPU tensors to the plain version
in ``kernels.ref``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.kernels import build, ref

_DTYPES = (torch.float32, torch.bfloat16)
# the kernel's instances: the reference configs' widths (mamba2-1.3b hp 64,
# ds 128; jamba 64, 16) and reduced()'s (32, 16)
HEAD_DIMS = (32, 64)
STATE_DIMS = (16, 128)
SMEM_LIMIT = 232_448  # bytes of shared memory one block may use on sm_90
# the launcher's own error codes (csrc/ssd_scan.cu)
_ERRORS = {
    -1: "no instance for this (hp, ds)",
    -2: "the CUDA driver has no cuTensorMapEncodeTiled",
    -3: "the CUDA driver refused a tensor map",
    -4: "a layout the bf16 route does not take",
}


@functools.cache
def _lib():
    lib = build.library("ssd_scan")
    p, i, q = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ssd_scan_launch.argtypes = [p] * 7 + [i] * 7 + [q] * 13 + [p]
    lib.ssd_scan_launch.restype = i
    lib.ssd_scan_smem_bytes.argtypes = [i, i, i]
    lib.ssd_scan_smem_bytes.restype = q
    lib.ssd_scan_tc_blocks_per_sm.argtypes = [i]
    lib.ssd_scan_tc_blocks_per_sm.restype = i
    return lib


def tc_blocks_per_sm(ds: int = 128) -> int:
    """Blocks of the bf16 route one SM of the current card holds at once
    (CUDA's occupancy calculator); the design sizes them for two."""
    n = _lib().ssd_scan_tc_blocks_per_sm(ds)
    if n < 0:
        raise RuntimeError(f"occupancy query failed: CUDA error {-n}")
    return n


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
    if x.dtype == torch.bfloat16:
        for name, t in (("x", x), ("Bm", Bm), ("Cm", Cm)):
            build.check_tma_layout(name, t)


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
    bf16 = x.dtype == torch.bfloat16
    lib = _lib()
    if not bf16:
        smem = lib.ssd_scan_smem_bytes(hp, ds, L)
        if smem > SMEM_LIMIT:
            raise ValueError(f"chunk {L} with hp={hp}, ds={ds} needs {smem} B of shared memory (> {SMEM_LIMIT})")
    y = torch.empty(b, s, nh, hp, dtype=torch.float32, device=dev)
    state = torch.empty(b, nh, hp, ds, dtype=torch.float32, device=dev)
    A = A.contiguous()
    with torch.cuda.device(dev):
        err = lib.ssd_scan_launch(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
            y.data_ptr(), state.data_ptr(), b, s, nh, hp, ds, L, int(bf16),
            *x.stride(), *dt.stride(), *Bm.stride(), *Cm.stride(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: {_ERRORS.get(err, f'CUDA error {err}')}")
    ssd_scan.launches += 1
    if bf16:
        ssd_scan.launches_tc += 1
    else:
        ssd_scan.launches_fma += 1
    return y, state


ssd_scan.launches = ssd_scan.launches_tc = ssd_scan.launches_fma = 0


def ssd_bf16_limit(
    x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
    y_ref: torch.Tensor, state_ref: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-element fp32 limits on |bf16 route - ssd_scan_ref| for bf16 inputs,
    as (limit on y, limit on the final state):

        y:     2**-7 * ȳ  +  1e-4 * max(1, max |y_ref|)
        state: 2**-8 * S̄  +  1e-4 * max(1, max |state_ref|)

    with ȳ, S̄ = ssd_scan_ref(|x|, dt, A, |Bm|, |Cm|): each output is a sum
    of terms C_i·B_j·decay·dt_j·x_j (decays and dt are positive), and ȳ, S̄
    are the sums of those terms' magnitudes.  The inputs are bf16 already,
    so products of them are exact in fp32; the route rounds three values to
    bf16, each by at most u/(1+u) of itself, u = 2**-8 the unit roundoff:

    - P = G ∘ exp(a_i − a_j) ∘ dt_j: a term from the output's own tile
      reaches y through P·X, rounded once;
    - X∘w, w_j = dt_j·exp(a_last − a_j): a term from an earlier tile goes
      into the fp32 state rounded once, and the state's bf16 copy in C·Sᵀ
      rounds the sum of such terms once more; (1 + u/(1+u))² − 1 ≤ 2u = 2**-7
      of the magnitude sum;
    - the final state holds the X∘w terms, rounded once: 2**-8 of S̄.

    The 1e-4 · max(1, max |ref|) covers fp32 summation order and the
    hardware exp, as SSD_RTOL does for the fp32 route."""
    y_abs, s_abs = ref.ssd_scan_ref(x.float().abs(), dt, A, Bm.float().abs(), Cm.float().abs())
    y_lim = 2.0**-7 * y_abs + 1e-4 * max(1.0, y_ref.abs().max().item())
    s_lim = 2.0**-8 * s_abs + 1e-4 * max(1.0, state_ref.abs().max().item())
    return y_lim, s_lim
