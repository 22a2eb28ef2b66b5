"""Hopper kernel: causal / sliding-window attention forward (flash attention).

Replaces ``src/repro/kernels/swa_attention.py::swa_attention`` (Pallas, body
``_make_kernel``).  Source: ``csrc/swa_attention.cu``, CUDA C++ for sm_90a.
Bound: operations.  At StarCoder2-3B's prefill (1, 24, 16384, 128) with 2 KV
heads and window 4096 the live (q, k) pairs need 721.6 GFLOP against 0.22 GB
of traffic: 0.73 ms on the bf16 tensor cores.  One thread block per (batch,
head, query tile) loops over the live key tiles only, in place of the TPU's
sequential KV grid axis with its whole-block skip, keeping the online
softmax's m, l and the accumulator in registers.

Two routes, chosen by dtype, neither a fallback for the other (a route that
fails to launch raises):

- bf16, the model's route: ``wgmma`` on the tensor cores for Q K^T and P V
  (fp32 accumulators; P rounded to bf16 before P V), K/V tiles loaded by TMA
  into a two-stage ring.  TMA needs the last dim contiguous, a 16-byte-aligned
  base and 16-byte-multiple strides: :func:`check_inputs` refuses the rest.
  Counted in ``swa_attention.launches_tc``.
- fp32, the correctness route: fp32 FMA tiles from shared memory, any strides.
  Counted in ``swa_attention.launches_fma``.

``swa_attention.launches`` counts both.  The bf16 route's one extra rounding
bounds its distance to the plain version element by element:
:func:`bf16_limit`.

It computes what ``kernels.ref.swa_attention_ref`` computes, the oracle of
the Pallas kernel: keys at or past S are masked (the Pallas kernel pads them
with zeros and masks them only when causal).  Query head h reads KV head
h // (H / Hkv), so K/V go in with their own Hkv heads, unrepeated.  q, k and
v are read through their strides, and the output is a (B, H, S, D) view of a
(B, S, H, D) buffer, the layout the model's output projection reads: the
model passes views in and takes a view out, and nothing is copied.  There is
no backward kernel, so inputs that require grad are refused.

:func:`swa_attention` only launches the kernel: it takes CUDA tensors and
raises on anything else.  ``kernels.ops`` routes CPU tensors to the plain
version in ``kernels.ref``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, ref

_DTYPES = (torch.float32, torch.bfloat16)
# the kernel's instances: the reference configs' head dims and
# tests/test_kernels.py's sweep
HEAD_DIMS = (32, 64, 128)
# the launcher's own error codes (csrc/swa_attention.cu)
_ERRORS = {
    -1: "no instance for this head dim",
    -2: "the CUDA driver has no cuTensorMapEncodeTiled",
    -3: "the CUDA driver refused a tensor map",
    -4: "a layout the bf16 route does not take",
}


@functools.cache
def _lib():
    lib = build.library("swa_attention")
    p, i, q = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.swa_attention_launch.argtypes = [p] * 4 + [i] * 8 + [q] * 16 + [p]
    lib.swa_attention_launch.restype = i
    return lib


def check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window: int) -> None:
    """Raise on what the kernel does not take (device aside)."""
    if q.dim() != 4:
        raise ValueError(f"q must be (B, H, S, D); got {tuple(q.shape)}")
    b, h, s, d = q.shape
    if k.dim() != 4 or k.shape != v.shape or (k.shape[0], k.shape[2], k.shape[3]) != (b, s, d):
        raise ValueError(f"k and v must both be ({b}, Hkv, {s}, {d}); got {tuple(k.shape)} and {tuple(v.shape)}")
    hkv = k.shape[1]
    if hkv < 1 or h % hkv:
        raise ValueError(f"the KV heads ({hkv}) must divide the query heads ({h})")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k and v must share one dtype of {_DTYPES}; got {q.dtype}, {k.dtype}, {v.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"the kernel takes head dims {HEAD_DIMS}; got {d}")
    if not 0 <= window < 2**31:
        raise ValueError(f"window must be in [0, 2**31) (0 = full attention); got {window}")
    if min(b, h, s) < 1 or max(b, h) > 65_535 or s >= 2**31:
        raise ValueError(f"need 1 <= B, H <= 65535 and 1 <= S < 2**31; got {(b, h, s)}")
    if any(t.requires_grad for t in (q, k, v)):
        raise ValueError("swa_attention has no backward kernel: call it on inputs that do not require grad")
    if q.dtype == torch.bfloat16:
        for name, t in (("q", q), ("k", k), ("v", v)):
            build.check_tma_layout(name, t)


def swa_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window: int = 0, causal: bool = True
) -> torch.Tensor:
    """q (B, H, S, D); k, v (B, Hkv, S, D); fp32 or bf16, one dtype.
    window=0 => full (causal) attention.  Returns (B, H, S, D) in q's dtype,
    as a view of a (B, S, H, D) buffer."""
    check_inputs(q, k, v, window)
    dev = q.device
    if dev.type != "cuda" or k.device != dev or v.device != dev:
        raise ValueError(
            "the swa_attention kernel needs all inputs on one CUDA device; "
            "kernels.ops.swa_attention takes CPU tensors"
        )
    b, h, s, d = q.shape
    o = torch.empty(b, s, h, d, dtype=q.dtype, device=dev).transpose(1, 2)
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.swa_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            b, h, k.shape[1], s, d, window, int(bool(causal)), int(q.dtype == torch.bfloat16),
            *q.stride(), *k.stride(), *v.stride(), *o.stride(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"swa_attention kernel launch failed: {_ERRORS.get(err, f'CUDA error {err}')}")
    swa_attention.launches += 1
    if q.dtype == torch.bfloat16:
        swa_attention.launches_tc += 1
    else:
        swa_attention.launches_fma += 1
    return o


swa_attention.launches = swa_attention.launches_tc = swa_attention.launches_fma = 0


def bf16_limit(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window: int = 0, causal: bool = True, want=None
) -> torch.Tensor:
    """Per-element fp32 limit on |bf16 route - swa_attention_ref| for bf16 inputs:

        2**-8 * sum_j p_ij |v_j|  +  2**-7 * |ref|  +  1e-6

    The route rounds each probability p_ij to bf16 (relative error at most
    2**-8) before P V, so the sum moves by at most 2**-8 sum_j p_ij |v_j|,
    which is the plain version run on |v| in fp32.  Both outputs then round
    to bf16 (the 2**-7 |ref|: a step either way); the 1e-6 covers fp32
    summation order near 0.  ``want`` is the plain version's output where
    the caller has it already."""
    if want is None:
        want = ref.swa_attention_ref(q, k, v, window=window, causal=causal)
    spread = ref.swa_attention_ref(q.float(), k.float(), v.float().abs(), window=window, causal=causal)
    return 2.0**-8 * spread + 2.0**-7 * want.float().abs() + 1e-6
