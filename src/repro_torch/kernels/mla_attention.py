"""Hopper kernel: the causal core of multi-head latent attention (DeepSeek-V2's
MLA), forward and backward, one fused launch a direction.

Replaces no TPU kernel: the JAX package has no MLA (the port wrote the
architecture, ``models/attention.py::mla_forward``).  It was added because
the plain core (``kernels.ref.mla_attention_ref``: bf16 scores over all S
keys, an fp32 copy, a mask, an fp32 softmax, a cast, a second product, in
query chunks of 512) moves about 2.1 GB a sequence and layer at S = 2048, and
its backward keeps the (S, S) probabilities of every chunk.  Source:
``csrc/mla_attention.cu``, CUDA C++ for sm_90a.  Bound: operations, S²/2 · H
· (192 + 128) · 2 a sequence forward (21.5 GFLOP at S 2048, H 16: 22 µs at
the bf16 peak), twice that backward (dV and dP over 128, dK and dQ over
192; the backward's recomputation of S is the design's, not counted); the
bytes of q, k, v and o are about 30 times fewer.

Design (the source's header has the rest): every product on ``wgmma``
(bf16 operands, fp32 accumulators), tiles by TMA through a ring in shared
memory, key tiles past the diagonal skipped, the scores and probabilities
kept in registers.  The forward writes o in (B, S, H, 128), the layout
``o @ wo`` reads, and each row's fp32 log-sum-exp; the backward recomputes P
from it, takes dQ in a second pass over query tiles (no atomics: runs repeat
bit for bit) and dK, dV over key tiles.  The kernel keeps the scores in fp32
where the plain path rounds them to bf16 first; P is rounded to bf16 before
P·V as the plain path rounds its probabilities.

:class:`MLAAttention` is the ``autograd.Function``: its ``vmap`` rule folds
the lanes of ``torch.func.vmap`` into the batch, so a vmapped client's
forward and backward are each one launch for all lanes.  :func:`forward` and
:func:`backward` only launch: they take bf16 tensors on the current CUDA
device in the instance's widths (q and k 192, v 128) and raise on anything
else, a refused launch included.  ``kernels.ops.mla_attention`` holds the
route: :func:`takes_kernel`'s inputs come here, the rest to the plain version.  ``mla_attention.launches`` counts every
launch call, ``launches_forward`` and ``launches_backward`` each
direction's (a backward call runs two kernels, dQ then dK and dV).
"""
from __future__ import annotations

import ctypes
import functools
import struct
from typing import Tuple

import torch

from repro_torch.kernels import build

# MlaArgs of csrc/mla_attention.cu: q, k, v, o, dO, lse, delta, dq, dk, dv,
# stream; (b, s, h) element strides of q, k, v, o, dO, dq, dk, dv; batch,
# seqlen, heads, s_pad, direction; scale
_ARGS = struct.Struct("11Q24q5if")
DIRECTIONS = ("forward", "backward")
DK, DV = 192, 128  # the instance's q/k and v head dims: DeepSeek-V2's nope 128 + rope 64, and v
TILE = 128  # the row tile: lse and the backward's D are (B, H, S rounded up to it)
_ERRORS = {
    -2: "the CUDA driver has no cuTensorMapEncodeTiled",
    -3: "the CUDA driver refused a tensor map",
    -4: "a grid too large",
    -5: "an unknown direction",
}


@functools.cache
def _launcher():
    fn = build.library("mla_attention").mla_attention_launch
    fn.argtypes = [ctypes.c_char_p]
    fn.restype = ctypes.c_int
    return fn


def _launch_words(out: torch.Tensor, words, scale: float) -> None:
    err = _launcher()(_ARGS.pack(*words, scale))
    if err != 0:
        why = _ERRORS.get(err, f"CUDA error {err}")
        raise RuntimeError(f"mla_attention {DIRECTIONS[words[-1]]} launch failed: {why}")


# Every launch runs inside this operator, so that a trace links the kernels
# to the operator and through it to the ranges open around the call
# (``lm.attn`` forward, ``ehfl.local_train.grad`` backward); a bare ctypes
# launch links to nothing.
_LIB = torch.library.Library("repro_torch", "FRAGMENT")
_LIB.define("mla_attention_launch(Tensor(a!) out, int[] words, float scale) -> ()")
_LIB.impl("mla_attention_launch", _launch_words, "CUDA")


def check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raise on what the kernel does not take (device aside)."""
    if q.dim() != 4 or q.shape[-1] != DK:
        raise ValueError(f"q must be (B, S, H, {DK}); got {tuple(q.shape)}")
    b, s, h, _ = q.shape
    if k.shape != q.shape or v.shape != (b, s, h, DV):
        raise ValueError(f"k must be {tuple(q.shape)} and v ({b}, {s}, {h}, {DV}); got {tuple(k.shape)} and "
                         f"{tuple(v.shape)}")
    if any(t.dtype != torch.bfloat16 for t in (q, k, v)):
        raise TypeError(f"the mla_attention kernel takes bf16; got {q.dtype}, {k.dtype}, {v.dtype}")
    if max(b, h) > 65_535 or s >= 2**31 - TILE:
        raise ValueError(f"need B, H <= 65535 and S < 2**31 - {TILE}; got {(b, s, h)}")


def _device(*tensors: torch.Tensor) -> int:
    index = tensors[0].get_device()
    return index if all(t.get_device() == index for t in tensors) else -2  # -2: launch_stream raises


def _tma_ready(t: torch.Tensor) -> torch.Tensor:
    """``t`` if TMA can read it through its strides (a contiguous last dim, a
    16-byte-aligned base, the other strides positive multiples of 16 bytes
    where their dim is stepped), else a contiguous copy."""
    steps = [st for st, n in zip(t.stride()[:-1], t.shape[:-1]) if n > 1]
    if t.stride(-1) == 1 and t.data_ptr() % 16 == 0 and all(st > 0 and st % 8 == 0 for st in steps):
        return t
    return t.contiguous()


def _strides(t: torch.Tensor | None) -> Tuple[int, int, int]:
    return (0, 0, 0) if t is None else (t.stride(0), t.stride(1), t.stride(2))


def _launch(direction: str, index: int, scale: float, q, k, v, o, dout=None, lse=None, delta=None, dq=None,
            dk=None, dv=None) -> None:
    stream = build.launch_stream("mla_attention", index)
    _launcher()  # builds the library at first use (raises without nvcc) before the operator is dispatched
    b, s, h, _ = q.shape
    words = (
        *(0 if t is None else t.data_ptr() for t in (q, k, v, o, dout, lse, delta, dq, dk, dv)), stream,
        *(st for t in (q, k, v, o, dout, dq, dk, dv) for st in _strides(t)),
        b, s, h, lse.stride(1), DIRECTIONS.index(direction),
    )
    torch.ops.repro_torch.mla_attention_launch(o if direction == "forward" else dq, list(words), float(scale))
    mla_attention.launches += 1
    setattr(mla_attention, f"launches_{direction}", getattr(mla_attention, f"launches_{direction}") + 1)


def forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """q, k (B, S, H, 192), v (B, S, H, 128), bf16 -> (o (B, S, H, 128) bf16,
    contiguous; lse (B, H, S) fp32, the natural log of each row's softmax
    sum, a view of a (B, H, S rounded up to 128) buffer)."""
    check_inputs(q, k, v)
    index = _device(q, k, v)
    q, k, v = _tma_ready(q), _tma_ready(k), _tma_ready(v)
    b, s, h, _ = q.shape
    s_pad = -(-s // TILE) * TILE
    o = torch.empty(b, s, h, DV, dtype=q.dtype, device=q.device)
    lse = torch.empty(b, h, s_pad, dtype=torch.float32, device=q.device)
    if o.numel():
        _launch("forward", index, scale, q, k, v, o, lse=lse)
    return o, lse[..., :s]


def _padded_lse(lse: torch.Tensor, s: int) -> torch.Tensor:
    """``lse`` (B, H, S) as the kernel reads it: rows S_pad apart, S_pad a
    multiple of 128, each row dense (what :func:`forward` returns); copied
    into such a buffer where it is not."""
    b, h = lse.shape[:2]
    sp = lse.stride(1)
    if lse.stride() == (h * sp, sp, 1) and sp % TILE == 0 and sp >= s and lse.data_ptr() % 16 == 0:
        return lse
    buf = torch.zeros(b, h, -(-s // TILE) * TILE, dtype=torch.float32, device=lse.device)
    buf[..., :s] = lse
    return buf[..., :s]


def backward(dout: torch.Tensor, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
             lse: torch.Tensor, scale: float) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """dL/do (B, S, H, 128) and what :func:`forward` took and gave -> (dq, dk,
    dv), bf16, contiguous, in q's, k's and v's shapes."""
    check_inputs(q, k, v)
    b, s, h, _ = q.shape
    if dout.shape != o.shape or o.shape != (b, s, h, DV) or lse.shape != (b, h, s):
        raise ValueError(f"dout and o must be ({b}, {s}, {h}, {DV}) and lse ({b}, {h}, {s}); got "
                         f"{tuple(dout.shape)}, {tuple(o.shape)}, {tuple(lse.shape)}")
    if dout.dtype != torch.bfloat16 or o.dtype != torch.bfloat16 or lse.dtype != torch.float32:
        raise TypeError(f"dout and o must be bf16 and lse fp32; got {dout.dtype}, {o.dtype}, {lse.dtype}")
    index = _device(q, k, v, o, dout, lse)
    q, k, v, o, dout = (_tma_ready(t) for t in (q, k, v, o, dout))
    lse = _padded_lse(lse, s)
    dq, dk, dv = (torch.empty(t.shape, dtype=t.dtype, device=t.device) for t in (q, k, v))
    delta = torch.empty(b, h, lse.stride(1), dtype=torch.float32, device=q.device)  # D = rowsum(dO * o)
    if dq.numel():
        _launch("backward", index, scale, q, k, v, o, dout=dout, lse=lse, delta=delta, dq=dq, dk=dk, dv=dv)
    return dq, dk, dv


def _fold(t: torch.Tensor, dim, n: int) -> torch.Tensor:
    """A vmapped input with its lanes folded into the batch: (n*B, ...)."""
    t = t.expand(n, *t.shape) if dim is None else t.movedim(dim, 0)
    return t.flatten(0, 1)


def _unfold(t: torch.Tensor, n: int) -> torch.Tensor:
    return t.unflatten(0, (n, -1))


class MLAAttention(torch.autograd.Function):
    """(o, lse) = the MLA core of q, k, v at ``scale``; the gradient of o
    through :func:`backward`.  Under ``torch.func.vmap`` each direction is
    one launch for all lanes."""

    @staticmethod
    def forward(q, k, v, scale):
        return forward(q, k, v, scale)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, scale = inputs
        o, lse = output
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale = scale
        ctx.mark_non_differentiable(lse)

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, o, lse = ctx.saved_tensors
        return (*_MLABackward.apply(do, q, k, v, o, lse, ctx.scale), None)

    @staticmethod
    def vmap(info, in_dims, q, k, v, scale):
        n = info.batch_size
        o, lse = forward(*(_fold(t, d, n) for t, d in zip((q, k, v), in_dims[:3])), scale)
        return (_unfold(o, n), _unfold(lse, n)), (0, 0)


class _MLABackward(torch.autograd.Function):
    """(dq, dk, dv) of :class:`MLAAttention` from (dO, q, k, v, o, lse, scale)."""

    @staticmethod
    def forward(do, q, k, v, o, lse, scale):
        return backward(do, q, k, v, o, lse, scale)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError("the mla_attention kernel has no second derivative")

    @staticmethod
    def vmap(info, in_dims, do, q, k, v, o, lse, scale):
        n = info.batch_size
        grads = backward(*(_fold(t, d, n) for t, d in zip((do, q, k, v, o, lse), in_dims[:6])), scale)
        return tuple(_unfold(g, n) for g in grads), (0, 0, 0)


def mla_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """The causal MLA core on the card: q, k (B, S, H, 192), v (B, S, H, 128),
    bf16 -> (B, S, H*128) bf16, differentiable, batched by ``vmap`` into one
    launch a direction.  The counters' home in ``kernels.ops.KERNELS``."""
    return MLAAttention.apply(q, k, v, scale)[0].flatten(2)


mla_attention.launches = 0
for _d in DIRECTIONS:
    setattr(mla_attention, f"launches_{_d}", 0)


def takes_kernel(q: torch.Tensor) -> bool:
    """Whether MLA's core runs on this kernel: CUDA bf16 inputs do; everything
    else (the CPU, fp32) runs the plain version."""
    return q.device.type == "cuda" and q.dtype == torch.bfloat16


def reference_and_limits(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, dout: torch.Tensor, scale: float):
    """The core's fp32 result ({"o", "dq", "dk", "dv"}) for bf16 inputs read
    as fp32, and a per-element limit on the kernel's distance to each, from
    the roundings the kernel adds (one bf16 rounding: a relative error of at
    most 2^-9, taken twice over for margin):

        o:  2^-8 P|v|    + 2^-7 |o|    P rounded before P V; o rounded
        dv: 2^-8 P^T|dO| + 2^-7 |dv|   P rounded before P^T dO; dv rounded
        dq: 2^-8 |dS||k| + 2^-7 |dq| + scale e (P|k|)
        dk: 2^-8 |dS|^T|q| + 2^-7 |dk| + scale P^T(e |q|)

    dS = P (dP - D) scale is rounded before dS K and dS^T Q, and D =
    rowsum(dO o) is taken from the kernel's bf16 o, so it is off by at most
    e_i = sum_c |dO_ic| lim_o_ic, which moves dS_ij by P_ij e_i scale.  Each
    limit adds 1e-6 for fp32 sums in another order near 0.  Computed one
    batch row at a time: (H, S, S) fp32 intermediates."""
    want = {n: [] for n in ("o", "dq", "dk", "dv")}
    lim = {n: [] for n in want}
    s_len = q.shape[1]
    causal = torch.ones(s_len, s_len, dtype=torch.bool, device=q.device).tril()
    for b in range(q.shape[0]):
        qf, kf, vf, gf = (t[b].float().transpose(0, 1) for t in (q, k, v, dout))  # (H, S, D)
        p = torch.softmax((qf @ kf.transpose(1, 2) * scale).masked_fill(~causal, float("-inf")), dim=-1)
        o = p @ vf
        lim_o = 2.0**-8 * (p @ vf.abs()) + 2.0**-7 * o.abs() + 1e-6
        ds = p * (gf @ vf.transpose(1, 2) - (gf * o).sum(-1, keepdim=True)) * scale
        e = (gf.abs() * lim_o).sum(-1, keepdim=True)
        dq, dk, dv = ds @ kf, ds.transpose(1, 2) @ qf, p.transpose(1, 2) @ gf
        for name, val, bound in (
            ("o", o, lim_o),
            ("dq", dq, 2.0**-8 * (ds.abs() @ kf.abs()) + 2.0**-7 * dq.abs() + scale * e * (p @ kf.abs()) + 1e-6),
            ("dk", dk, 2.0**-8 * (ds.abs().transpose(1, 2) @ qf.abs()) + 2.0**-7 * dk.abs()
             + scale * (p.transpose(1, 2) @ (e * qf.abs())) + 1e-6),
            ("dv", dv, 2.0**-8 * (p.transpose(1, 2) @ gf.abs()) + 2.0**-7 * dv.abs() + 1e-6),
        ):
            want[name].append(val.transpose(0, 1))
            lim[name].append(bound.transpose(0, 1))
        del p, ds
    return {n: torch.stack(x) for n, x in want.items()}, {n: torch.stack(x) for n, x in lim.items()}
