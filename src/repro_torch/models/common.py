"""Shared model building blocks: initialisers, norms, RoPE, the MLP and the
cross-entropy losses (the port of ``repro.models.common``)."""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.models import spmd

Params = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# Initializers: the reference's distributions, drawn from ``generator`` in
# fp32 on the generator's device, then cast.
# ---------------------------------------------------------------------------


def dense_init(generator: torch.Generator, d_in: int, d_out: int, dtype=torch.float32) -> torch.Tensor:
    w = torch.randn(d_in, d_out, generator=generator, device=generator.device, dtype=torch.float32)
    return (w * (1.0 / math.sqrt(d_in))).to(dtype)


def embed_init(generator: torch.Generator, vocab: int, d: int, dtype=torch.float32) -> torch.Tensor:
    w = torch.randn(vocab, d, generator=generator, device=generator.device, dtype=torch.float32)
    return (w * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# Norms (computed in fp32, cast back to the input's dtype)
# ---------------------------------------------------------------------------


def init_norm(kind: str, d: int, dtype=torch.float32, device=None) -> Params:
    p = {"scale": torch.ones(d, dtype=dtype, device=device)}
    if kind == "layernorm":
        p["bias"] = torch.zeros(d, dtype=dtype, device=device)
    return p


def apply_norm(kind: str, p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    if kind == "rmsnorm":
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
        y = xf * torch.rsqrt(var + eps) * p["scale"].float()
    elif kind == "layernorm":
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
        y = (xf - mu) * torch.rsqrt(var + eps)
        y = y * p["scale"].float() + p["bias"].float()
    else:
        raise ValueError(kind)
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings: the two halves of the head dimension rotate
# together (not interleaved pairs), in fp32, then cast back.
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)  # (hd/2,)
    angles = positions[..., None].float() * freqs  # (..., S, hd/2)
    cos = torch.cos(angles)[..., None, :]  # (..., S, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def yarn_mscale(scale: float, mscale: float) -> float:
    """YaRN's attention temperature: 0.1 * mscale * ln(scale) + 1 above scale 1."""
    return 0.1 * mscale * math.log(scale) + 1.0 if scale > 1 else 1.0


def yarn_inv_freq(dim: int, theta: float, yarn, device=None) -> torch.Tensor:
    """(dim/2,) inverse frequencies of a YaRN-scaled rope (``configs.base.YaRN``),
    as DeepSeek-V2's ``DeepseekV2YarnRotaryEmbedding`` makes them: the
    original frequencies where a dim turns more than ``beta_fast`` times
    over ``original_max_position``, those divided by ``factor`` where it
    turns fewer than ``beta_slow`` times, a linear ramp between."""
    base = rope_freqs(dim, theta, device)

    def correction_dim(rotations: float) -> float:
        return dim * math.log(yarn.original_max_position / (rotations * 2 * math.pi)) / (2 * math.log(theta))

    low = max(math.floor(correction_dim(yarn.beta_fast)), 0)
    high = min(math.ceil(correction_dim(yarn.beta_slow)), dim - 1)
    if low == high:
        high += 0.001
    ramp = torch.clamp((torch.arange(dim // 2, dtype=torch.float32, device=device) - low) / (high - low), 0, 1)
    extrapolate = 1.0 - ramp
    return base / yarn.factor * (1 - extrapolate) + base * extrapolate


def apply_rope_pairs(x: torch.Tensor, positions: torch.Tensor, inv_freq: torch.Tensor,
                     scale: float = 1.0) -> torch.Tensor:
    """Rope over interleaved pairs, in ``modeling_deepseek.py``'s layout:
    x (..., S, H, d) is read as pairs (x[2i], x[2i+1]), each rotated by
    positions * inv_freq[i], and written out as [first of each pair,
    second of each pair] (the released code's view-transpose before
    ``rotate_half``), in fp32, times ``scale``, cast back."""
    angles = positions[..., None].float() * inv_freq  # (..., S, d/2)
    cos = (torch.cos(angles) * scale)[..., None, :]
    sin = (torch.sin(angles) * scale)[..., None, :]
    pairs = x.float().unflatten(-1, (-1, 2))
    x1, x2 = pairs[..., 0], pairs[..., 1]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# MLP (gated silu / plain gelu).  ``jax.nn.gelu`` defaults to the tanh
# approximation, so this one does too (PyTorch's default is erf).
# ---------------------------------------------------------------------------


def init_mlp(generator: torch.Generator, d: int, ff: int, act: str, dtype=torch.float32) -> Params:
    p = {"w_up": dense_init(generator, d, ff, dtype), "w_down": dense_init(generator, ff, d, dtype)}
    if act == "silu":  # gated
        p["w_gate"] = dense_init(generator, d, ff, dtype)
    return p


def apply_mlp(p: Params, x: torch.Tensor, act: str) -> torch.Tensor:
    up = x @ p["w_up"]
    if act == "silu":
        h = F.silu(x @ p["w_gate"]) * up
    elif act == "gelu":
        h = F.gelu(up, approximate="tanh")
    else:
        raise ValueError(act)
    return h @ p["w_down"]


def softmax_cross_entropy_per_token(
    logits: torch.Tensor, labels: torch.Tensor, impl: str = "gather"
) -> torch.Tensor:
    """Per-token CE (...,), no mean: logsumexp of the fp32 logits less the
    gold logit.  ``impl="gather"`` reads the gold logit with ``gather``;
    ``impl="onehot"`` sums the logits under a mask of the label's column
    (the reference's form for vocab-sharded logits).  The two are the same
    function: the mask's sum has one nonzero term.

    On a DTensor whose vocab dim may be sharded, neither ``logsumexp`` nor
    ``gather`` keeps the shards (the one gathers the whole logits, the
    other cannot index them), so both impls take the vocab-parallel form:
    the max, the sum of exponentials and the masked gold logit are reduced
    over the shards as partial results, B·S numbers each."""
    if spmd.is_dtensor(logits):
        return _vocab_parallel_ce(logits.float(), labels)
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    if impl == "onehot":
        cols = torch.arange(logits.shape[-1], device=logits.device)
        gold = torch.where(labels.unsqueeze(-1) == cols, logits, 0.0).sum(dim=-1)
    elif impl == "gather":
        gold = torch.gather(logits, -1, labels.long().unsqueeze(-1)).squeeze(-1)
    else:
        raise ValueError(f"impl must be 'gather' or 'onehot'; got {impl!r}")
    return logz - gold


def _vocab_parallel_ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    m = logits.detach().amax(dim=-1, keepdim=True)
    m = spmd.to_batch_layout(m)
    logz = torch.log(spmd.to_batch_layout(torch.exp(logits - m).sum(dim=-1))) + m.squeeze(-1)
    onehot = (labels.unsqueeze(-1) == spmd.arange_like_last(logits)).to(logits.dtype)
    gold = spmd.to_batch_layout((logits * onehot).sum(dim=-1))
    # the (B, S) gradient comes back in the batch layout, so its broadcast
    # over the vocab stays on each rank's columns
    return spmd.tp_input(logz - gold)


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor, impl: str = "gather") -> torch.Tensor:
    """Mean token-level CE. logits (..., V) float; labels (...,) int."""
    return softmax_cross_entropy_per_token(logits, labels, impl).mean()
