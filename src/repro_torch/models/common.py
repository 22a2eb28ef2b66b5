"""Shared model building blocks: initialisers, norms and the loss (the part
of ``repro.models.common`` that the CNN client and the Mamba2 stack need)."""
from __future__ import annotations

import math
from typing import Dict

import torch

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


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean token-level CE. logits (..., V) float; labels (...,) int."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long().unsqueeze(-1)).squeeze(-1)
    return (logz - gold).mean()
