"""Decoder stack: the port of ``repro.models.decoder`` for SSM layers and
dense attention layers.

Params are a dict: ``embed``, ``final_norm``, ``lm_head`` (untied only) and
``layers``, a list with one dict per layer (``norm1`` and ``ssm`` or
``attn``; ``norm2`` and ``mlp`` when ``d_ff > 0``), looped in Python.  The
reference stacks layers in super-blocks of ``cfg.block_period``; only
``checkpoint/convert.py`` sees that grouping.  Parts the port does not have
yet (MoE, the SSM/attention interleave, learned positions, cross-attention,
the encoder, prefix embeddings) raise ``NotImplementedError`` naming their
ROADMAP item.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch.profiler import record_function

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn_lib
from repro_torch.models import ssd as ssd_lib
from repro_torch.models.common import Params, apply_mlp, apply_norm, embed_init, init_mlp, init_norm

Cache = List[Dict[str, torch.Tensor]]


def check_ported(cfg: ModelConfig) -> None:
    """Raise for any part of ``cfg`` the port has no code for."""
    if cfg.is_encoder_decoder:
        raise NotImplementedError(f"{cfg.name}: the encoder and cross-attention are not ported (ROADMAP queue 1 #11)")
    kinds = {cfg.layer_kind(i) for i in range(cfg.num_layers)}
    if kinds == {"attn", "ssm"}:
        raise NotImplementedError(
            f"{cfg.name}: the hybrid interleave of SSM and attention layers is not ported (jamba, ROADMAP queue 1 #11)"
        )
    if any(cfg.layer_moe(i) for i in range(cfg.num_layers)):
        raise NotImplementedError(f"{cfg.name}: MoE layers (routed-expert MLPs) are not ported (ROADMAP queue 1 #11)")
    if "attn" in kinds and not cfg.use_rope:
        raise NotImplementedError(
            f"{cfg.name}: learned positions (pos_embed) for attention layers are not ported (ROADMAP queue 1 #11)"
        )


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def _init_layer(g: torch.Generator, cfg: ModelConfig, i: int, dtype: torch.dtype) -> Params:
    p: Params = {"norm1": init_norm(cfg.norm, cfg.d_model, dtype, g.device)}
    if cfg.layer_kind(i) == "attn":
        p["attn"] = attn_lib.init_attn(g, cfg, dtype)
    else:
        p["ssm"] = ssd_lib.init_ssd(g, cfg, dtype)
    if cfg.d_ff > 0:
        p["norm2"] = init_norm(cfg.norm, cfg.d_model, dtype, g.device)
        p["mlp"] = init_mlp(g, cfg.d_model, cfg.d_ff, cfg.act, dtype)
    return p


def init_params(cfg: ModelConfig, seed: int = 0, device: str | torch.device | None = None) -> Params:
    """Random weights with the reference's distributions, drawn from a
    ``torch.Generator`` seeded with ``seed`` on ``device`` (the GPU unless
    the caller says otherwise)."""
    check_ported(cfg)
    device = resolve_device(device)
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    dtype = cfg.dtype
    p: Params = {
        "embed": embed_init(g, cfg.vocab_size, cfg.d_model, dtype),
        "final_norm": init_norm(cfg.norm, cfg.d_model, dtype, device),
        "layers": [_init_layer(g, cfg, i, dtype) for i in range(cfg.num_layers)],
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = embed_init(g, cfg.vocab_size, cfg.d_model, dtype)
    return p


def _check_inputs(prefix_embeddings, encoder_frames) -> None:
    if prefix_embeddings is not None:
        raise NotImplementedError("prefix embeddings (the VLM frontend) are not ported (ROADMAP queue 1 #11)")
    if encoder_frames is not None:
        raise NotImplementedError("encoder frames (the audio encoder) are not ported (ROADMAP queue 1 #11)")


def _logits(cfg: ModelConfig, params: Params, x: torch.Tensor) -> torch.Tensor:
    head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    return x @ head.T.to(cfg.dtype)


# ---------------------------------------------------------------------------
# Forward (prefill)
# ---------------------------------------------------------------------------


def _mlp_residual(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    if cfg.d_ff == 0:
        return x
    with record_function("lm.norm"):
        h = apply_norm(cfg.norm, p["norm2"], x, cfg.norm_eps)
    with record_function("lm.mlp"):
        return x + apply_mlp(p["mlp"], h, cfg.act)


def forward_logits(
    cfg: ModelConfig,
    params: Params,
    tokens: torch.Tensor,
    prefix_embeddings: Optional[torch.Tensor] = None,
    encoder_frames: Optional[torch.Tensor] = None,
    last_only: bool = False,
    use_kernel: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (logits (B, S, V), or (B, 1, V) with ``last_only``; MoE aux
    loss, zero here).  ``use_kernel`` is passed to every ``ssd_forward`` and
    ``attn_forward``: True sends the scan to ``kernels.ops.ssd_scan`` and the
    attention to ``kernels.ops.swa_attention``; False computes exactly the
    reference decoder's plain forms.  Attention is causal over
    ``positions = arange(S)``, within ``cfg.sliding_window`` when it is set."""
    check_ported(cfg)
    _check_inputs(prefix_embeddings, encoder_frames)
    with record_function("lm.embed"):
        x = params["embed"][tokens].to(cfg.dtype)
    positions = torch.arange(tokens.shape[1], device=x.device)
    for p in params["layers"]:
        with record_function("lm.norm"):
            h = apply_norm(cfg.norm, p["norm1"], x, cfg.norm_eps)
        if "attn" in p:
            a = attn_lib.attn_forward(
                cfg, p["attn"], h, positions, causal=True, window=cfg.sliding_window, use_kernel=use_kernel
            )
        else:
            a = ssd_lib.ssd_forward(cfg, p["ssm"], h, use_kernel=use_kernel)
        x = _mlp_residual(cfg, p, x + a)
    with record_function("lm.head"):
        x = apply_norm(cfg.norm, params["final_norm"], x, cfg.norm_eps)
        if last_only:
            x = x[:, -1:, :]
        logits = _logits(cfg, params, x)
    return logits, torch.zeros((), dtype=torch.float32, device=logits.device)


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


def init_cache(
    cfg: ModelConfig, batch: int, length: int, rolling: bool = False, device: str | torch.device | None = None
) -> Cache:
    """One cache per layer: K/V of width ``length`` for attention layers,
    or ``min(length, cfg.sliding_window)`` for a sliding-window model unless
    ``rolling`` (then ``length`` is the rolling window's width); for SSM
    layers the conv history in the model dtype and the state in fp32, which
    do not grow with ``length``."""
    check_ported(cfg)
    device = resolve_device(device)
    W = min(length, cfg.sliding_window) if (cfg.sliding_window and not rolling) else length
    return [
        attn_lib.init_kv_cache(cfg, batch, W, cfg.dtype, device)
        if cfg.layer_kind(i) == "attn"
        else ssd_lib.init_ssd_cache(cfg, batch, cfg.dtype, device)
        for i in range(cfg.num_layers)
    ]


def decode_step(
    cfg: ModelConfig,
    params: Params,
    cache: Cache,
    tokens: torch.Tensor,
    positions: torch.Tensor,
    rolling: bool = False,
) -> Tuple[torch.Tensor, Cache]:
    """One-token decode. tokens (B,1), positions (B,) -> (logits (B,1,V), cache).
    Attention caches roll (a circular buffer) when ``rolling`` or when the
    model has a sliding window; SSM layers do not read ``positions``."""
    check_ported(cfg)
    roll = rolling or cfg.sliding_window > 0
    x = params["embed"][tokens].to(cfg.dtype)
    new_cache = []
    for p, c in zip(params["layers"], cache):
        h = apply_norm(cfg.norm, p["norm1"], x, cfg.norm_eps)
        if "attn" in p:
            a, c = attn_lib.attn_decode(cfg, p["attn"], h, c, positions, rolling=roll)
        else:
            a, c = ssd_lib.ssd_decode(cfg, p["ssm"], h, c)
        x = _mlp_residual(cfg, p, x + a)
        new_cache.append(c)
    x = apply_norm(cfg.norm, params["final_norm"], x, cfg.norm_eps)
    return _logits(cfg, params, x), new_cache
