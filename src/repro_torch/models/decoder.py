"""Decoder stack: the port of ``repro.models.decoder`` for SSM layers.

Params are a dict: ``embed``, ``final_norm``, ``lm_head`` (untied only) and
``layers``, a list with one dict per layer (``norm1``, ``ssm``), looped in
Python.  The reference stacks layers in super-blocks of
``cfg.block_period``; only ``checkpoint/convert.py`` sees that grouping.
Layer kinds the port does not have yet (attention, MLP, MoE, cross-attention,
encoder, prefix embeddings, learned positions) raise ``NotImplementedError``
naming their ROADMAP item.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch.profiler import record_function

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import ssd as ssd_lib
from repro_torch.models.common import Params, apply_norm, embed_init, init_norm

Cache = List[Dict[str, torch.Tensor]]


def check_ported(cfg: ModelConfig) -> None:
    """Raise for any part of ``cfg`` the port has no code for."""
    if cfg.is_encoder_decoder:
        raise NotImplementedError(f"{cfg.name}: the encoder and cross-attention are not ported (ROADMAP queue 1 #11)")
    for i in range(cfg.num_layers):
        if cfg.layer_kind(i) == "attn":
            raise NotImplementedError(
                f"{cfg.name}: attention layers are not ported (ROADMAP queue 1 #10, with swa_attention)"
            )
        if cfg.layer_moe(i):
            raise NotImplementedError(f"{cfg.name}: MoE layers are not ported (ROADMAP queue 1 #11)")
    if cfg.d_ff > 0:
        raise NotImplementedError(f"{cfg.name}: MLP layers are not ported (ROADMAP queue 1 #10)")


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


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
        "layers": [
            {"norm1": init_norm(cfg.norm, cfg.d_model, dtype, device), "ssm": ssd_lib.init_ssd(g, cfg, dtype)}
            for _ in range(cfg.num_layers)
        ],
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
    loss, zero here).  ``use_kernel`` is passed to every ``ssd_forward``:
    True sends the scan to ``kernels.ops.ssd_scan``; False computes exactly
    the reference decoder's plain chunked form."""
    check_ported(cfg)
    _check_inputs(prefix_embeddings, encoder_frames)
    with record_function("lm.embed"):
        x = params["embed"][tokens].to(cfg.dtype)
    for p in params["layers"]:
        with record_function("lm.norm"):
            h = apply_norm(cfg.norm, p["norm1"], x, cfg.norm_eps)
        x = x + ssd_lib.ssd_forward(cfg, p["ssm"], h, use_kernel=use_kernel)
    with record_function("lm.head"):
        x = apply_norm(cfg.norm, params["final_norm"], x, cfg.norm_eps)
        if last_only:
            x = x[:, -1:, :]
        logits = _logits(cfg, params, x)
    return logits, torch.zeros((), dtype=torch.float32, device=logits.device)


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, length: int, device: str | torch.device | None = None) -> Cache:
    """One SSM cache per layer (conv history in the model dtype, state in
    fp32).  ``length`` is the KV capacity attention layers would take; SSM
    caches do not grow with it."""
    check_ported(cfg)
    device = resolve_device(device)
    return [ssd_lib.init_ssd_cache(cfg, batch, cfg.dtype, device) for _ in range(cfg.num_layers)]


def decode_step(
    cfg: ModelConfig, params: Params, cache: Cache, tokens: torch.Tensor, positions: torch.Tensor
) -> Tuple[torch.Tensor, Cache]:
    """One-token decode. tokens (B,1), positions (B,) -> (logits (B,1,V), cache).
    ``positions`` would feed learned positions and attention; SSM layers do
    not read it."""
    check_ported(cfg)
    x = params["embed"][tokens].to(cfg.dtype)
    new_cache = []
    for p, c in zip(params["layers"], cache):
        h = apply_norm(cfg.norm, p["norm1"], x, cfg.norm_eps)
        a, c = ssd_lib.ssd_decode(cfg, p["ssm"], h, c)
        x = x + a
        new_cache.append(c)
    x = apply_norm(cfg.norm, params["final_norm"], x, cfg.norm_eps)
    return _logits(cfg, params, x), new_cache
