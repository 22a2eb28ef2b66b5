"""Decoder stack: the port of ``repro.models.decoder`` for every arch the
reference registers: SSM, dense attention, MoE, the SSM/attention hybrid,
a VLM backbone with prefix embeddings, and an encoder-decoder.

Params are a dict: ``embed``, ``final_norm``, ``lm_head`` (untied only),
``pos_embed`` (learned positions, where the reference has them) and
``layers``, a list with one dict per layer (``norm1`` and ``ssm`` or
``attn``; ``norm_cross`` and ``cross`` in an encoder-decoder's decoder;
``norm2`` and ``mlp`` or ``moe`` when ``d_ff > 0``), looped in Python.  An
encoder-decoder adds ``enc_layers``, ``enc_pos_embed`` and
``enc_final_norm``.  The reference stacks layers in super-blocks of
``cfg.block_period``; only ``checkpoint/convert.py`` sees that grouping.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch
from torch.profiler import record_function

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssd as ssd_lib
from repro_torch.models.common import Params, apply_mlp, apply_norm, embed_init, init_mlp, init_norm

Cache = List[Dict[str, torch.Tensor]]


def has_pos_embed(cfg: ModelConfig) -> bool:
    """The reference's rule: learned positions for an encoder-decoder, and
    for a stack whose layer 0 is attention, that has no RoPE and is not the
    hybrid family (jamba has no positions at all)."""
    needs_pos = (
        not cfg.use_rope
        and cfg.layer_kind(0) != "ssm"
        and any(cfg.layer_kind(i) == "attn" for i in range(cfg.num_layers))
    )
    return cfg.is_encoder_decoder or (needs_pos and cfg.family != "hybrid")


def encoder_config(cfg: ModelConfig) -> ModelConfig:
    """The encoder stack's config: the encoder's depth, no experts."""
    return dataclasses.replace(cfg, num_layers=cfg.num_encoder_layers, num_experts=0)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def _init_layer(g: torch.Generator, cfg: ModelConfig, i: int, dtype: torch.dtype, cross: bool = False) -> Params:
    p: Params = {"norm1": init_norm(cfg.norm, cfg.d_model, dtype, g.device)}
    if cfg.layer_kind(i) == "attn":
        p["attn"] = attn_lib.init_attn(g, cfg, dtype)
    else:
        p["ssm"] = ssd_lib.init_ssd(g, cfg, dtype)
    if cross:
        p["norm_cross"] = init_norm(cfg.norm, cfg.d_model, dtype, g.device)
        p["cross"] = attn_lib.init_attn(g, cfg, dtype)
    if cfg.d_ff > 0:
        p["norm2"] = init_norm(cfg.norm, cfg.d_model, dtype, g.device)
        if cfg.layer_moe(i):
            p["moe"] = moe_lib.init_moe(g, cfg, dtype)
        else:
            p["mlp"] = init_mlp(g, cfg.d_model, cfg.d_ff, cfg.act, dtype)
    return p


def init_params(
    cfg: ModelConfig, seed: int = 0, device: str | torch.device | None = None, max_seq: int = 4096
) -> Params:
    """Random weights with the reference's distributions, drawn from a
    ``torch.Generator`` seeded with ``seed`` on ``device`` (the GPU unless
    the caller says otherwise).  ``max_seq`` rows of learned positions."""
    device = resolve_device(device)
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    dtype = cfg.dtype
    cross = cfg.is_encoder_decoder
    p: Params = {
        "embed": embed_init(g, cfg.vocab_size, cfg.d_model, dtype),
        "final_norm": init_norm(cfg.norm, cfg.d_model, dtype, device),
        "layers": [_init_layer(g, cfg, i, dtype, cross) for i in range(cfg.num_layers)],
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = embed_init(g, cfg.vocab_size, cfg.d_model, dtype)
    if has_pos_embed(cfg):
        p["pos_embed"] = embed_init(g, max_seq, cfg.d_model, dtype)
    if cross:
        enc = encoder_config(cfg)
        p["enc_layers"] = [_init_layer(g, enc, i, dtype) for i in range(enc.num_layers)]
        p["enc_pos_embed"] = embed_init(g, cfg.encoder_seq, cfg.d_model, dtype)
        p["enc_final_norm"] = init_norm(cfg.norm, cfg.d_model, dtype, device)
    return p


def _logits(cfg: ModelConfig, params: Params, x: torch.Tensor) -> torch.Tensor:
    head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    return x @ head.T.to(cfg.dtype)


# ---------------------------------------------------------------------------
# Forward (prefill)
# ---------------------------------------------------------------------------


def _ffn_residual(cfg: ModelConfig, p: Params, x: torch.Tensor) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """x + the layer's MLP or MoE of norm2(x), and the MoE's aux loss (None
    for an MLP layer)."""
    if cfg.d_ff == 0:
        return x, None
    with record_function("lm.norm"):
        h = apply_norm(cfg.norm, p["norm2"], x, cfg.norm_eps)
    if "moe" in p:
        with record_function("lm.moe"):
            f, aux = moe_lib.apply_moe(cfg, p["moe"], h)
            return x + f, aux
    with record_function("lm.mlp"):
        return x + apply_mlp(p["mlp"], h, cfg.act), None


def _cross_residual(cfg: ModelConfig, p: Params, x: torch.Tensor, attend) -> torch.Tensor:
    """x + cross-attention of norm_cross(x), ``attend(p["cross"], h)``."""
    with record_function("lm.norm"):
        h = apply_norm(cfg.norm, p["norm_cross"], x, cfg.norm_eps)
    with record_function("lm.cross"):
        return x + attend(p["cross"], h)


def _run_stack(
    cfg: ModelConfig,
    layers: List[Params],
    x: torch.Tensor,
    positions: torch.Tensor,
    window: int,
    causal: bool,
    encoder_out: Optional[torch.Tensor],
    use_kernel: bool,
) -> Tuple[torch.Tensor, torch.Tensor]:
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for p in layers:
        with record_function("lm.norm"):
            h = apply_norm(cfg.norm, p["norm1"], x, cfg.norm_eps)
        if "attn" in p:
            a = attn_lib.attn_forward(cfg, p["attn"], h, positions, causal=causal, window=window, use_kernel=use_kernel)
        else:
            a = ssd_lib.ssd_forward(cfg, p["ssm"], h, use_kernel=use_kernel)
        x = x + a
        if encoder_out is not None and "cross" in p:
            x = _cross_residual(
                cfg, p, x, lambda pc, hc: attn_lib.attn_forward(cfg, pc, hc, positions, encoder_out=encoder_out)
            )
        x, layer_aux = _ffn_residual(cfg, p, x)
        if layer_aux is not None:
            aux = aux + layer_aux
    return x, aux


def encode(cfg: ModelConfig, params: Params, frames: torch.Tensor, use_kernel: bool = False) -> torch.Tensor:
    """The encoder over (stubbed frontend) frames (B, S_enc, d): learned
    positions, a non-causal stack (its self-attention through the
    ``swa_attention`` kernel with ``causal=False`` when ``use_kernel``),
    then ``enc_final_norm``."""
    S = frames.shape[1]
    with record_function("lm.embed"):
        x = frames + params["enc_pos_embed"][None, :S, :]
    positions = torch.arange(S, device=x.device)
    x, _ = _run_stack(cfg, params["enc_layers"], x, positions, 0, False, None, use_kernel)
    with record_function("lm.norm"):
        return apply_norm(cfg.norm, params["enc_final_norm"], x, cfg.norm_eps)


def forward_logits(
    cfg: ModelConfig,
    params: Params,
    tokens: torch.Tensor,
    prefix_embeddings: Optional[torch.Tensor] = None,
    encoder_frames: Optional[torch.Tensor] = None,
    last_only: bool = False,
    use_kernel: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (logits over the token positions (B, S, V), or (B, 1, V) with
    ``last_only``; the MoE aux loss summed over layers, fp32).
    ``prefix_embeddings`` (B, P, d) go before the tokens (positions and RoPE
    run over S + P) and are stripped before the head.  An encoder-decoder
    needs ``encoder_frames``.  ``use_kernel`` is passed to every
    ``ssd_forward`` and ``attn_forward``: True sends the scan to
    ``kernels.ops.ssd_scan`` and self-attention to
    ``kernels.ops.swa_attention``; False computes exactly the reference
    decoder's plain forms.  Decoder attention is causal, within
    ``cfg.sliding_window`` when it is set."""
    if cfg.is_encoder_decoder and encoder_frames is None:
        raise ValueError(f"{cfg.name} is an encoder-decoder: pass encoder_frames")
    S = tokens.shape[1]
    with record_function("lm.embed"):
        x = params["embed"][tokens].to(cfg.dtype)
        P = 0
        if prefix_embeddings is not None:
            P = prefix_embeddings.shape[1]
            x = torch.cat([prefix_embeddings.to(cfg.dtype), x], dim=1)
        if "pos_embed" in params:
            x = x + params["pos_embed"][None, : S + P, :].to(cfg.dtype)
    positions = torch.arange(S + P, device=x.device)
    encoder_out = encode(cfg, params, encoder_frames, use_kernel) if cfg.is_encoder_decoder else None
    x, aux = _run_stack(cfg, params["layers"], x, positions, cfg.sliding_window, True, encoder_out, use_kernel)
    with record_function("lm.head"):
        x = apply_norm(cfg.norm, params["final_norm"], x, cfg.norm_eps)
        x = x[:, P:, :]
        if last_only:
            x = x[:, -1:, :]
        logits = _logits(cfg, params, x)
    return logits, aux


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


def init_cache(
    cfg: ModelConfig,
    batch: int,
    length: int,
    rolling: bool = False,
    device: str | torch.device | None = None,
    cross_cache: bool = False,
) -> Cache:
    """One cache per layer: K/V of width ``length`` for attention layers,
    or ``min(length, cfg.sliding_window)`` for a sliding-window model unless
    ``rolling`` (then ``length`` is the rolling window's width); for SSM
    layers the conv history in the model dtype and the state in fp32, which
    do not grow with ``length``.  ``cross_cache`` (an encoder-decoder) adds
    zero ``ck``/``cv`` planes (B, encoder_seq, Hkv, hd) to every layer, for
    :func:`prefill_cross_cache` to fill."""
    device = resolve_device(device)
    W = min(length, cfg.sliding_window) if (cfg.sliding_window and not rolling) else length
    caches = []
    for i in range(cfg.num_layers):
        if cfg.layer_kind(i) == "attn":
            c = attn_lib.init_kv_cache(cfg, batch, W, cfg.dtype, device)
        else:
            c = ssd_lib.init_ssd_cache(cfg, batch, cfg.dtype, device)
        if cfg.is_encoder_decoder and cross_cache:
            plane = (batch, cfg.encoder_seq, cfg.num_kv_heads, cfg.head_dim)
            c["ck"] = torch.zeros(plane, dtype=cfg.dtype, device=device)
            c["cv"] = torch.zeros(plane, dtype=cfg.dtype, device=device)
        caches.append(c)
    return caches


def prefill_cross_cache(cfg: ModelConfig, params: Params, cache: Cache, encoder_out: torch.Tensor) -> Cache:
    """A new cache with each layer's cross-attention K/V planes filled from
    the encoder output (once per request, before decoding)."""
    if not cfg.is_encoder_decoder:
        raise ValueError(f"{cfg.name} has no cross-attention")
    new = []
    for p, c in zip(params["layers"], cache):
        ck, cv = attn_lib.cross_kv(cfg, p["cross"], encoder_out)
        new.append({**c, "ck": ck, "cv": cv})
    return new


def decode_step(
    cfg: ModelConfig,
    params: Params,
    cache: Cache,
    tokens: torch.Tensor,
    positions: torch.Tensor,
    rolling: bool = False,
    encoder_out: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Cache]:
    """One-token decode. tokens (B,1), positions (B,) -> (logits (B,1,V), cache).
    Attention caches roll (a circular buffer) when ``rolling`` or when the
    model has a sliding window; SSM layers do not read ``positions``.  An
    encoder-decoder's cross-attention reads the cache's ``ck``/``cv`` planes
    where it has them, else projects ``encoder_out``; with neither it is
    skipped, as in the reference.  MoE layers route each token alone (one
    group of one token: nothing is dropped)."""
    roll = rolling or cfg.sliding_window > 0
    x = params["embed"][tokens].to(cfg.dtype)
    if "pos_embed" in params:
        x = x + params["pos_embed"][positions][:, None, :].to(cfg.dtype)
    new_cache = []
    for p, c in zip(params["layers"], cache):
        h = apply_norm(cfg.norm, p["norm1"], x, cfg.norm_eps)
        planes = {k: c[k] for k in ("ck", "cv") if k in c}
        if "attn" in p:
            a, c = attn_lib.attn_decode(cfg, p["attn"], h, c, positions, rolling=roll)
        else:
            a, c = ssd_lib.ssd_decode(cfg, p["ssm"], h, c)
        c = {**c, **planes}  # the static cross K/V planes stay in the cache
        x = x + a
        if "cross" in p and planes:
            x = _cross_residual(cfg, p, x, lambda pc, hc: attn_lib.cross_decode_cached(cfg, pc, hc, c["ck"], c["cv"]))
        elif "cross" in p and encoder_out is not None:
            x = _cross_residual(
                cfg, p, x, lambda pc, hc: attn_lib.attn_decode(cfg, pc, hc, c, positions, encoder_out=encoder_out)[0]
            )
        x, _ = _ffn_residual(cfg, p, x)
        new_cache.append(c)
    x = apply_norm(cfg.norm, params["final_norm"], x, cfg.norm_eps)
    return _logits(cfg, params, x), new_cache
