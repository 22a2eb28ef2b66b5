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
``cfg.block_period``; here that grouping shows only in
``checkpoint/convert.py`` and in the checkpoints of ``remat``.

Training (``loss_fn``, ``forward_hidden``) runs the plain forms under
autograd, as the reference differentiates its plain ``jnp`` forms; the
kernels serve inference (prefill, the feature taps).

The same functions run on DTensor params and inputs laid out by
``launch/sharding.py`` (the dry-run, the sharded steps); ``models/spmd.py``
names the layouts the propagation cannot find by itself.
:func:`set_activation_shardings` pins the (B, S, d) activations and the
logits to set placements at the reference's seven points.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.profiler import record_function
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import spmd
from repro_torch.models import ssd as ssd_lib
from repro_torch.models.common import (
    Params,
    apply_mlp,
    apply_norm,
    embed_init,
    init_mlp,
    init_norm,
    softmax_cross_entropy,
    softmax_cross_entropy_per_token,
)

Cache = List[Dict[str, torch.Tensor]]

# ---------------------------------------------------------------------------
# Activation layouts (set by the launcher; None on one device): the
# reference's constraints, DTensor placements of the launcher's mesh.  The
# per-layer FSDP gather and the sublayers' reductions already keep (B, S, d)
# batch-sharded, so pinning it costs nothing where the layouts agree and
# redistributes where a launcher asks for another.
# ---------------------------------------------------------------------------

_ACT_PLACEMENTS = None  # (B, S, d) activations
_LOGITS_PLACEMENTS = None  # (B, S, V) logits


def set_activation_shardings(act=None, logits=None) -> None:
    """Pin 3-D activations (``act``) and logits (``logits``) to these
    placements at the reference's constraint points; None unpins."""
    global _ACT_PLACEMENTS, _LOGITS_PLACEMENTS
    _ACT_PLACEMENTS = act
    _LOGITS_PLACEMENTS = logits


def _constrain(x: torch.Tensor, which: str = "act") -> torch.Tensor:
    """A 3-D DTensor redistributed to the set placements; the identity on a
    plain tensor or when none are set."""
    pl = _ACT_PLACEMENTS if which == "act" else _LOGITS_PLACEMENTS
    if pl is not None and spmd.is_dtensor(x) and x.dim() == 3:
        return x.redistribute(x.device_mesh, pl)
    return x


def _embed(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]``.  On DTensors the lookup takes the table with d over
    ``model`` only (gathered from its vocab-over-model, d-over-data layout,
    as FSDP gathers a weight before use) and the ids batch-sharded, so no
    lookup maps ``data`` twice and no partial sum over the vocab shards
    needs a backward; the rows come back in the batch-sharded layout."""
    if not spmd.is_dtensor(table):
        return table[ids]
    mesh = table.device_mesh
    d = "model" if table.shape[1] % spmd.model_size(mesh) == 0 else None
    table = table.redistribute(mesh, spmd.placements(mesh, (None, d)))
    return spmd.to_batch_layout(F.embedding(spmd.to_batch_layout(ids), table))


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
        p["attn"] = attn_lib.init_mla(g, cfg, dtype) if cfg.is_mla else attn_lib.init_attn(g, cfg, dtype)
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
            p["mlp"] = init_mlp(g, cfg.d_model, cfg.mlp_width(i), cfg.act, dtype)
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


def flat_params(params: Params) -> Dict[str, torch.Tensor]:
    """The params as one flat dict of dotted names (``layers.3.attn.wq``,
    ``final_norm.scale``): the form the simulator stacks per client."""
    out: Dict[str, torch.Tensor] = {}

    def walk(tree, prefix: str) -> None:
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        for k, v in items:
            name = f"{prefix}{k}"
            if isinstance(v, torch.Tensor):
                out[name] = v
            else:
                walk(v, name + ".")

    walk(params, "")
    return out


def nest_params(flat: Dict[str, torch.Tensor]) -> Params:
    """Inverse of :func:`flat_params`: numeric parts of a name index lists."""
    root: Dict = {}
    for name, t in flat.items():
        node = root
        *parents, leaf = name.split(".")
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = t

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [lists(node[str(i)]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}

    return lists(root)


def _head(cfg: ModelConfig, params: Params) -> torch.Tensor:
    """The LM head (V, d), its FSDP factor gathered on DTensors."""
    return spmd.gather_fsdp(params["embed"] if cfg.tie_embeddings else params["lm_head"])


def _logits(cfg: ModelConfig, params: Params, x: torch.Tensor) -> torch.Tensor:
    return spmd.tp_input(x) @ _head(cfg, params).T.to(cfg.dtype)


# ---------------------------------------------------------------------------
# Forward (prefill)
# ---------------------------------------------------------------------------


def _ffn_residual(cfg: ModelConfig, p: Params, x: torch.Tensor) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """x + the layer's MLP or MoE of norm2(x), and the MoE's aux loss (None
    for an MLP layer).  On DTensors every sublayer's output (a partial sum
    over ``model`` after a row-parallel weight) is reduced to the
    batch-sharded layout before the residual add, as Megatron-style tensor
    parallelism does."""
    if cfg.d_ff == 0:
        return x, None
    with record_function("lm.norm"):
        h = spmd.tp_input(apply_norm(cfg.norm, p["norm2"], x, cfg.norm_eps))
    if "moe" in p:
        with record_function("lm.moe"):
            f, aux = moe_lib.apply_moe(cfg, p["moe"], h)
            return x + spmd.to_batch_layout(f), aux
    with record_function("lm.mlp"):
        return x + spmd.to_batch_layout(apply_mlp(p["mlp"], h, cfg.act)), None


def _cross_residual(cfg: ModelConfig, p: Params, x: torch.Tensor, attend) -> torch.Tensor:
    """x + cross-attention of norm_cross(x), ``attend(p["cross"], h)``."""
    with record_function("lm.norm"):
        h = spmd.tp_input(apply_norm(cfg.norm, p["norm_cross"], x, cfg.norm_eps))
    with record_function("lm.cross"):
        return x + spmd.to_batch_layout(attend(p["cross"], h))


def _run_block(
    cfg: ModelConfig,
    layers: List[Params],
    x: torch.Tensor,
    aux: torch.Tensor,
    positions: torch.Tensor,
    window: int,
    causal: bool,
    encoder_out: Optional[torch.Tensor],
    use_kernel: bool,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One super-block of layers: x and the running aux loss through each
    layer in order (the MoE layers add theirs).  On DTensors each layer's
    weights are gathered over the data axes first (FSDP)."""
    sharded = spmd.is_dtensor(x)
    for p in layers:
        if sharded:
            p = spmd.gather_fsdp(p)
        with record_function("lm.norm"):
            h = spmd.tp_input(apply_norm(cfg.norm, p["norm1"], x, cfg.norm_eps))
        if "attn" in p and cfg.is_mla:
            a = attn_lib.mla_forward(cfg, p["attn"], h, positions)
        elif "attn" in p:
            a = attn_lib.attn_forward(cfg, p["attn"], h, positions, causal=causal, window=window, use_kernel=use_kernel)
        else:
            a = ssd_lib.ssd_forward(cfg, p["ssm"], h, use_kernel=use_kernel)
        x = x + spmd.to_batch_layout(a)
        if encoder_out is not None and "cross" in p:
            x = _cross_residual(
                cfg, p, x, lambda pc, hc: attn_lib.attn_forward(cfg, pc, hc, positions, encoder_out=encoder_out)
            )
        x, layer_aux = _ffn_residual(cfg, p, x)
        x = _constrain(x)
        if layer_aux is not None:
            aux = aux + layer_aux
    return x, aux


def _run_stack(
    cfg: ModelConfig,
    layers: List[Params],
    x: torch.Tensor,
    positions: torch.Tensor,
    window: int,
    causal: bool,
    encoder_out: Optional[torch.Tensor],
    use_kernel: bool,
    remat: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The layers in super-blocks of ``cfg.block_period``.  ``remat``
    checkpoints each super-block (``torch.utils.checkpoint``, non-reentrant):
    the backward pass recomputes its activations from its input, as the
    reference's ``jax.checkpoint(body)``; the values are the same bits."""
    period = cfg.block_period
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for b in range(0, len(layers), period):
        args = (cfg, layers[b : b + period], x, aux, positions, window, causal, encoder_out, use_kernel)
        x, aux = checkpoint(_run_block, *args, use_reentrant=False) if remat else _run_block(*args)
    return x, aux


def encode(cfg: ModelConfig, params: Params, frames: torch.Tensor, use_kernel: bool = False) -> torch.Tensor:
    """The encoder over (stubbed frontend) frames (B, S_enc, d): learned
    positions, a non-causal stack (its self-attention through the
    ``swa_attention`` kernel with ``causal=False`` when ``use_kernel``),
    then ``enc_final_norm``."""
    S = frames.shape[1]
    with record_function("lm.embed"):
        x = spmd.to_batch_layout(frames + params["enc_pos_embed"][None, :S, :])
    positions = torch.arange(S, device=x.device)
    x, _ = _run_stack(cfg, params["enc_layers"], x, positions, 0, False, None, use_kernel)
    with record_function("lm.norm"):
        return apply_norm(cfg.norm, params["enc_final_norm"], x, cfg.norm_eps)


def forward_hidden(
    cfg: ModelConfig,
    params: Params,
    tokens: torch.Tensor,
    prefix_embeddings: Optional[torch.Tensor] = None,
    encoder_frames: Optional[torch.Tensor] = None,
    remat: bool = False,
    use_kernel: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Final-norm hidden states over the token positions (B, S, d), the
    prefix positions cut off, and the MoE aux loss summed over layers (fp32):
    the tensor before the head, which the chunked CE of :func:`loss_fn`
    reads.  ``prefix_embeddings`` (B, P, d) go before the tokens (positions
    and RoPE run over S + P).  An encoder-decoder needs ``encoder_frames``.
    ``use_kernel`` is passed to every ``ssd_forward`` and ``attn_forward``:
    True sends the scan to ``kernels.ops.ssd_scan`` and self-attention to
    ``kernels.ops.swa_attention`` (inference only: the kernels refuse
    ``requires_grad``); False computes exactly the reference decoder's plain
    forms.  ``remat`` checkpoints each super-block (:func:`_run_stack`).
    The reference's ``unroll`` switch (a Python loop instead of
    ``lax.scan``, so that XLA's cost analysis sees every layer) has no
    counterpart: the layers here are always a Python loop.  Decoder
    attention is causal, within ``cfg.sliding_window`` when it is set."""
    if cfg.is_encoder_decoder and encoder_frames is None:
        raise ValueError(f"{cfg.name} is an encoder-decoder: pass encoder_frames")
    S = tokens.shape[1]
    with record_function("lm.embed"):
        x = _embed(params["embed"], tokens).to(cfg.dtype)
        P = 0
        if prefix_embeddings is not None:
            P = prefix_embeddings.shape[1]
            x = torch.cat([prefix_embeddings.to(cfg.dtype), x], dim=1)
        if "pos_embed" in params:
            x = x + params["pos_embed"][None, : S + P, :].to(cfg.dtype)
        x = _constrain(spmd.to_batch_layout(x))
    positions = torch.arange(S + P, device=x.device)
    encoder_out = spmd.tp_input(encode(cfg, params, encoder_frames, use_kernel)) if cfg.is_encoder_decoder else None
    x, aux = _run_stack(
        cfg, params["layers"], x, positions, cfg.sliding_window, True, encoder_out, use_kernel, remat
    )
    with record_function("lm.head"):
        x = apply_norm(cfg.norm, params["final_norm"], x, cfg.norm_eps)
        return _constrain(x[:, P:, :]), aux


def forward_logits(
    cfg: ModelConfig,
    params: Params,
    tokens: torch.Tensor,
    prefix_embeddings: Optional[torch.Tensor] = None,
    encoder_frames: Optional[torch.Tensor] = None,
    last_only: bool = False,
    use_kernel: bool = False,
    remat: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (logits over the token positions (B, S, V), or (B, 1, V) with
    ``last_only``; the MoE aux loss summed over layers, fp32): the head
    over :func:`forward_hidden`, whose arguments these are."""
    x, aux = forward_hidden(cfg, params, tokens, prefix_embeddings, encoder_frames, remat, use_kernel)
    with record_function("lm.head"):
        if last_only:
            x = x[:, -1:, :]
        return _constrain(_logits(cfg, params, _constrain(x)), "logits"), aux


# ---------------------------------------------------------------------------
# Loss (training)
# ---------------------------------------------------------------------------


def _chunk_ce(x: torch.Tensor, labels: torch.Tensor, w: torch.Tensor, head: torch.Tensor, impl: str) -> torch.Tensor:
    """Σ w · CE over one chunk of positions: x (B, C, d), labels (B, C), w (C,)."""
    logits = _constrain(spmd.tp_input(x) @ head, "logits")
    return torch.sum(softmax_cross_entropy_per_token(logits, labels, impl) * w[None, :])


def loss_fn(
    cfg: ModelConfig,
    params: Params,
    batch: Dict[str, torch.Tensor],
    aux_weight: float = 0.01,
    remat: bool = False,
    ce_impl: str = "gather",
    ce_chunk: int = 0,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token CE of ``batch["tokens"]`` (B, S) against
    ``batch["labels"]`` shifted by one, plus ``aux_weight`` times the MoE
    aux loss; ``batch`` may hold ``prefix_embeddings`` and
    ``encoder_frames``.  Returns (loss, {"ce", "moe_aux"}).

    ``ce_chunk = 0`` takes the CE over the full (B, S - 1, V) logits.
    ``ce_chunk = C > 0`` evaluates the head and the CE C positions at a
    time, each chunk checkpointed, so the full logits (and their fp32
    copies) never exist and the backward pass recomputes each chunk's: the
    S - 1 positions are padded to a multiple of C with copies of the last
    column, weighted 0, and the sum is divided by B · (S - 1).  Plain forms
    throughout (no kernel: the loss is differentiated)."""
    tokens, labels = batch["tokens"], batch["labels"]
    inputs = dict(prefix_embeddings=batch.get("prefix_embeddings"), encoder_frames=batch.get("encoder_frames"))
    if ce_chunk <= 0:
        logits, aux = forward_logits(cfg, params, tokens, remat=remat, **inputs)
        ce = softmax_cross_entropy(logits[:, :-1], labels[:, 1:], impl=ce_impl)
        return ce + aux_weight * aux, {"ce": ce, "moe_aux": aux}
    x, aux = forward_hidden(cfg, params, tokens, remat=remat, **inputs)
    head = _head(cfg, params).T.to(cfg.dtype)
    xs, ls = x[:, :-1], labels[:, 1:]
    B, Sm1, d = xs.shape
    C = ce_chunk
    pad = (-Sm1) % C
    if pad:  # pad with a repeat of the last column, weight it zero
        xs = torch.cat([xs, xs[:, -1:].expand(B, pad, d)], dim=1)
        ls = torch.cat([ls, ls[:, -1:].expand(B, pad)], dim=1)
    w = torch.cat([torch.ones(Sm1, device=x.device), torch.zeros(pad, device=x.device)])
    with record_function("lm.ce"):
        totals = [
            checkpoint(_chunk_ce, xs[:, i : i + C], ls[:, i : i + C], w[i : i + C], head, ce_impl, use_reentrant=False)
            for i in range(0, Sm1 + pad, C)
        ]
        ce = torch.stack(totals).sum() / (B * Sm1)
    return ce + aux_weight * aux, {"ce": ce, "moe_aux": aux}


# ---------------------------------------------------------------------------
# Feature tap (the paper's proxy, at modern scale)
# ---------------------------------------------------------------------------


def feature_vectors(
    cfg: ModelConfig,
    params: Params,
    tokens: torch.Tensor,
    prefix_embeddings: Optional[torch.Tensor] = None,
    encoder_frames: Optional[torch.Tensor] = None,
    use_kernel: bool = False,
) -> torch.Tensor:
    """The probe: one shared model over N clients' batches in one forward.
    tokens (N, b, S) (prefix embeddings (N, b, P, d), frames (N, b, S_enc,
    d)) -> (N, V), row i :func:`feature_vector` of client i's batch: the
    softmax of the fp32 logits, averaged over batch and positions.  Runs
    under ``inference_mode``; ``use_kernel`` as in :func:`forward_hidden`."""
    N, b = tokens.shape[:2]

    def rows(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        return None if t is None else t.reshape((N * b,) + t.shape[2:])

    with torch.inference_mode():
        logits, _ = forward_logits(
            cfg, params, rows(tokens), rows(prefix_embeddings), rows(encoder_frames), use_kernel=use_kernel
        )
        probs = torch.softmax(logits.float(), dim=-1)
        return probs.reshape((N, -1, probs.shape[-1])).mean(dim=1)


def feature_vector(
    cfg: ModelConfig,
    params: Params,
    tokens: torch.Tensor,
    prefix_embeddings: Optional[torch.Tensor] = None,
    encoder_frames: Optional[torch.Tensor] = None,
    use_kernel: bool = False,
) -> torch.Tensor:
    """The feature z of Eq. (5)/(6) for an LM: the softmax-normalised output
    distribution of the fp32 logits over a small batch (B, S), averaged over
    batch and positions -> (V,).  One forward, under ``inference_mode``."""
    def one(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        return None if t is None else t[None]

    return feature_vectors(cfg, params, tokens[None], one(prefix_embeddings), one(encoder_frames), use_kernel)[0]


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


def _refuse_mla(cfg: ModelConfig) -> None:
    if cfg.is_mla:
        raise NotImplementedError(
            f"{cfg.name} uses multi-head latent attention: its latent cache is not ported, so it cannot be served "
            "token by token (its full-sequence forward, loss and feature taps run)"
        )


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
    :func:`prefill_cross_cache` to fill.  Latent attention (MLA) has no
    cache here: serving it is not ported."""
    _refuse_mla(cfg)
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
    _refuse_mla(cfg)
    roll = rolling or cfg.sliding_window > 0
    x = _embed(params["embed"], tokens).to(cfg.dtype)
    if "pos_embed" in params:
        x = spmd.to_batch_layout(x + _embed(params["pos_embed"], positions)[:, None, :].to(cfg.dtype))
    new_cache = []
    sharded = spmd.is_dtensor(x)
    for p, c in zip(params["layers"], cache):
        if sharded:
            p = spmd.gather_fsdp(p)
        h = apply_norm(cfg.norm, p["norm1"], x, cfg.norm_eps)
        planes = {k: c[k] for k in ("ck", "cv") if k in c}
        if "attn" in p:
            a, c = attn_lib.attn_decode(cfg, p["attn"], h, c, positions, rolling=roll)
        else:
            a, c = ssd_lib.ssd_decode(cfg, p["ssm"], h, c)
        c = {**c, **planes}  # the static cross K/V planes stay in the cache
        x = x + spmd.to_batch_layout(a)
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
