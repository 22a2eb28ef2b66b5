"""GQA attention: the port of ``repro.models.attention``.

Full-sequence causal / sliding-window / full attention for prefill and the
encoder, KV-cache decode, the rolling-window cache for long-context decode,
and cross-attention to an encoder's output (whisper).  Weights keep the
reference's layout (dense weights (in, out), ``x @ W``) and activations its
(B, S, H, hd) layout.  ``attn_forward(use_kernel=False)`` computes exactly
the reference's masked-softmax path; ``use_kernel=True`` sends
self-attention to ``kernels.ops.swa_attention`` (the Hopper kernel on CUDA
tensors), which computes the same function with fp32 scores and
probabilities.  Cross-attention (queries over the decoder's S tokens, keys
over the encoder's frames) is plain PyTorch on either route: no TPU kernel
computes it (the reference's is plain ``jnp`` too), and ``swa_attention``
takes one length for queries and keys.

Multi-head latent attention (DeepSeek-V2, ``cfg.kv_lora_rank > 0``):
:func:`init_mla` and :func:`mla_forward`, the released
``modeling_deepseek.py`` without a q-LoRA.  q and k are nope + rope wide
(192 for DeepSeek-V2-Lite) and v another width (128), which
``swa_attention`` does not take, so MLA's core has a kernel of its own,
``kernels/mla_attention.py`` (forward and backward, one launch a direction
under ``vmap``): CUDA bf16 inputs take it, everything else the plain masked
softmax (``kernels.ref.mla_attention_ref``).  Serving a latent cache is not
ported (``decoder.init_cache`` refuses MLA).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch.profiler import record_function

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import CHUNK_THRESHOLD, Q_CHUNK, gqa_out, gqa_scores, masked_softmax_chunks  # noqa: F401
from repro_torch.models import spmd
from repro_torch.models.common import (
    Params,
    apply_norm,
    apply_rope,
    apply_rope_pairs,
    dense_init,
    init_norm,
    rope_freqs,
    yarn_inv_freq,
    yarn_mscale,
)


def init_attn(generator: torch.Generator, cfg: ModelConfig, dtype: torch.dtype) -> Params:
    """One layer's weights, drawn from ``generator`` on its device."""
    d, nh, nkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    dev = generator.device
    p: Params = {
        "wq": dense_init(generator, d, nh * hd, dtype),
        "wk": dense_init(generator, d, nkv * hd, dtype),
        "wv": dense_init(generator, d, nkv * hd, dtype),
        "wo": dense_init(generator, nh * hd, d, dtype),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros(nh * hd, dtype=dtype, device=dev)
        p["bk"] = torch.zeros(nkv * hd, dtype=dtype, device=dev)
        p["bv"] = torch.zeros(nkv * hd, dtype=dtype, device=dev)
    if cfg.attn_out_bias:
        p["bo"] = torch.zeros(d, dtype=dtype, device=dev)
    return p


def _project_flat(cfg: ModelConfig, p: Params, xq: torch.Tensor, xkv: torch.Tensor):
    """q (B, Sq, nh*hd), k and v (B, Sk, nkv*hd): the projections before the
    heads are split."""
    q = xq @ p["wq"]
    k = xkv @ p["wk"]
    v = xkv @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return q, k, v


def _split_heads(x: torch.Tensor, hd: int) -> torch.Tensor:
    """(B, S, H*hd) -> (B, S, H, hd), H from the shape (a rank's own heads
    when the heads are sharded)."""
    return x.reshape(x.shape[0], x.shape[1], -1, hd)


def _repeat_kv(cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """A DTensor (B, S, nkv*hd) -> (B, S, nh*hd): KV head i repeated for
    query heads i*g .. i*g + g - 1 (query head h reads KV head h // g,
    g = nh / nkv)."""
    B, S = x.shape[:2]
    nkv, hd, g = cfg.num_kv_heads, cfg.head_dim, cfg.num_heads // cfg.num_kv_heads
    x = spmd.to_batch_layout(x)  # whole KV heads on every model rank first
    return x.reshape(B, S, nkv, 1, hd).expand(B, S, nkv, g, hd).reshape(B, S, nkv * g * hd)


def heads_spec(cfg: ModelConfig, mesh) -> tuple:
    """The layout of (B, S, H*hd) activations around the attention core:
    batch over the data axes, and heads over ``model`` when both the query
    and the KV heads divide over it (a rank then holds whole GQA groups);
    else every model rank holds all heads (``attn_forward`` then repeats
    the KV heads where the query heads alone divide).  None without a
    mesh."""
    if mesh is None:
        return None
    m = spmd.model_size(mesh)
    heads = "model" if cfg.num_heads % m == 0 and cfg.num_kv_heads % m == 0 else None
    return (spmd.BATCH, None, heads)


def attn_forward(
    cfg: ModelConfig,
    p: Params,
    x: torch.Tensor,
    positions: torch.Tensor,
    causal: bool = True,
    window: int = 0,
    encoder_out: Optional[torch.Tensor] = None,
    use_kernel: bool = False,
) -> torch.Tensor:
    """Full-sequence attention (prefill, the encoder, cross-attention).
    x: (B, S, d); positions: (S,) or (B, S).  window > 0 => sliding-window
    causal.  ``encoder_out`` (B, S_enc, d): cross-attention, keys and values
    from it, no RoPE on them and no mask.

    ``use_kernel=True`` passes q and k after RoPE, and v, as (B, H, S, hd)
    views of the projections to ``kernels.ops.swa_attention``, K/V at their
    own Hkv heads; the output comes back as a view in (B, S, H, hd) order.
    The reference applies no mask (and so no window) when not causal; the
    kernel route follows it.  Cross-attention takes the plain route whatever
    ``use_kernel`` says (see the module's docstring)."""
    cross = encoder_out is not None
    with record_function("lm.qkv"):
        q, k, v = _project_flat(cfg, p, x, encoder_out if cross else x)
    causal = causal and not cross
    mesh = spmd.mesh_of(q)
    spec = heads_spec(cfg, mesh)
    if spec is not None and spec[2] is None and cfg.num_heads % spmd.model_size(mesh) == 0:
        # the query heads divide over ``model`` but the KV heads do not: each
        # KV head repeated for its query group, so a rank holds whole groups
        k, v = _repeat_kv(cfg, k), _repeat_kv(cfg, v)
        spec = (spmd.BATCH, None, "model")
    out = spmd.local(
        lambda q_, k_, v_: _attend(cfg, q_, k_, v_, positions, causal, window, cross, use_kernel),
        spec, (spec, spec, spec), q, k, v,
    )
    with record_function("lm.out_proj"):
        return _out_proj(cfg, p, out)


def _attend(
    cfg: ModelConfig,
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    positions: torch.Tensor,
    causal: bool,
    window: int,
    cross: bool,
    use_kernel: bool,
) -> torch.Tensor:
    """The attention core on (B, S, H*hd) projections -> (B, Sq, H*hd):
    the heads split, RoPE, then the kernel or the plain masked softmax."""
    hd = cfg.head_dim
    q, k, v = _split_heads(q, hd), _split_heads(k, hd), _split_heads(v, hd)
    with record_function("lm.qkv"):
        if cfg.use_rope and not cross:
            pos_b = positions if positions.dim() == 2 else positions[None, :]
            q = apply_rope(q, pos_b, cfg.rope_theta)
            k = apply_rope(k, pos_b, cfg.rope_theta)
    B, S, nh, hd = q.shape
    with record_function("lm.attn"):
        if use_kernel and not cross:
            o = kops.swa_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), window=window if causal else 0, causal=causal
            )
            return o.transpose(1, 2).reshape(B, S, nh * hd)
        return masked_softmax_chunks(q, k, v, causal, window)


# ---------------------------------------------------------------------------
# Multi-head latent attention (DeepSeek-V2)
# ---------------------------------------------------------------------------


def init_mla(generator: torch.Generator, cfg: ModelConfig, dtype: torch.dtype) -> Params:
    """One MLA layer: ``wq`` (q_proj, d -> H (nope + rope)), ``wkv_a``
    (kv_a_proj_with_mqa, d -> r + rope), ``kv_norm`` (kv_a_layernorm over the
    r latent dims), ``wkv_b`` (kv_b_proj, r -> H (nope + v)) and ``wo``
    (o_proj, H v -> d), dense weights (in, out)."""
    d, nh, r = cfg.d_model, cfg.num_heads, cfg.kv_lora_rank
    nope, rope, v = cfg.q_head_dim_nope, cfg.q_head_dim_rope, cfg.v_head_dim
    return {
        "wq": dense_init(generator, d, nh * (nope + rope), dtype),
        "wkv_a": dense_init(generator, d, r + rope, dtype),
        "kv_norm": init_norm(cfg.norm, r, dtype, generator.device),
        "wkv_b": dense_init(generator, r, nh * (nope + v), dtype),
        "wo": dense_init(generator, nh * v, d, dtype),
    }


def mla_softmax_scale(cfg: ModelConfig) -> float:
    """1 / sqrt(nope + rope), times YaRN's mscale(factor, mscale_all_dim)^2."""
    scale = (cfg.q_head_dim_nope + cfg.q_head_dim_rope) ** -0.5
    y = cfg.rope_scaling
    if y is not None and y.mscale_all_dim:
        scale *= yarn_mscale(y.factor, y.mscale_all_dim) ** 2
    return scale


def _mla_rope(cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """The rope part (..., S, H, rope) rotated: YaRN's frequencies and its
    cos/sin factor mscale(factor, mscale) / mscale(factor, mscale_all_dim)
    where ``cfg.rope_scaling`` is set, plain frequencies otherwise."""
    y, dim = cfg.rope_scaling, cfg.q_head_dim_rope
    if y is None:
        return apply_rope_pairs(x, positions, rope_freqs(dim, cfg.rope_theta, x.device))
    inv_freq = yarn_inv_freq(dim, cfg.rope_theta, y, x.device)
    scale = yarn_mscale(y.factor, y.mscale) / yarn_mscale(y.factor, y.mscale_all_dim)
    return apply_rope_pairs(x, positions, inv_freq, scale)


def mla_forward(cfg: ModelConfig, p: Params, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """Full-sequence causal MLA: x (B, S, d), positions (S,) or (B, S) ->
    (B, S, d).  q = x wq split into nope and rope parts per head; the
    latent c = kv_norm(x wkv_a[:r]) gives each head's k nope and v through
    ``wkv_b``; the rope key x wkv_a[r:] is one per token, shared by the
    heads; both rope parts rotated (:func:`_mla_rope`); then the causal
    core, ``kernels.ops.mla_attention`` (the kernel on CUDA bf16 inputs,
    else the plain masked softmax)."""
    B, S, _ = x.shape
    nh, r = cfg.num_heads, cfg.kv_lora_rank
    nope, rope, vd = cfg.q_head_dim_nope, cfg.q_head_dim_rope, cfg.v_head_dim
    pos_b = positions if positions.dim() == 2 else positions[None, :]
    with record_function("lm.mla.q"):
        q = (x @ p["wq"]).reshape(B, S, nh, nope + rope)
        q = torch.cat([q[..., :nope], _mla_rope(cfg, q[..., nope:], pos_b)], dim=-1)
    with record_function("lm.mla.kv"):
        ckv = x @ p["wkv_a"]
        kv = (apply_norm(cfg.norm, p["kv_norm"], ckv[..., :r], cfg.norm_eps) @ p["wkv_b"]).reshape(B, S, nh, nope + vd)
        k_rope = _mla_rope(cfg, ckv[..., None, r:], pos_b).expand(B, S, nh, rope)
        k = torch.cat([kv[..., :nope], k_rope], dim=-1)
        v = kv[..., nope:]
    with record_function("lm.attn"):
        o = kops.mla_attention(q, k, v, mla_softmax_scale(cfg))
    with record_function("lm.out_proj"):
        return o @ p["wo"]


# ---------------------------------------------------------------------------
# Decode with a KV cache
# ---------------------------------------------------------------------------


def cross_kv(cfg: ModelConfig, p: Params, encoder_out: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Project the encoder output to cross-attention K/V once (at prefill):
    (B, S_enc, Hkv, hd) each.  Decode then reads these planes instead of
    re-projecting every frame per token."""
    B, S = encoder_out.shape[:2]
    nkv, hd = cfg.num_kv_heads, cfg.head_dim
    k = encoder_out @ p["wk"]
    v = encoder_out @ p["wv"]
    if cfg.qkv_bias:
        k, v = k + p["bk"], v + p["bv"]
    return k.reshape(B, S, nkv, hd), v.reshape(B, S, nkv, hd)


def _unmasked_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, hd: int) -> torch.Tensor:
    """Unmasked attention of flat q (B, Sq, H*hd) over k, v (B, Sk, Hkv, hd)
    -> (B, Sq, H*hd)."""
    q = _split_heads(q, hd)
    attn = torch.softmax(gqa_scores(q, k).float(), dim=-1).to(q.dtype)
    return gqa_out(attn, v)


def _out_proj(cfg: ModelConfig, p: Params, o: torch.Tensor) -> torch.Tensor:
    out = o @ p["wo"]
    if cfg.attn_out_bias:
        out = out + p["bo"]
    return out


def _plane_spec(spec):
    """The (B, S, Hkv, hd) planes' layout beside (B, S, H*hd) activations of
    ``spec``: the same batch and heads axes."""
    return None if spec is None else (spec[0], None, spec[2], None)


def _cross_unmasked(
    cfg: ModelConfig, p: Params, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, flat_kv: bool = False
) -> torch.Tensor:
    """q (B, Sq, H*hd) over k, v planes (B, Sk, Hkv, hd), or flat
    (B, Sk, Hkv*hd) projections with ``flat_kv``, then ``wo``."""
    hd = cfg.head_dim
    spec = heads_spec(cfg, spmd.mesh_of(q))
    kv = spec if flat_kv else _plane_spec(spec)

    def core(q_, k_, v_):
        if flat_kv:
            k_, v_ = _split_heads(k_, hd), _split_heads(v_, hd)
        return _unmasked_core(q_, k_, v_, hd)

    return _out_proj(cfg, p, spmd.local(core, spec, (spec, kv, kv), q, k, v))


def cross_decode_cached(
    cfg: ModelConfig, p: Params, x: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor
) -> torch.Tensor:
    """One-token cross-attention against cached K/V planes. x: (B, 1, d)."""
    q = x @ p["wq"]
    if cfg.qkv_bias:
        q = q + p["bq"]
    return _cross_unmasked(cfg, p, q, ck, cv)


def init_kv_cache(
    cfg: ModelConfig, batch: int, length: int, dtype: torch.dtype, device: torch.device
) -> Dict[str, torch.Tensor]:
    nkv, hd = cfg.num_kv_heads, cfg.head_dim
    return {
        "k": torch.zeros(batch, length, nkv, hd, dtype=dtype, device=device),
        "v": torch.zeros(batch, length, nkv, hd, dtype=dtype, device=device),
    }


def attn_decode(
    cfg: ModelConfig,
    p: Params,
    x: torch.Tensor,
    cache: Dict[str, torch.Tensor],
    positions: torch.Tensor,
    rolling: bool = False,
    encoder_out: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token decode. x: (B, 1, d); positions: (B,) absolute position of
    the new token.  ``rolling=True`` treats the cache as a circular buffer of
    width W; otherwise it is a linear cache of capacity >= positions+1.
    Returns the output and a new cache (the old one is not written).
    Cross-attention (``encoder_out`` given) projects the encoder's K/V here
    and returns the cache as it came."""
    if encoder_out is not None:
        q, k, v = _project_flat(cfg, p, x, encoder_out)
        return _cross_unmasked(cfg, p, q, k, v, flat_kv=True), cache
    q, k, v = _project_flat(cfg, p, x, x)  # (B,1,*)
    spec = heads_spec(cfg, spmd.mesh_of(q))
    plane = _plane_spec(spec)
    o, ck, cv = spmd.local(
        lambda *a: _decode_core(cfg, *a, rolling),
        [spec, plane, plane],
        (spec, spec, spec, plane, plane, None if spec is None else (spmd.BATCH,)),
        q, k, v, cache["k"], cache["v"], positions,
    )
    return _out_proj(cfg, p, o), {"k": ck, "v": cv}


def _decode_core(
    cfg: ModelConfig,
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    cache_k: torch.Tensor,
    cache_v: torch.Tensor,
    positions: torch.Tensor,
    rolling: bool,
):
    """The new token's K/V written to the cache and its attention over it:
    flat (B, 1, H*hd) q, k, v -> (flat output, new K, new V)."""
    hd = cfg.head_dim
    q, k, v = _split_heads(q, hd), _split_heads(k, hd), _split_heads(v, hd)
    if cfg.use_rope:
        q = apply_rope(q, positions[:, None], cfg.rope_theta)
        k = apply_rope(k, positions[:, None], cfg.rope_theta)
    B, W = q.shape[0], cache_k.shape[1]
    slot = torch.remainder(positions, W) if rolling else torch.clamp(positions, max=W - 1)
    # The reference writes with a one-hot blend, buf·(1 - onehot) + new·onehot;
    # for finite inputs that is this write of the new row at ``slot``.
    rows = (torch.arange(B, device=q.device), slot)
    ck = cache_k.index_put(rows, k[:, 0])
    cv = cache_v.index_put(rows, v[:, 0])
    scores = gqa_scores(q, ck).float()  # (B, nh, 1, W)
    slots = torch.arange(W, device=q.device)[None, :]  # (1, W)
    if rolling:
        # slot j holds absolute position p_j = pos - ((pos - j) mod W); valid if
        # p_j >= 0 (torch.remainder, like jnp.mod, takes the divisor's sign)
        pj = positions[:, None] - torch.remainder(positions[:, None] - slots, W)
        valid = pj >= 0
    else:
        valid = slots <= positions[:, None]
    scores = scores.masked_fill(~valid[:, None, None, :], -1e30)
    attn = torch.softmax(scores, dim=-1).to(q.dtype)
    return gqa_out(attn, cv), ck, cv
