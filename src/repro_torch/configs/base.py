"""Language-model architecture config: the port's own copy of
``repro.configs.base``'s :class:`ModelConfig`, with a torch dtype.

Every ported arch gets a module ``src/repro_torch/configs/<id>.py`` that
exports ``CONFIG`` (the exact published spec).  ``reduced()`` derives the
CPU smoke-test variant with exactly the reference's reduced fields.  The
registry loads every arch module in ``_ARCH_MODULES``: the reference's
archs, all of them, and one arch of the port's own, ``deepseek-v2-lite``
(latent attention with YaRN, a leading dense layer, DeepSeekMoE routing),
whose fields the reference's config lacks; their defaults leave every
other arch as the reference has it.  ``INPUT_SHAPES`` and ``input_specs()`` give the
dry-run's (arch, input shape) pairs as shape-and-dtype stand-ins on the
``meta`` device (no allocation).
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch

# ---------------------------------------------------------------------------
# Input shapes (the reference's four)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


INPUT_SHAPES: Dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


@dataclass(frozen=True)
class YaRN:
    """YaRN rope scaling [arXiv:2309.00071] as DeepSeek-V2's
    ``modeling_deepseek.py`` applies it: the inverse frequencies blend the
    original ones (fast dims) with ones divided by ``factor`` (slow dims)
    over a linear ramp between the correction dims of ``beta_fast`` and
    ``beta_slow`` rotations, and the softmax scale is multiplied by
    ``mscale(factor, mscale_all_dim)**2``."""

    factor: float
    original_max_position: int
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    mscale: float = 1.0
    mscale_all_dim: float = 0.0


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | hybrid | ssm | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads
    qkv_bias: bool = False
    attn_out_bias: bool = False
    rope_theta: float = 10_000.0
    use_rope: bool = True
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    act: str = "silu"  # silu (gated) | gelu (non-gated)
    tie_embeddings: bool = False
    # --- MoE ---
    num_experts: int = 0  # routed experts; 0 => dense FFN
    num_shared_experts: int = 0
    experts_per_token: int = 0
    moe_period: int = 1  # layer i uses MoE iff num_experts>0 and i % moe_period == moe_offset
    moe_offset: int = 0
    capacity_factor: float = 1.25
    aux_weight: float = 0.01  # the balance term's weight in loss_fn's total
    # > 0: DeepSeek-V2's expert layer (moe._share: unnormalised top-k gates,
    # no dropped choice, the balance term per sequence) holding experts
    # [expert_offset, expert_offset + experts_held) of the num_experts the
    # router scores, as when each layer's experts are divided over chips;
    # 0: the capacity-routed layer over all experts
    experts_held: int = 0
    expert_offset: int = 0
    first_dense_layers: int = 0  # leading layers with a dense MLP in a MoE stack
    dense_d_ff: int = 0  # their MLP width (0 -> d_ff)
    # --- multi-head latent attention (DeepSeek-V2; kv_lora_rank 0 = off) ---
    kv_lora_rank: int = 0
    q_head_dim_nope: int = 0
    q_head_dim_rope: int = 0
    v_head_dim: int = 0
    rope_scaling: Optional[YaRN] = None
    # --- hybrid: attention layer iff i % attn_period == attn_offset ---
    attn_period: int = 1  # 1 => every layer is attention
    attn_offset: int = 0
    # --- SSM (mamba2) ---
    ssm_state: int = 0  # 0 => no ssm layers
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv_width: int = 4
    ssm_chunk: int = 256
    # --- encoder-decoder ---
    is_encoder_decoder: bool = False
    num_encoder_layers: int = 0
    encoder_seq: int = 1500
    # --- modality frontend stubs ---
    num_prefix_tokens: int = 0
    # --- attention windowing (0 = full attention) ---
    sliding_window: int = 0
    long_context_window: int = 8192
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    source: str = ""  # citation

    def __post_init__(self):
        if self.head_dim == 0 and self.num_heads > 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    # -- derived -----------------------------------------------------------
    def layer_kind(self, i: int) -> str:
        """'attn' or 'ssm' token mixer for layer i."""
        if self.ssm_state == 0:
            return "attn"
        if self.attn_period == 0:  # pure SSM
            return "ssm"
        return "attn" if i % self.attn_period == self.attn_offset else "ssm"

    def layer_moe(self, i: int) -> bool:
        return self.num_experts > 0 and i >= self.first_dense_layers and i % self.moe_period == self.moe_offset

    def mlp_width(self, i: int) -> int:
        """The dense MLP width of layer i: ``dense_d_ff`` for the leading
        dense layers of a MoE stack where it is set, else ``d_ff``."""
        return self.dense_d_ff if i < self.first_dense_layers and self.dense_d_ff else self.d_ff

    @property
    def is_mla(self) -> bool:
        return self.kv_lora_rank > 0

    @property
    def experts_here(self) -> int:
        """The routed experts this chip holds (all of them without a share)."""
        return self.experts_held or self.num_experts

    def attn_param_count(self) -> int:
        d, nh = self.d_model, self.num_heads
        if self.is_mla:
            qk = self.q_head_dim_nope + self.q_head_dim_rope
            r = self.kv_lora_rank
            return (d * nh * qk + d * (r + self.q_head_dim_rope) + r
                    + r * nh * (self.q_head_dim_nope + self.v_head_dim) + nh * self.v_head_dim * d)
        hd, nkv = self.head_dim, self.num_kv_heads
        total = d * nh * hd + 2 * d * nkv * hd + nh * hd * d
        if self.qkv_bias:
            total += (nh + 2 * nkv) * hd
        return total

    @property
    def block_period(self) -> int:
        """The reference stacks layers in super-blocks of this period; the
        port loops over layers and uses it only to convert parameters."""
        p = 1
        if self.ssm_state > 0 and self.attn_period > 1:
            p = self.attn_period
        if self.num_experts > 0 and self.moe_period > 1:
            p = p * self.moe_period // math.gcd(p, self.moe_period)
        return p

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def param_count(self) -> int:
        """Analytic parameter count, term for term the reference's."""
        d, ff, v = self.d_model, self.d_ff, self.vocab_size
        total = v * d * (1 if self.tie_embeddings else 2)
        hd, nh, nkv = self.head_dim, self.num_heads, self.num_kv_heads
        for i in range(self.num_layers):
            kind = self.layer_kind(i)
            if kind == "attn":
                total += self.attn_param_count()
            else:  # ssm
                di, ds, nhs = self.d_inner, self.ssm_state, self.ssm_heads
                total += d * (2 * di + 2 * ds + nhs)  # in_proj (z,x,B,C,dt)
                total += (di + 2 * ds) * self.ssm_conv_width
                total += nhs * 2 + di  # A_log, dt_bias, D
                total += di * d  # out_proj
            if self.layer_moe(i):
                ne = self.experts_here + self.num_shared_experts
                total += ne * 3 * d * ff + d * self.num_experts
            elif kind == "attn" or self.ssm_state == 0 or self.d_ff > 0:
                if self.d_ff > 0 and (kind == "attn" or self.family != "ssm"):
                    total += 3 * d * self.mlp_width(i)
            total += 2 * d  # norms
        if self.is_encoder_decoder:
            for _ in range(self.num_encoder_layers):
                total += d * nh * hd + 2 * d * nkv * hd + nh * hd * d
                total += 2 * (d * ff) + d * ff
            total += self.num_layers * (d * nh * hd + 2 * d * nkv * hd + nh * hd * d + 2 * d)
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE: only the routed top-k and the
        shared experts), the reference's count."""
        if self.num_experts == 0:
            return self.param_count()
        n_moe_layers = sum(1 for i in range(self.num_layers) if self.layer_moe(i))
        expert = 3 * self.d_model * self.d_ff
        if self.experts_held:  # a token meets k * held / E of the experts held here, on average
            idle = self.experts_held * (self.num_experts - self.experts_per_token) / self.num_experts
            return self.param_count() - round(idle * expert) * n_moe_layers
        inactive = (self.num_experts - self.experts_per_token) * expert * n_moe_layers
        return self.param_count() - inactive


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Smoke-test variant of the same family: <=2 layers (respecting the
    block period), d_model<=256, <=4 experts, small vocab, fp32."""
    d_model = min(cfg.d_model, 256)
    n_heads = min(cfg.num_heads, 4) if cfg.num_heads else 0
    head_dim = d_model // n_heads if n_heads else 0
    n_kv = max(1, min(cfg.num_kv_heads, n_heads)) if n_heads else 0
    if n_heads and cfg.num_kv_heads < cfg.num_heads:  # keep the GQA ratio's flavour
        n_kv = max(1, n_heads // max(1, cfg.num_heads // cfg.num_kv_heads))
    changes: Dict[str, Any] = dict(
        num_layers=2,
        d_model=d_model,
        num_heads=n_heads,
        num_kv_heads=n_kv,
        head_dim=head_dim,
        d_ff=min(cfg.d_ff, 512) if cfg.d_ff else 0,
        vocab_size=min(cfg.vocab_size, 512),
        dtype=torch.float32,
        ssm_chunk=64,
        sliding_window=min(cfg.sliding_window, 64) if cfg.sliding_window else 0,
        long_context_window=128,
    )
    if cfg.num_experts > 0:
        changes.update(
            num_experts=4,
            experts_per_token=min(cfg.experts_per_token, 2),
            num_shared_experts=min(cfg.num_shared_experts, 1),
        )
    if cfg.ssm_state > 0:
        changes.update(ssm_state=16, ssm_head_dim=32)
        if cfg.attn_period > 1:  # hybrid: keep the interleave at 2 layers (ssm, attn)
            changes.update(attn_period=2, attn_offset=1, moe_period=min(cfg.moe_period, 2))
    if cfg.is_encoder_decoder:
        changes.update(num_encoder_layers=2, encoder_seq=16)
    if cfg.num_prefix_tokens > 0:
        changes.update(num_prefix_tokens=8)
    if cfg.is_mla:  # the port's own fields: set only where the arch has them
        changes.update(kv_lora_rank=min(cfg.kv_lora_rank, 64), q_head_dim_nope=min(cfg.q_head_dim_nope, 32),
                       q_head_dim_rope=min(cfg.q_head_dim_rope, 16), v_head_dim=min(cfg.v_head_dim, 32))
    if cfg.dense_d_ff:
        changes.update(dense_d_ff=min(cfg.dense_d_ff, 512))
    if cfg.experts_held:
        changes.update(experts_held=min(cfg.experts_held, changes["num_experts"]), expert_offset=0)
    return dataclasses.replace(cfg, **changes)


# ---------------------------------------------------------------------------
# Input specs (shape-and-dtype stand-ins on the meta device; no allocation)
# ---------------------------------------------------------------------------


def input_specs(cfg: ModelConfig, shape: InputShape) -> Dict[str, torch.Tensor]:
    """The abstract inputs of one (arch, input shape) pair, as ``meta``
    tensors with the reference's keys, shapes and dtypes.

    train/prefill: token ids (and labels for train) (B, S); a VLM adds its
    prefix embeddings and an encoder-decoder its frames (the frontends'
    outputs, not raw media), both in ``cfg.dtype``.  decode: one new token
    per sequence and its position; the caller builds the cache."""
    B, S = shape.global_batch, shape.seq_len

    def spec(dims, dtype) -> torch.Tensor:
        return torch.empty(dims, dtype=dtype, device="meta")

    specs: Dict[str, torch.Tensor] = {}
    if shape.kind == "train":
        specs["tokens"] = spec((B, S), torch.int32)
        specs["labels"] = spec((B, S), torch.int32)
    elif shape.kind == "prefill":
        specs["tokens"] = spec((B, S), torch.int32)
    else:
        specs["tokens"] = spec((B, 1), torch.int32)
        specs["positions"] = spec((B,), torch.int32)
    if cfg.num_prefix_tokens > 0 and shape.kind != "decode":
        specs["prefix_embeddings"] = spec((B, cfg.num_prefix_tokens, cfg.d_model), cfg.dtype)
    if cfg.is_encoder_decoder:
        specs["encoder_frames"] = spec((B, cfg.encoder_seq, cfg.d_model), cfg.dtype)
    return specs


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, ModelConfig] = {}

_ARCH_MODULES = [
    "deepseek_moe_16b",
    "internvl2_2b",
    "llama4_scout_17b_a16e",
    "jamba_v0_1_52b",
    "command_r_35b",
    "starcoder2_3b",
    "qwen1_5_0_5b",
    "codeqwen1_5_7b",
    "whisper_large_v3",
    "mamba2_1_3b",
    "deepseek_v2_lite",
]


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def _ensure_loaded() -> None:
    import importlib

    for m in _ARCH_MODULES:
        importlib.import_module(f"repro_torch.configs.{m}")


def get_config(name: str) -> ModelConfig:
    _ensure_loaded()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_configs() -> Tuple[str, ...]:
    _ensure_loaded()
    return tuple(sorted(_REGISTRY))
