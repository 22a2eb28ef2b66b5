"""Jamba-v0.1-52B [arXiv:2403.19887] — Mamba+attention 7:1 interleave, MoE 16e top-2 every 2nd layer.
The port's own copy of ``repro.configs.jamba_v0_1_52b``."""
import torch

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="jamba-v0.1-52b",
        family="hybrid",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        d_ff=14336,
        vocab_size=65536,
        num_experts=16,
        experts_per_token=2,
        moe_period=2,
        moe_offset=1,
        attn_period=8,  # 1 attention layer per 8 (7 mamba : 1 attn)
        attn_offset=4,
        ssm_state=16,
        ssm_head_dim=64,
        ssm_expand=2,
        use_rope=False,  # Jamba attention has no positional encoding
        dtype=torch.bfloat16,
        source="arXiv:2403.19887",
    )
)
