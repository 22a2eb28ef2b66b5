"""Mamba2-1.3B [arXiv:2405.21060]: attention-free SSD (state-space duality).
The port's own copy of ``repro.configs.mamba2_1_3b``."""
import torch

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="mamba2-1.3b",
        family="ssm",
        num_layers=48,
        d_model=2048,
        num_heads=0,
        num_kv_heads=0,
        d_ff=0,  # no MLP: mamba2 blocks only
        vocab_size=50280,
        attn_period=0,  # attention-free
        ssm_state=128,
        ssm_head_dim=64,
        ssm_expand=2,
        use_rope=False,
        tie_embeddings=True,
        dtype=torch.bfloat16,
        source="arXiv:2405.21060",
    )
)
