"""StarCoder2-3B [arXiv:2402.19173]: dense GQA (kv=2), RoPE, sliding-window 4096.
The port's own copy of ``repro.configs.starcoder2_3b``."""
import torch

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="starcoder2-3b",
        family="dense",
        num_layers=30,
        d_model=3072,
        num_heads=24,
        num_kv_heads=2,
        d_ff=12288,
        vocab_size=49152,
        qkv_bias=True,
        attn_out_bias=True,
        sliding_window=4096,
        act="gelu",
        norm="layernorm",
        rope_theta=100_000.0,
        dtype=torch.bfloat16,
        source="arXiv:2402.19173",
    )
)
