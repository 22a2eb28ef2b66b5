"""Qwen1.5-0.5B [hf:Qwen/Qwen1.5-0.5B] — dense, QKV bias.
The port's own copy of ``repro.configs.qwen1_5_0_5b``."""
import torch

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="qwen1.5-0.5b",
        family="dense",
        num_layers=24,
        d_model=1024,
        num_heads=16,
        num_kv_heads=16,
        d_ff=2816,
        vocab_size=151936,
        qkv_bias=True,
        tie_embeddings=True,
        rope_theta=1_000_000.0,
        dtype=torch.bfloat16,
        source="hf:Qwen/Qwen1.5-0.5B",
    )
)
