"""Llama-4-Scout-17B-16E [hf:meta-llama/Llama-4-Scout-17B-16E] — MoE 16e top-1, early fusion.
The port's own copy of ``repro.configs.llama4_scout_17b_a16e``."""
import torch

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="llama4-scout-17b-a16e",
        family="moe",
        num_layers=48,
        d_model=5120,
        num_heads=40,
        num_kv_heads=8,
        d_ff=8192,
        vocab_size=202048,
        num_experts=16,
        num_shared_experts=1,
        experts_per_token=1,
        moe_period=1,
        rope_theta=500_000.0,
        dtype=torch.bfloat16,
        source="hf:meta-llama/Llama-4-Scout-17B-16E",
    )
)
