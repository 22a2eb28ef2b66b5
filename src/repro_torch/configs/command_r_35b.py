"""Command-R 35B [hf:CohereForAI/c4ai-command-r-v01] — dense GQA, no bias, layernorm.
The port's own copy of ``repro.configs.command_r_35b``."""
import torch

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="command-r-35b",
        family="dense",
        num_layers=40,
        d_model=8192,
        num_heads=64,
        num_kv_heads=8,
        d_ff=22528,
        vocab_size=256000,
        norm="layernorm",
        tie_embeddings=True,
        rope_theta=8_000_000.0,
        dtype=torch.bfloat16,
        source="hf:CohereForAI/c4ai-command-r-v01",
    )
)
