"""InternVL2-2B [arXiv:2404.16821] — InternViT (stubbed frontend) + InternLM2 backbone.
The port's own copy of ``repro.configs.internvl2_2b``."""
import torch

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="internvl2-2b",
        family="vlm",
        num_layers=24,
        d_model=2048,
        num_heads=16,
        num_kv_heads=8,
        d_ff=8192,
        vocab_size=92553,
        num_prefix_tokens=256,  # ViT patch embeddings after pixel-unshuffle+projector (stub)
        rope_theta=1_000_000.0,
        dtype=torch.bfloat16,
        source="arXiv:2404.16821",
    )
)
