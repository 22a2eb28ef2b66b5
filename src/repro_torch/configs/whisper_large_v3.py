"""Whisper-large-v3 [arXiv:2212.04356] — enc-dec transformer; mel+conv frontend STUBBED
(the caller provides (B, 1500, d_model) frame embeddings — the carve-out).
The port's own copy of ``repro.configs.whisper_large_v3``."""
import torch

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="whisper-large-v3",
        family="audio",
        num_layers=32,  # decoder layers
        num_encoder_layers=32,
        is_encoder_decoder=True,
        encoder_seq=1500,
        d_model=1280,
        num_heads=20,
        num_kv_heads=20,
        d_ff=5120,
        vocab_size=51866,
        use_rope=False,  # learned absolute positions
        act="gelu",
        norm="layernorm",
        qkv_bias=True,
        attn_out_bias=True,
        dtype=torch.bfloat16,
        source="arXiv:2212.04356",
    )
)
