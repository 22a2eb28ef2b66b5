"""DeepSeekMoE-16B [arXiv:2401.06066] — fine-grained MoE, 2 shared + 64 routed top-6.
The port's own copy of ``repro.configs.deepseek_moe_16b``."""
import torch

from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="deepseek-moe-16b",
        family="moe",
        num_layers=28,
        d_model=2048,
        num_heads=16,
        num_kv_heads=16,
        d_ff=1408,
        vocab_size=102400,
        num_experts=64,
        num_shared_experts=2,
        experts_per_token=6,
        moe_period=1,
        rope_theta=10_000.0,
        dtype=torch.bfloat16,
        source="arXiv:2401.06066",
    )
)
