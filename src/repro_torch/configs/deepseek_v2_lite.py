"""DeepSeek-V2-Lite [hf:deepseek-ai/DeepSeek-V2-Lite; arXiv:2405.04434]:
27 layers, multi-head latent attention without a q-LoRA (kv_lora_rank
512, q/k nope 128 + rope 64, v 128), YaRN (factor 40 over 4096 positions),
layer 0 dense (MLP 10,944 wide), then DeepSeekMoE layers: 64 routed
experts of width 1408 scored by a softmax over all 64, top-6 with the
gates not renormalised, 2 shared experts, no dropped token, the balance
term per sequence.  The port's own arch: the JAX package has no MLA.
``aux_weight`` is the released code's ``aux_loss_alpha`` (0.001), which
the published config.json does not carry."""
import torch

from repro_torch.configs.base import ModelConfig, YaRN, register

CONFIG = register(
    ModelConfig(
        name="deepseek-v2-lite",
        family="moe",
        num_layers=27,
        d_model=2048,
        num_heads=16,
        num_kv_heads=16,
        head_dim=192,
        d_ff=1408,
        vocab_size=102400,
        num_experts=64,
        num_shared_experts=2,
        experts_per_token=6,
        moe_period=1,
        experts_held=64,  # all of them: the uncut layer
        aux_weight=0.001,
        first_dense_layers=1,
        dense_d_ff=10944,
        kv_lora_rank=512,
        q_head_dim_nope=128,
        q_head_dim_rope=64,
        v_head_dim=128,
        rope_theta=10_000.0,
        rope_scaling=YaRN(factor=40.0, original_max_position=4096, beta_fast=32.0, beta_slow=1.0, mscale=0.707,
                          mscale_all_dim=0.707),
        norm_eps=1e-6,
        dtype=torch.bfloat16,
        source="hf:deepseek-ai/DeepSeek-V2-Lite; arXiv:2405.04434",
    )
)
