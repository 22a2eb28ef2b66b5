"""DeepSeek-V2-Lite's two new layers on the card at published widths, bf16,
against the plain fp32 reference (``ehfl_bench/reference/deepseek_v2.py``)
on the same weights (the bf16 values, read as fp32) and the same inputs:
one MLA layer (16 heads, kv_lora_rank 512, q/k 128 + 64, v 128, YaRN) and
one expert layer (8 of 64 experts held, top-6 unnormalised, 2 shared), on
2 lanes (``torch.func.vmap``, each lane its own weights) x 2 sequences x
2048 tokens, forward, and the gradient of a fixed projection of each
lane's output.  No JAX: run with ``--noconftest``.

    python -m pytest --noconftest -q -m cuda tests/test_torch_deepseek_v2_gpu.py

Limits (each compared number is the largest absolute difference over the
largest absolute reference value; readings on an H100 80GB HBM3, 700 W):
the program rounds every product's output and the activations between
them to bf16 (8 bits of mantissa, 2^-9 relative), which alone gives
differences of a few 2^-9 of the largest value after a sum of thousands
of products; the limits are about twice the largest reading.  Tokens
whose 6th and 7th router probabilities lie within ``NEAR_TIE`` (1e-6) of
each other may take either expert on the two sides (the fp32 router sums
in another order); they are counted and left out of the expert layer's
comparison, as ``chip_smoke.py`` does.
"""
from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

import pytest
import torch
from torch.func import grad, vmap

ROOT = Path(__file__).resolve().parent.parent
for path in (str(ROOT), str(ROOT / "src")):
    if path not in sys.path:
        sys.path.insert(0, path)

pytestmark = pytest.mark.cuda

# (forward, gradient) limits, about twice the readings of an H100 80GB HBM3 at 700 W (PERF.md).
# MLA read 4.6e-3 / 5.1e-3 forward (two lanes) and 1.14e-2 for the worst leaf's gradient: the bf16 scores and
# probabilities of a 2048-token softmax, and each weight gradient summed over 4096 tokens in bf16 products
MLA_LIMITS = (1e-2, 2.5e-2)
# the expert layer read 5.9e-3 / 6.4e-3 forward and 9.5e-3 / 7.8e-3 for the gradients (2 and 3 near-ties of
# 4096 tokens): three bf16 products a row, the gates rounded to bf16 before the down projection's fp32 sum
MOE_LIMITS = (1.25e-2, 2e-2)
NEAR_TIE = 1e-6
LANES, BATCH, SEQ = 2, 2, 2048


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False


def _setup():
    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config("deepseek-v2-lite"), num_layers=5, experts_held=8, vocab_size=12_800)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(29)
    x = torch.randn(LANES, BATCH, SEQ, cfg.d_model, generator=g, device=dev).to(torch.bfloat16)
    proj = torch.randn(LANES, BATCH, SEQ, cfg.d_model, generator=g, device=dev).to(torch.bfloat16)
    return cfg, dev, g, x, proj


def _gap(got: torch.Tensor, want: torch.Tensor, keep: torch.Tensor | None = None) -> float:
    diff = (got.float() - want.float()).abs()
    if keep is not None:
        diff, want = diff[keep], want[keep]
    return (diff.max() / want.abs().max()).item()


def _reference(model_cfg):
    from ehfl_bench.reference.deepseek_v2 import DeepSeekV2

    c = model_cfg
    y = c.rope_scaling
    return DeepSeekV2({
        "hidden_size": c.d_model, "num_attention_heads": c.num_heads, "kv_lora_rank": c.kv_lora_rank,
        "qk_nope_head_dim": c.q_head_dim_nope, "qk_rope_head_dim": c.q_head_dim_rope, "v_head_dim": c.v_head_dim,
        "intermediate_size": c.dense_d_ff, "moe_intermediate_size": c.d_ff, "n_routed_experts": c.num_experts,
        "experts_held": c.experts_here, "expert_offset": c.expert_offset, "num_experts_per_tok": c.experts_per_token,
        "n_shared_experts": c.num_shared_experts, "first_k_dense_replace": c.first_dense_layers,
        "num_hidden_layers": c.num_layers, "vocab_size": c.vocab_size, "rms_norm_eps": c.norm_eps,
        "rope_theta": c.rope_theta, "norm_topk_prob": False, "routed_scaling_factor": 1,
        "seq_aux": True, "aux_loss_alpha": c.aux_weight,
        "rope_scaling": {"factor": y.factor, "original_max_position_embeddings": y.original_max_position,
                         "beta_fast": y.beta_fast, "beta_slow": y.beta_slow, "mscale": y.mscale,
                         "mscale_all_dim": y.mscale_all_dim}})


def test_mla_layer_against_the_reference():
    _needs_card()
    from repro_torch.models import attention

    cfg, dev, g, x, proj = _setup()
    ps = [attention.init_mla(g, cfg, torch.bfloat16) for _ in range(LANES)]
    flats = [{**{k: v for k, v in p.items() if k != "kv_norm"}, "kv_norm.scale": p["kv_norm"]["scale"]} for p in ps]
    stacked = {k: torch.stack([p[k] for p in flats]) for k in flats[0]}
    positions = torch.arange(SEQ, device=dev)

    def nest(f):
        return {"wq": f["wq"], "wkv_a": f["wkv_a"], "kv_norm": {"scale": f["kv_norm.scale"]}, "wkv_b": f["wkv_b"],
                "wo": f["wo"]}

    def out(f, xx):
        return attention.mla_forward(cfg, nest(f), xx, positions)

    def score(f, xx, pr):
        return (out(f, xx).float() * pr.float()).sum()

    y = vmap(out)(stacked, x)
    gw = vmap(grad(score), in_dims=(0, 0, 0))(stacked, x, proj)
    ref = _reference(cfg)
    fwd, bwd = [], []
    for j in range(LANES):
        leaves = {k: v.float().clone().requires_grad_(True) for k, v in flats[j].items()}
        want = ref._attention(leaves, "", x[j].float())
        fwd.append(_gap(y[j], want.detach()))
        gref = torch.autograd.grad((want * proj[j].float()).sum(), list(leaves.values()))
        bwd.append(max(_gap(gw[k][j], gr) for k, gr in zip(leaves, gref)))
        del leaves, want, gref
    print(f"MLA readings: forward {fwd}, gradient {bwd}")
    assert max(fwd) <= MLA_LIMITS[0] and max(bwd) <= MLA_LIMITS[1], (fwd, bwd)


def test_expert_layer_against_the_reference():
    _needs_card()
    from repro_torch.models import moe

    cfg, dev, g, x, proj = _setup()
    ps = [moe.init_moe(g, cfg, torch.bfloat16) for _ in range(LANES)]
    flats = [{**{k: v for k, v in p.items() if k != "shared"}, **{f"shared.{k}": v for k, v in p["shared"].items()}}
             for p in ps]
    stacked = {k: torch.stack([f[k] for f in flats]) for k in flats[0]}

    def nest(f):
        return {**{k: f[k] for k in ("router", "w_gate", "w_up", "w_down")},
                "shared": {k: f[f"shared.{k}"] for k in ("w_gate", "w_up", "w_down")}}

    def out(f, xx):
        return moe.apply_moe(cfg, nest(f), xx)[0]

    def score(f, xx, pr):
        return (out(f, xx).float() * pr.float()).sum()

    y = vmap(out)(stacked, x)
    gw = vmap(grad(score))(stacked, x, proj)
    ref = _reference(cfg)
    fwd, bwd, ties = [], [], []
    for j in range(LANES):
        xf = x[j].float()
        probs = torch.softmax(xf.reshape(-1, cfg.d_model) @ flats[j]["router"], dim=-1)
        top = torch.sort(probs, dim=-1, descending=True).values[:, : cfg.experts_per_token + 1]
        tie = ((top[:, :-1] - top[:, 1:]).min(dim=-1).values < NEAR_TIE).reshape(BATCH, SEQ)
        ties.append(int(tie.sum()))
        leaves = {k: v.float().clone().requires_grad_(True) for k, v in flats[j].items()}
        want, _ = ref._experts(leaves, "", xf)
        fwd.append(_gap(y[j], want.detach(), ~tie))
        # a near-tie token's own row is left out of the forward; the gradients sum over tokens, so
        # its weight (its gate, the 6th largest) is at most a few per cent of a token's part in them
        gref = torch.autograd.grad((want * proj[j].float()).sum(), list(leaves.values()))
        bwd.append(max(_gap(gw[k][j], gr) for k, gr in zip(leaves, gref)))
        del leaves, want, gref
    print(f"expert layer readings: forward {fwd}, gradient {bwd}, near-ties {ties} of {BATCH * SEQ} tokens a lane")
    assert max(fwd) <= MOE_LIMITS[0] and max(bwd) <= MOE_LIMITS[1], (fwd, bwd, ties)
