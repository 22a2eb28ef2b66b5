"""DeepSeek-V2-Lite in the port against the plain fp32 reference
(``ehfl_bench/reference/deepseek_v2.py``, which imports nothing of the
port), on the CPU at a tiny size: 1 dense + 2 expert layers, latent
attention with YaRN, 16 routed experts of which 4 are held (experts 4-7),
top-3 with the gates not renormalised, 2 shared experts.

Tolerances: the two compute the same fp32 function in different orders
(the port rotates the rope pairs in place and sums the held experts in one
product; the reference loops over experts and gathers their tokens), so
logits and the loss agree to 1e-5 of their largest value and gradients to
1e-4 of the largest gradient element (a backward sums over more terms).
Routing is exact here: no token's 3rd and 4th router probabilities lie
within fp32 rounding of each other on these seeds (the test counts them
and would fail on one, rather than leave it out).

Also: YaRN's frequencies and scale against hand values; the share test
(the four 4-expert shares, the shared experts counted once, add up to the
uncut layer); each of ``ehfl_bench/faults_lm.py``'s faults moves the
output beyond the tolerance; deepseek-moe-16b, llama4-scout and jamba keep
their bits (hashes of their outputs taken from the code path before this
arch was added); the expert-row counter against hand counts.
"""
from __future__ import annotations

import dataclasses
import hashlib
import math
import sys
from pathlib import Path

import pytest
import torch
from torch.func import vmap

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from ehfl_bench import faults_lm  # noqa: E402
from ehfl_bench.reference import deepseek_v2 as ref_lib  # noqa: E402
from repro_torch.configs import YaRN, get_config, list_configs, reduced  # noqa: E402
from repro_torch.fl.backend import lm_backend  # noqa: E402
from repro_torch.models import attention, decoder, moe  # noqa: E402
from repro_torch.models.common import yarn_inv_freq, yarn_mscale  # noqa: E402

Y_RTOL, GRAD_RTOL, NEAR_TIE = 1e-5, 1e-4, 1e-6
TINY = dataclasses.replace(
    reduced(get_config("deepseek-v2-lite")), num_layers=3, d_model=64, num_heads=2, num_kv_heads=2, head_dim=16,
    kv_lora_rank=16, q_head_dim_nope=8, q_head_dim_rope=8, v_head_dim=8, d_ff=32, dense_d_ff=96, vocab_size=256,
    num_experts=16, experts_held=4, expert_offset=4, experts_per_token=3, num_shared_experts=2)
S = 64


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def ref_model(cfg) -> dict:
    """The reference's ``model`` section (the released config.json's names) of a port config."""
    y = cfg.rope_scaling
    return {"hidden_size": cfg.d_model, "num_attention_heads": cfg.num_heads, "kv_lora_rank": cfg.kv_lora_rank,
            "qk_nope_head_dim": cfg.q_head_dim_nope, "qk_rope_head_dim": cfg.q_head_dim_rope,
            "v_head_dim": cfg.v_head_dim, "intermediate_size": cfg.dense_d_ff, "moe_intermediate_size": cfg.d_ff,
            "n_routed_experts": cfg.num_experts, "experts_held": cfg.experts_here, "expert_offset": cfg.expert_offset,
            "num_experts_per_tok": cfg.experts_per_token, "n_shared_experts": cfg.num_shared_experts,
            "first_k_dense_replace": cfg.first_dense_layers, "num_hidden_layers": cfg.num_layers,
            "vocab_size": cfg.vocab_size, "rms_norm_eps": cfg.norm_eps, "rope_theta": cfg.rope_theta,
            "rope_scaling": {"factor": y.factor, "original_max_position_embeddings": y.original_max_position,
                             "beta_fast": y.beta_fast, "beta_slow": y.beta_slow, "mscale": y.mscale,
                             "mscale_all_dim": y.mscale_all_dim},
            "norm_topk_prob": False, "routed_scaling_factor": 1, "seq_aux": True,
            "aux_loss_alpha": cfg.aux_weight}


def params(cfg=TINY, seed=0):
    return decoder.flat_params(decoder.init_params(cfg, seed, "cpu"))


def tokens(batch=2, seed=1, cfg=TINY):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, cfg.vocab_size, (batch, S), generator=g)


def close(got, want, rtol):
    scale = want.abs().max().item()
    return (got - want).abs().max().item() <= rtol * scale


def near_ties(cfg, p, toks) -> int:
    """Tokens whose k-th and (k+1)-th router probabilities lie within
    NEAR_TIE, in any expert layer (from the reference's own forward)."""
    ref = ref_lib.DeepSeekV2(ref_model(cfg))
    count, orig = 0, ref._experts

    def spy(pp, pre, x):
        nonlocal count
        probs = torch.softmax(x.reshape(-1, x.shape[-1]) @ pp[pre + "router"], dim=-1)
        top = torch.sort(probs, dim=-1, descending=True).values[:, : cfg.experts_per_token + 1]
        count += int(((top[:, :-1] - top[:, 1:]).min(dim=-1).values < NEAR_TIE).sum())
        return orig(pp, pre, x)

    ref._experts = spy
    with torch.no_grad():
        ref.logits(p, toks)
    return count


def test_registered_and_sized():
    assert "deepseek-v2-lite" in list_configs()
    full = get_config("deepseek-v2-lite")
    assert full.param_count() == 15_706_482_176  # 15.7 B, as published
    cut = dataclasses.replace(full, num_layers=5, experts_held=8, vocab_size=12_800)
    assert cut.param_count() + full.d_model == 535_060_992  # the benchmark's cut, with the final norm
    assert [cut.layer_moe(i) for i in range(5)] == [False, True, True, True, True]
    assert cut.mlp_width(0) == 10_944


def test_yarn_against_hand_values():
    y = get_config("deepseek-v2-lite").rope_scaling
    inv = yarn_inv_freq(64, 10_000.0, y)
    base = 1.0 / 10_000.0 ** (torch.arange(0, 64, 2, dtype=torch.float32) / 64)
    # correction dims: 64 ln(4096 / (32 * 2 pi)) / (2 ln 1e4) = 10.47 -> 10;
    # 64 ln(4096 / 2 pi) / (2 ln 1e4) = 22.51 -> 23
    assert torch.equal(inv[:11], base[:11]) and torch.allclose(inv[23:], base[23:] / 40, rtol=1e-6)
    ramp = (16 - 10) / 13
    assert inv[16].item() == pytest.approx(base[16].item() * (ramp / 40 + 1 - ramp), rel=1e-6)
    assert yarn_mscale(40.0, 0.707) == pytest.approx(1 + 0.0707 * math.log(40), rel=1e-12)
    assert attention.mla_softmax_scale(get_config("deepseek-v2-lite")) == pytest.approx(1.589625 / math.sqrt(192),
                                                                                          rel=1e-5)
    ref = ref_lib.yarn_inv_freq(64, 10_000.0, ref_model(get_config("deepseek-v2-lite"))["rope_scaling"])
    assert torch.allclose(inv, ref, rtol=1e-6, atol=0)


def test_logits_and_loss_match_the_reference():
    p, toks = params(), tokens()
    assert near_ties(TINY, p, toks) == 0
    ref = ref_lib.DeepSeekV2(ref_model(TINY))
    with torch.no_grad():
        logits, aux = decoder.forward_logits(TINY, decoder.nest_params(p), toks)
        want, want_aux = ref.logits(p, toks)
        loss, _ = decoder.loss_fn(TINY, decoder.nest_params(p), {"tokens": toks, "labels": toks},
                                  aux_weight=TINY.aux_weight)
    assert close(logits, want, Y_RTOL)
    assert aux.item() == pytest.approx(want_aux.item(), rel=Y_RTOL)
    assert loss.item() == pytest.approx(ref.loss(p, toks).item(), rel=Y_RTOL)


def test_per_lane_gradients_under_vmap_match_the_reference():
    p0, p1 = params(seed=0), params(seed=5)
    toks = torch.stack([tokens(seed=2), tokens(seed=3)]).float()
    lanes = {k: torch.stack([p0[k], p1[k]]) for k in p0}
    loss, grads = vmap(lm_backend(TINY).grad_loss)(lanes, toks, toks)
    ref = ref_lib.DeepSeekV2(ref_model(TINY))
    for j, p in enumerate((p0, p1)):
        assert near_ties(TINY, p, toks[j].long()) == 0
        leaves = {k: v.clone().requires_grad_(True) for k, v in p.items()}
        want_loss = ref.loss(leaves, toks[j])
        want = dict(zip(leaves, torch.autograd.grad(want_loss, list(leaves.values()))))
        assert loss[j].item() == pytest.approx(want_loss.item(), rel=Y_RTOL)
        top = max(g.abs().max().item() for g in want.values())
        worst = max((grads[k][j] - want[k]).abs().max().item() for k in want)
        assert worst <= GRAD_RTOL * top, worst / top
        assert all(want[k].abs().max() > 0 for k in want if "moe.w_" in k)  # every held expert got tokens


def test_feature_taps_match_the_reference():
    p = params()
    toks = torch.stack([tokens(seed=4), tokens(seed=6), tokens(seed=8)])  # (N, b, S)
    ref = ref_lib.DeepSeekV2(ref_model(TINY))
    with torch.no_grad():
        want = ref.probe(p, toks)
        one = decoder.feature_vector(TINY, decoder.nest_params(p), toks[1])
        many = decoder.feature_vectors(TINY, decoder.nest_params(p), toks, use_kernel=True)
    assert close(one, ref.feature(p, toks[1]), Y_RTOL)
    assert close(many, want, Y_RTOL) and close(many[1], one, Y_RTOL)


def test_the_shares_add_up_to_the_uncut_layer():
    """Four chips of 4 experts each: their routed parts, plus the shared
    experts once, are the uncut 16-expert layer's output."""
    full = dataclasses.replace(TINY, experts_held=16, expert_offset=0)
    g = torch.Generator().manual_seed(11)
    p = moe.init_moe(g, full, torch.float32)
    x = torch.randn(2, S, TINY.d_model, generator=g)
    with torch.no_grad():
        whole, aux = moe.apply_moe(full, p, x)
        shared = moe.apply_mlp(p["shared"], x, "silu")
        parts = []
        for lo in range(0, 16, 4):
            cut = dataclasses.replace(TINY, experts_held=4, expert_offset=lo)
            share = {**p, **{k: p[k][lo : lo + 4] for k in ("w_gate", "w_up", "w_down")}}
            y, a = moe.apply_moe(cut, share, x)
            assert a.item() == aux.item()  # the balance term reads the whole router on every chip
            parts.append(y - shared)
        assert close(sum(parts) + shared, whole, Y_RTOL)
        m = ref_model(full)
        ref = ref_lib.DeepSeekV2(m)
        flat = {"l.router": p["router"], **{f"l.{k}": p[k] for k in ("w_gate", "w_up", "w_down")},
                **{f"l.shared.{k}": v for k, v in p["shared"].items()}}
        want, want_aux = ref._experts(flat, "l.", x)
    assert close(whole, want, Y_RTOL) and aux.item() == pytest.approx(want_aux.item(), rel=Y_RTOL)
    assert all(part.abs().max() > 0 for part in parts)


@pytest.mark.parametrize("fault", sorted(faults_lm.FAULTS))
def test_each_planted_fault_moves_the_output(fault):
    p, toks = params(), tokens(batch=4)
    with torch.no_grad():
        want, _ = ref_lib.DeepSeekV2(ref_model(TINY)).logits(p, toks)
        _, on_epoch = faults_lm.FAULTS[fault]
        faulty = on_epoch(lambda carry, t, draws: decoder.forward_logits(TINY, decoder.nest_params(p), toks)[0])
        got = faulty(None, 0, None)
        clean, _ = decoder.forward_logits(TINY, decoder.nest_params(p), toks)
    assert close(clean, want, Y_RTOL)  # the fault is gone after its epoch
    assert not close(got, want, Y_RTOL), fault


# Outputs of the code path before DeepSeek-V2 was added (reduced(), fp32,
# weights seed 3, tokens seed 7, two lanes of (2, 48) tokens): each lane's
# loss as float.hex, and the first 16 hex digits of the SHA-256 of the
# lanes' gradients (sorted leaves), of the probe's features, of lane 0's
# logits, and the aux loss.
KEPT = {
    "deepseek-moe-16b": (["0x1.96d21a0000000p+2", "0x1.92db3e0000000p+2"], "07ebf0994acc2c0c", "7613093bc5e6445a",
                         "b517f0ff648f0878", "0x1.342bf80000000p+1"),
    "llama4-scout-17b-a16e": (["0x1.944c4e0000000p+2", "0x1.94c5a20000000p+2"], "16f43f144d4e5074",
                              "61760a8a671dae89", "d2e1d834e94a4e2e", "0x1.50aa0c0000000p+1"),
    "jamba-v0.1-52b": (["0x1.9509200000000p+2", "0x1.95b3ca0000000p+2"], "317c5cdb69e821d4", "daaae6b184d722cf",
                       "b447163f769633f0", "0x1.0a85a00000000p+0"),
}


@pytest.mark.parametrize("arch", sorted(KEPT))
def test_other_routed_archs_keep_their_bits(arch):
    c = reduced(get_config(arch))
    p = decoder.flat_params(decoder.init_params(c, 3, "cpu"))
    toks = torch.randint(0, c.vocab_size, (2, 2, 48), generator=torch.Generator().manual_seed(7)).float()
    b = lm_backend(c)
    loss, grads = vmap(b.grad_loss)({k: torch.stack([v, v * 1.01]) for k, v in p.items()}, toks, toks)
    h = hashlib.sha256()
    for k in sorted(grads):
        h.update(grads[k].detach().contiguous().numpy().tobytes())
    digest = lambda t: hashlib.sha256(t.detach().numpy().tobytes()).hexdigest()[:16]
    logits, aux = decoder.forward_logits(c, decoder.nest_params(p), toks[0].long())
    got = ([float(x).hex() for x in loss], h.hexdigest()[:16], digest(b.probe(p, toks)), digest(logits),
           float(aux).hex())
    assert got == KEPT[arch]


def test_the_row_counter_against_hand_counts():
    g = torch.Generator().manual_seed(2)
    x = torch.randn(2, S, TINY.d_model, generator=g)
    p = moe.init_moe(g, TINY, torch.float32)
    moe.reset_counts()
    moe.apply_moe(TINY, p, x)
    assert moe.COUNTS == {"rows": 4 * 2 * S, "tokens": 2 * S}  # every held expert over every token
    vmap(lambda xx: moe.apply_moe(TINY, p, xx)[0])(torch.stack([x, x]))
    assert moe.COUNTS == {"rows": 2 * 4 * 2 * S, "tokens": 2 * 2 * S}  # vmap shows the call one lane
    old = reduced(get_config("deepseek-moe-16b"))  # 4 experts, top-2: capacity ceil(2 * 64 / 4 * 1.25) = 40
    q = moe.init_moe(g, old, torch.float32)
    moe.reset_counts()
    moe.apply_moe(old, q, torch.randn(2, S, old.d_model, generator=g))
    assert moe.COUNTS == {"rows": 4 * 2 * 40, "tokens": 2 * S}


def test_serving_mla_is_refused():
    with pytest.raises(NotImplementedError, match="latent"):
        decoder.init_cache(TINY, 1, 8, device="cpu")


def test_yarn_config_is_frozen_and_hashable():
    y = YaRN(factor=40.0, original_max_position=4096)
    assert hash(dataclasses.replace(TINY, rope_scaling=y)) is not None
