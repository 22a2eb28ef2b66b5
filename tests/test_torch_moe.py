"""The port's MoE FFN (``models/moe.py``) against ``repro.models.moe.apply_moe``
on the CPU, on the same weights (the JAX initialiser's, carried across) and
the same inputs (numpy, from a seed).

Configs: ``reduced()`` deepseek-moe-16b (4 routed experts, top-2, one
shared) and llama4-scout-17b-a16e (4 experts, top-1, one shared), fp32;
sequences of one group (S = 64), two groups (S = 1024, G = 512) and one
ragged group (S = 600, not a multiple of 512); the published
capacity_factor 1.25 and 0.5, under which tokens are dropped.

Routing is an integer decision and is compared exactly: the experts each
token picks (``top_idx``, in order) and which of those choices kept a slot.
The JAX package does not return them, so ``jax_routing`` computes them with
the reference's own lines (its softmax, ``lax.top_k`` and cumsum capacity).
A token whose sorted probabilities have two neighbours among the first
k + 1 within 1e-6 is a near-tie, where fp32 rounding of the router may
legitimately pick either: the test counts them (in the assertion message)
and compares routing on the other tokens.  The output y is held at 1e-5,
the aux loss at 1e-6; one bf16 case at 0.05, the bf16 limit of
``tests/test_torch_decoder.py``.
"""
import dataclasses
import itertools
import math

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch.checkpoint.convert import tensor_from_numpy  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.models import moe  # noqa: E402

CPU = torch.device("cpu")
NEAR_TIE = 1e-6


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def configs(name, **changes):
    return (
        dataclasses.replace(jreduced(jget_config(name)), **changes),
        dataclasses.replace(reduced(get_config(name)), **changes),
    )


def layer(jcfg, seed, dtype=jnp.float32):
    jp = jmoe.init_moe(jax.random.PRNGKey(seed), jcfg, dtype)
    np_p = jax.tree.map(np.asarray, jp)
    port = {k: ({kk: tensor_from_numpy(vv, CPU) for kk, vv in v.items()} if isinstance(v, dict)
                else tensor_from_numpy(v, CPU)) for k, v in np_p.items()}
    return jp, port


def jax_routing(cfg, p, x):
    """``top_idx`` (B, ng, G, k), the kept mask over experts (B, ng, G, E)
    and the probabilities, by the lines of ``repro.models.moe.apply_moe``."""
    B, S, d = x.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    G = min(512, S)
    if S % G:
        G = S
    C = min(max(1, int(math.ceil(k * G / E * cfg.capacity_factor))), G)
    logits = x.reshape(B, S // G, G, d).astype(jnp.float32) @ p["router"]
    probs = jax.nn.softmax(logits, axis=-1)
    _, top_idx = jax.lax.top_k(probs, k)
    mask = jnp.sum(jax.nn.one_hot(top_idx, E, dtype=jnp.float32), axis=-2)
    pos_in_exp = jnp.cumsum(mask, axis=2) * mask - 1.0
    keep = (pos_in_exp >= 0) & (pos_in_exp < C)
    return np.asarray(top_idx), np.asarray(keep), np.asarray(probs)


def kept_over_experts(r, E):
    """The port's per-choice keep (B, ng, G, k) as a mask over experts."""
    out = torch.zeros(*r.keep.shape[:-1], E, dtype=torch.bool)
    return out.scatter_(-1, r.top_idx, r.keep).numpy()


def near_ties(probs, k):
    """(B, ng, G) True where two neighbours of the first k + 1 sorted
    probabilities lie within NEAR_TIE."""
    top = -np.sort(-probs, axis=-1)[..., : k + 1]
    return (np.abs(np.diff(top, axis=-1)) < NEAR_TIE).any(axis=-1)


CASES = [
    ("deepseek-moe-16b", 64, 1.25),
    ("deepseek-moe-16b", 1024, 1.25),
    ("deepseek-moe-16b", 600, 1.25),
    ("deepseek-moe-16b", 1024, 0.5),
    ("llama4-scout-17b-a16e", 64, 1.25),
    ("llama4-scout-17b-a16e", 1024, 1.25),
    ("llama4-scout-17b-a16e", 600, 1.25),
    ("llama4-scout-17b-a16e", 1024, 0.5),
]


@pytest.mark.parametrize("name,s,cf", CASES, ids=[f"{n.split('-')[0]}-S{s}-cf{cf}" for n, s, cf in CASES])
def test_apply_moe_matches_reference(name, s, cf):
    jcfg, cfg = configs(name, capacity_factor=cf)
    jp, p = layer(jcfg, seed=s)
    x = np.random.default_rng(s).standard_normal((2, s, cfg.d_model)).astype(np.float32)
    want_y, want_aux = jax.jit(lambda p_, x_: jmoe.apply_moe(jcfg, p_, x_))(jp, jnp.asarray(x))
    y, aux = moe.apply_moe(cfg, p, torch.from_numpy(x))
    r = moe.route(cfg, p, torch.from_numpy(x))
    top_idx, keep, probs = jax_routing(jcfg, jp, jnp.asarray(x))
    G, ng, C = moe.group_shape(cfg, s)
    assert (r.G, r.ng, r.C) == (G, ng, C) == (top_idx.shape[2], top_idx.shape[1], C)
    assert ng == (2 if s == 1024 else 1)
    ties = near_ties(probs, cfg.experts_per_token)
    off = ~ties
    assert np.array_equal(r.top_idx.numpy()[off], top_idx[off]), f"{ties.sum()} near-tie tokens"
    assert np.array_equal(kept_over_experts(r, cfg.num_experts)[off], keep[off]), f"{ties.sum()} near-tie tokens"
    dropped = 1.0 - keep.sum() / (keep.shape[0] * keep.shape[1] * keep.shape[2] * cfg.experts_per_token)
    assert cf >= 1.0 or dropped > 0.25, dropped  # below capacity, drops must happen
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(aux.item(), float(want_aux), rtol=1e-6, atol=1e-6)


def test_apply_moe_matches_reference_in_bf16():
    """bf16 weights and inputs, the router in fp32: within 0.05."""
    jcfg, cfg = configs("deepseek-moe-16b", dtype=jnp.bfloat16)
    cfg = dataclasses.replace(cfg, dtype=torch.bfloat16)
    jp, p = layer(jcfg, seed=5, dtype=jnp.bfloat16)
    assert p["router"].dtype == torch.float32 and p["w_gate"].dtype == torch.bfloat16
    x = jnp.asarray(np.random.default_rng(5).standard_normal((2, 96, cfg.d_model)), jnp.bfloat16)
    want_y, want_aux = jax.jit(lambda p_, x_: jmoe.apply_moe(jcfg, p_, x_))(jp, x)
    y, aux = moe.apply_moe(cfg, p, tensor_from_numpy(np.asarray(x), CPU))
    assert y.dtype == torch.bfloat16
    np.testing.assert_allclose(y.float().numpy(), np.asarray(want_y, np.float32), rtol=0.05, atol=0.05)
    np.testing.assert_allclose(aux.item(), float(want_aux), rtol=1e-5)


def test_top_k_takes_the_lower_index_on_a_tie():
    """Exact ties go to the lower expert index, as ``lax.top_k``: a router
    of zeros gives every expert probability 1/E."""
    _, cfg = configs("deepseek-moe-16b")
    _, p = layer(configs("deepseek-moe-16b")[0], seed=1)
    p = {**p, "router": torch.zeros_like(p["router"])}
    r = moe.route(cfg, p, torch.randn(1, 8, cfg.d_model))
    assert r.top_idx.tolist() == [[[[0, 1]] * 8]]
    assert torch.allclose(r.top_vals, torch.full_like(r.top_vals, 0.5))


def test_capacity_goes_in_token_order():
    """Capacity C = 1 (capacity_factor 0.25, 8 tokens, top-2 of 4): each
    expert keeps only the first token that picked it."""
    _, cfg = configs("deepseek-moe-16b", capacity_factor=0.25)
    _, p = layer(configs("deepseek-moe-16b")[0], seed=2)
    x = torch.randn(1, 8, cfg.d_model, generator=torch.Generator().manual_seed(3))
    r = moe.route(cfg, p, x)
    assert r.C == 1
    first = {}
    for t in range(8):
        for j in range(2):
            e = r.top_idx[0, 0, t, j].item()
            assert r.keep[0, 0, t, j].item() == (e not in first)
            first.setdefault(e, t)


def test_decode_token_is_never_dropped():
    """One token (G = 1, C = 1): all k choices kept, whatever the capacity factor."""
    _, cfg = configs("deepseek-moe-16b", capacity_factor=0.01)
    _, p = layer(configs("deepseek-moe-16b")[0], seed=4)
    r = moe.route(cfg, p, torch.randn(3, 1, cfg.d_model))
    assert (r.G, r.ng, r.C) == (1, 1, 1) and r.keep.all()


def test_init_moe_shapes_and_router_dtype():
    _, cfg = configs("llama4-scout-17b-a16e", dtype=torch.bfloat16)
    p = moe.init_moe(torch.Generator().manual_seed(0), cfg, torch.bfloat16)
    E, d, ff = cfg.num_experts, cfg.d_model, cfg.d_ff
    assert p["router"].dtype == torch.float32 and p["router"].shape == (d, E)
    assert p["w_gate"].shape == p["w_up"].shape == (E, d, ff) and p["w_down"].shape == (E, ff, d)
    assert p["shared"]["w_gate"].shape == (d, ff * cfg.num_shared_experts)
    std = p["w_down"].float().std().item()
    assert abs(std * math.sqrt(ff) - 1.0) < 0.05


def test_combine_adds_in_fp32_and_rounds_once(monkeypatch):
    """bf16: each token's k expert outputs times its gates (rounded to bf16)
    are added in fp32 and rounded once, as XLA's bf16 einsum does; adding
    the k bf16 products in bf16 would round k times.  The expected output is
    built in float64 from the port's own routing and expert outputs (each
    bf16 x bf16 product is exact in fp32 and float64, and k = 2 terms add
    to the same fp32 sum either way), then rounded to fp32 and to bf16."""
    _, cfg = configs("deepseek-moe-16b", num_shared_experts=0)
    cfg = dataclasses.replace(cfg, dtype=torch.bfloat16)
    p = moe.init_moe(torch.Generator().manual_seed(6), cfg, torch.bfloat16)
    x = torch.randn(2, 96, cfg.d_model, generator=torch.Generator().manual_seed(7)).bfloat16()
    seen = {}
    experts = moe._experts
    monkeypatch.setattr(moe, "_experts", lambda p_, xe: seen.setdefault("ye", experts(p_, xe)))
    y, _ = moe.apply_moe(cfg, p, x)
    r = moe.route(cfg, p, x)
    ye = seen["ye"].reshape(cfg.num_experts, 2, r.ng, r.C, cfg.d_model).double()
    want = torch.zeros(2, r.ng, r.G, cfg.d_model, dtype=torch.float64)
    for b, g, t, j in itertools.product(range(2), range(r.ng), range(r.G), range(cfg.experts_per_token)):
        if r.keep[b, g, t, j]:
            gate = r.top_vals[b, g, t, j].to(torch.bfloat16).double()
            want[b, g, t] += gate * ye[r.top_idx[b, g, t, j], b, g, r.slot[b, g, t, j]]
    want = want.float().bfloat16().reshape(y.shape)
    assert torch.equal(y, want)
