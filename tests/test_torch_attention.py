"""The port's attention family against the JAX package's, on the CPU.

Inputs are made with numpy from a seed and given to both packages.  On the
CPU the port's ``kernels.ops.swa_attention`` runs its plain version,
``kernels.ref.swa_attention_ref``; it is held to the Pallas kernel in
interpret mode and to the JAX oracle over ``tests/test_kernels.py``'s sweep
at that file's tolerances (fp32 2e-5; bf16 0.05, where both sides round the
same bf16 inputs and outputs but sum in another order).  RoPE and the MLP
are held to JAX at 1e-6 (fp32 elementwise work and one small matmul);
``attn_forward`` (both routes) and ``attn_decode`` (linear and rolling) at
1e-4 in fp32, as ``tests/test_models.py`` holds the JAX routes to each
other.  The attention tests use reduced(starcoder2-3b) with 2 KV heads for
its 4 query heads, so that a wrong GQA head mapping (h % Hkv for h // g)
shows, and S longer than the window, so that an off-by-one in the window
shows.  The Hopper kernel itself is tested in ``tests/test_torch_swa_gpu.py``.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.swa_attention import swa_attention as jswa_attention  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro_torch.checkpoint.convert import tensor_from_numpy  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import attention, common  # noqa: E402

CPU = torch.device("cpu")
FP32_TOL = 1e-4


def qkv(b, h, s, d, hkv=None, seed=0):
    """numpy fp32 q (b, h, s, d) and k, v (b, hkv, s, d), standard normal."""
    rng = np.random.default_rng(seed)
    hkv = hkv or h
    return (
        rng.standard_normal((b, h, s, d), dtype=np.float32),
        rng.standard_normal((b, hkv, s, d), dtype=np.float32),
        rng.standard_normal((b, hkv, s, d), dtype=np.float32),
    )


def both(arrays, dtype):
    """The same arrays for JAX and for torch, in ``dtype`` on both sides."""
    jd, td = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    return [jnp.asarray(a).astype(jd) for a in arrays], [torch.from_numpy(a.copy()).to(td) for a in arrays]


def assert_close(t, j, tol):
    np.testing.assert_allclose(t.detach().float().numpy(), np.asarray(j, np.float32), rtol=tol, atol=tol)


@pytest.mark.parametrize(
    "b,h,s,d,window",
    [
        (1, 2, 128, 64, 0),
        (2, 2, 256, 64, 64),
        (1, 1, 200, 32, 48),  # padded S
        (1, 2, 512, 128, 128),
        (2, 1, 128, 64, 16),
    ],
)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_swa_ref_matches_pallas_and_oracle(b, h, s, d, window, dtype):
    jin, tin = both(qkv(b, h, s, d), dtype)
    got = ops.swa_attention(*tin, window=window)
    assert got.shape == (b, h, s, d) and got.dtype == tin[0].dtype
    tol = 2e-5 if dtype == "float32" else 0.05
    for want in (
        jswa_attention(*jin, window=window, block_q=64, block_k=64, interpret=True),
        jref.swa_attention_ref(*jin, window=window),
    ):
        assert_close(got, want, tol)


@pytest.mark.parametrize("h,hkv", [(4, 2), (6, 2), (4, 1), (6, 3)])
@pytest.mark.parametrize("window", [0, 5, 40])
def test_swa_ref_gqa_equals_repeated_kv(h, hkv, window):
    """K/V at Hkv heads equal the Hkv = H form with each KV head repeated for
    its group of H / Hkv consecutive query heads (query head h reads KV head
    h // (H / Hkv)), held to the JAX oracle."""
    q, k, v = qkv(2, h, 37, 32, hkv, seed=1)
    g = h // hkv
    got = ref.swa_attention_ref(*(torch.from_numpy(a) for a in (q, k, v)), window=window)
    want = jref.swa_attention_ref(*(jnp.asarray(a) for a in (q, np.repeat(k, g, 1), np.repeat(v, g, 1))), window=window)
    assert_close(got, want, 2e-5)
    q_small = torch.from_numpy(q[:, :hkv].copy())  # H = Hkv: the plain oracle, no grouping
    plain = ref.swa_attention_ref(q_small, torch.from_numpy(k), torch.from_numpy(v), window=window)
    assert_close(plain, jref.swa_attention_ref(*(jnp.asarray(a) for a in (q[:, :hkv], k, v)), window=window), 2e-5)


@pytest.mark.parametrize("window", [0, 48])
def test_swa_ref_noncausal_padded_follows_the_oracle(window):
    """Non-causal with S not a multiple of the block: the port follows the
    oracle.  The Pallas kernel pads S with zero keys and masks them only when
    causal, so it departs from its own oracle here (a fault of the reference,
    ROADMAP queue 3; no model path runs attention non-causal)."""
    jin, tin = both(qkv(1, 2, 200, 32, seed=2), "float32")
    got = ops.swa_attention(*tin, window=window, causal=False)
    assert_close(got, jref.swa_attention_ref(*jin, window=window, causal=False), 2e-5)
    pallas = jswa_attention(*jin, window=window, causal=False, block_q=64, block_k=64, interpret=True)
    assert np.abs(got.numpy() - np.asarray(pallas)).max() > 0.01


def test_apply_rope_matches():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 40, 3, 64), dtype=np.float32)
    pos = np.stack([np.arange(40), np.arange(100, 140)]).astype(np.int32)
    for theta in (10_000.0, 100_000.0):
        want = jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
        got = common.apply_rope(torch.from_numpy(x), torch.from_numpy(pos).long(), theta)
        assert_close(got, want, 1e-6)
    # the two halves rotate together: position 0 is the identity, and at
    # position 1 the first coordinate pairs with coordinate hd/2
    e = torch.zeros(1, 2, 1, 64)
    e[..., 0] = 1.0
    out = common.apply_rope(e, torch.tensor([[0, 1]]), 10_000.0)
    assert torch.equal(out[0, 0], e[0, 0])
    assert out[0, 1, 0, 32].item() == pytest.approx(np.sin(1.0), abs=1e-6) and out[0, 1, 0, 1].item() == 0.0


@pytest.mark.parametrize("act", ["gelu", "silu"])
def test_apply_mlp_matches(act):
    jp = jcommon.init_mlp(jax.random.PRNGKey(4), 48, 96, act, jnp.float32)
    x = np.random.default_rng(5).standard_normal((2, 7, 48), dtype=np.float32)
    want = jcommon.apply_mlp(jp, jnp.asarray(x), act)
    got = common.apply_mlp({k: tensor_from_numpy(v, CPU) for k, v in jp.items()}, torch.from_numpy(x), act)
    assert_close(got, want, 1e-6)


def configs(num_kv_heads=2):
    """reduced(starcoder2-3b) (4 heads of 64, window 64, fp32) for both
    packages, with ``num_kv_heads`` KV heads."""
    return (
        dataclasses.replace(jreduced(jget_config("starcoder2-3b")), num_kv_heads=num_kv_heads),
        dataclasses.replace(reduced(get_config("starcoder2-3b")), num_kv_heads=num_kv_heads),
    )


@pytest.fixture(scope="module")
def layer():
    """One attention layer's weights from the JAX initialiser, biases made
    nonzero (the initialiser zeroes them), carried across."""
    jcfg, cfg = configs()
    jp = dict(jattn.init_attn(jax.random.PRNGKey(6), jcfg, jnp.float32))
    rng = np.random.default_rng(7)
    for k in ("bq", "bk", "bv", "bo"):
        jp[k] = jp[k] + jnp.asarray(rng.standard_normal(jp[k].shape, dtype=np.float32) * 0.1)
    return jcfg, cfg, jp, {k: tensor_from_numpy(np.asarray(v), CPU) for k, v in jp.items()}


def test_reduced_config_exercises_window_and_groups():
    _, cfg = configs()
    base = reduced(get_config("starcoder2-3b"))
    assert base.sliding_window == 64 and base.num_heads // base.num_kv_heads > 1
    assert cfg.num_heads // cfg.num_kv_heads == 2 and cfg.head_dim == 64


@pytest.mark.parametrize("s", [64, 1536])  # 1536: the reference's q-chunked branch
@pytest.mark.parametrize("window", [0, 16, 64])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_attn_forward_matches(layer, s, window, use_kernel):
    jcfg, cfg, jp, p = layer
    assert (s > attention.CHUNK_THRESHOLD and s % attention.Q_CHUNK == 0) == (s == 1536)
    x = np.random.default_rng(8).standard_normal((2, s, cfg.d_model), dtype=np.float32) * 0.5
    pos = np.arange(s, dtype=np.int32)
    want = jax.jit(lambda p_, x_: jattn.attn_forward(jcfg, p_, x_, jnp.asarray(pos), window=window))(
        jp, jnp.asarray(x)
    )
    got = attention.attn_forward(
        cfg, p, torch.from_numpy(x), torch.from_numpy(pos).long(), window=window, use_kernel=use_kernel
    )
    assert got.shape == (2, s, cfg.d_model)
    assert_close(got, want, FP32_TOL)


def test_attn_forward_routes_agree_in_bf16(layer):
    """The two routes in bf16: the kernel route keeps scores and
    probabilities in fp32, the plain route rounds both to bf16."""
    _, cfg, _, p = layer
    cfg = dataclasses.replace(cfg, dtype=torch.bfloat16)
    pb = {k: v.bfloat16() for k, v in p.items()}
    x = torch.from_numpy(np.random.default_rng(9).standard_normal((1, 200, cfg.d_model), dtype=np.float32))
    x = (x * 0.5).bfloat16()
    pos = torch.arange(200)
    a, b = (attention.attn_forward(cfg, pb, x, pos, window=64, use_kernel=u) for u in (False, True))
    assert a.dtype == b.dtype == torch.bfloat16
    torch.testing.assert_close(a.float(), b.float(), rtol=0.05, atol=0.05)


@pytest.mark.parametrize("s", [12, 1024])  # 1024: the plain route's q-chunked branch
@pytest.mark.parametrize("use_kernel", [False, True])
def test_attn_forward_cross_attention_matches(layer, s, use_kernel, monkeypatch):
    """Cross-attention (queries over s decoder tokens, keys and values over
    40 encoder frames, no RoPE on them, no mask) against the JAX package's;
    the kernel route takes the plain form here, since no kernel computes
    it.  The cached form (``cross_kv`` once, ``cross_decode_cached`` per
    token) and ``attn_decode(encoder_out=...)`` give each token's row."""
    jcfg, cfg, jp, p = layer
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, s, cfg.d_model), dtype=np.float32) * 0.5
    enc = rng.standard_normal((2, 40, cfg.d_model), dtype=np.float32) * 0.5
    pos = np.arange(s, dtype=np.int32)
    want = jax.jit(lambda p_, x_, e_: jattn.attn_forward(jcfg, p_, x_, jnp.asarray(pos), encoder_out=e_))(
        jp, jnp.asarray(x), jnp.asarray(enc)
    )
    def no_kernel(*args, **kwargs):
        raise AssertionError("cross-attention reached swa_attention")

    monkeypatch.setattr(attention.kops, "swa_attention", no_kernel)
    got = attention.attn_forward(
        cfg, p, torch.from_numpy(x), torch.from_numpy(pos).long(), encoder_out=torch.from_numpy(enc),
        use_kernel=use_kernel,
    )
    assert got.shape == (2, s, cfg.d_model)
    assert_close(got, want, FP32_TOL)
    ck, cv = attention.cross_kv(cfg, p, torch.from_numpy(enc))
    jck, jcv = jattn.cross_kv(jcfg, jp, jnp.asarray(enc))
    assert_close(ck, jck, FP32_TOL)
    assert_close(cv, jcv, FP32_TOL)
    for t in (0, s - 1):
        xt = torch.from_numpy(x[:, t : t + 1])
        cached = attention.cross_decode_cached(cfg, p, xt, ck, cv)
        direct, cache = attention.attn_decode(cfg, p, xt, {}, torch.full((2,), t), encoder_out=torch.from_numpy(enc))
        assert cache == {}
        for y in (cached, direct):
            torch.testing.assert_close(y[:, 0], got[:, t], rtol=FP32_TOL, atol=FP32_TOL)


@pytest.mark.parametrize("rolling,width", [(False, 40), (True, 16)])
def test_attn_decode_matches(layer, rolling, width):
    """40 steps against a linear cache of 40, or a rolling cache of 16
    (wrapping twice and a half), output and cache held to JAX every step;
    the last step also equals the full-sequence forward with window
    ``width`` (rolling) or none (linear)."""
    jcfg, cfg, jp, p = layer
    B, steps = 2, 40
    x = np.random.default_rng(10).standard_normal((B, steps, cfg.d_model), dtype=np.float32) * 0.5
    jc = jattn.init_kv_cache(jcfg, B, width, jnp.float32)
    c = attention.init_kv_cache(cfg, B, width, torch.float32, CPU)
    jstep = jax.jit(lambda p_, x_, c_, pos_: jattn.attn_decode(jcfg, p_, x_, c_, pos_, rolling=rolling))
    for t in range(steps):
        xt = x[:, t : t + 1]
        pos = np.full((B,), t, np.int32)
        jy, jc = jstep(jp, jnp.asarray(xt), jc, jnp.asarray(pos))
        y, c = attention.attn_decode(cfg, p, torch.from_numpy(xt), c, torch.from_numpy(pos).long(), rolling=rolling)
        assert_close(y, jy, FP32_TOL)
        for k in ("k", "v"):
            assert_close(c[k], jc[k], FP32_TOL)
    full = attention.attn_forward(cfg, p, torch.from_numpy(x), torch.arange(steps), window=width if rolling else 0)
    torch.testing.assert_close(y[:, 0], full[:, -1], rtol=FP32_TOL, atol=FP32_TOL)


def test_attn_decode_leaves_the_old_cache():
    _, cfg = configs()
    g = torch.Generator().manual_seed(0)
    p = attention.init_attn(g, cfg, torch.float32)
    c = attention.init_kv_cache(cfg, 1, 8, torch.float32, CPU)
    _, new = attention.attn_decode(cfg, p, torch.randn(1, 1, cfg.d_model, generator=g), c, torch.tensor([3]))
    assert not c["k"].any() and new["k"][0, 3].abs().sum() > 0 and not new["k"][0, :3].any()
