"""The port's serving slices (Mamba2 and StarCoder2) against the JAX
package's, on the CPU.

``reduced(mamba2-1.3b)`` (2 layers, d 256, vocab 512, fp32) with the JAX
initialiser's weights carried across by ``checkpoint/convert.py``: the
prefill step's logits (scan through the kernel route and through the plain
chunked form) and a few serve steps' logits and caches are held to the JAX
package's at 1e-4 in fp32.  The bf16 variant is held at 0.05 absolute, about six
bf16 rounding steps at the logits' scale (~1): XLA keeps excess precision
across fused bf16 elementwise chains (the conv taps, silu, the gated norm)
where torch rounds after every op, so the two part by a few rounding steps
in each of the two layers (0.012 on the prefill logits).

``reduced(starcoder2-3b)`` (2 layers, d 256, 4 heads of 64, window 64, gelu
MLP 512, fp32), with its 1 KV head and with 2 (so that the GQA grouping
matters): the prefill step on both routes over 70 tokens, and 80 serve steps
through the rolling KV cache of width 64, are held to the JAX package's at
1e-4 in fp32, and in bf16 (1 KV head) at the same 0.05.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from _torch_zoo import no_drop  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import list_configs as jlist_configs  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import decoder as jdecoder  # noqa: E402
from repro_torch.checkpoint import convert  # noqa: E402
from repro_torch.configs import ModelConfig, get_config, list_configs, reduced  # noqa: E402
from repro_torch.launch.steps import make_prefill_step, make_serve_step  # noqa: E402
from repro_torch.models import decoder  # noqa: E402

CPU = torch.device("cpu")
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": 1e-4, "bfloat16": 0.05}
B, P, STEPS = 2, 70, 4  # P > ssm_chunk (64): a ragged second chunk
SC_STEPS = 80  # StarCoder2: P and SC_STEPS both past the window of 64


def configs(dtype):
    jd, td = DTYPES[dtype]
    return (
        dataclasses.replace(jreduced(jget_config("mamba2-1.3b")), dtype=jd),
        dataclasses.replace(reduced(get_config("mamba2-1.3b")), dtype=td),
    )


def as_float(x):
    """A tensor or a JAX/numpy array (bf16 as ml_dtypes or a uint16 view) in fp32."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    a = np.asarray(x)
    if a.dtype == np.uint16:
        a = a.view(jnp.bfloat16)
    return a.astype(np.float32)


def assert_tree_close(got, want, tol):
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(as_float(g), as_float(w), rtol=tol, atol=tol)


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def world(request):
    """Both packages' reduced model with the same weights and prompts, and
    the JAX package's prefill logits and serve-step trajectory."""
    dtype = request.param
    jcfg, cfg = configs(dtype)
    jparams = jdecoder.init_params(jcfg, jax.random.PRNGKey(0))
    np_params = jax.tree.map(np.asarray, jparams)
    params = convert.decoder_params_from_reference(np_params, cfg, device="cpu")
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, P + STEPS)).astype(np.int32)
    want_prefill = jax.jit(jsteps.make_prefill_step(jcfg))(jparams, {"tokens": jnp.asarray(tokens[:, :P])})
    serve = jax.jit(jsteps.make_serve_step(jcfg))
    jcache = jdecoder.init_cache(jcfg, B, P + STEPS)
    trajectory = []
    for t in range(STEPS):
        logits, jcache = serve(jparams, jcache, jnp.asarray(tokens[:, t : t + 1]), jnp.full((B,), t))
        trajectory.append((logits, jax.tree.map(np.asarray, jcache)))
    return dtype, cfg, params, torch.from_numpy(tokens).long(), want_prefill, trajectory


@pytest.mark.parametrize("use_kernel", [True, False])
def test_prefill_step_matches(world, use_kernel):
    dtype, cfg, params, tokens, want, _ = world
    got = make_prefill_step(cfg, use_kernel=use_kernel)(params, {"tokens": tokens[:, :P]})
    assert got.shape == (B, 1, cfg.vocab_size) and got.dtype == cfg.dtype
    np.testing.assert_allclose(as_float(got), as_float(want), rtol=TOL[dtype], atol=TOL[dtype])


def test_serve_steps_match(world):
    dtype, cfg, params, tokens, _, trajectory = world
    step = make_serve_step(cfg)
    cache = decoder.init_cache(cfg, B, P + STEPS, device="cpu")
    for t, (want_logits, want_cache) in enumerate(trajectory):
        logits, cache = step(params, cache, tokens[:, t : t + 1], torch.full((B,), t))
        np.testing.assert_allclose(as_float(logits), as_float(want_logits), rtol=TOL[dtype], atol=TOL[dtype])
        got_cache = convert.decoder_cache_to_reference(cache, cfg)
        assert [set(c) for c in got_cache] == [set(c) for c in want_cache]
        for g, w in zip(got_cache, want_cache):
            assert g["conv"].dtype == (np.uint16 if dtype == "bfloat16" else np.float32)
            assert g["ssm"].dtype == np.float32 and g["ssm"].shape == w["ssm"].shape
        assert_tree_close(got_cache, want_cache, TOL[dtype])


def test_serve_step_from_a_reference_cache(world):
    """A JAX cache carried across mid-sequence continues identically."""
    dtype, cfg, params, tokens, _, trajectory = world
    _, jcache = trajectory[1]
    cache = convert.decoder_cache_from_reference(jcache, cfg, device="cpu")
    logits, _ = make_serve_step(cfg)(params, cache, tokens[:, 2:3], torch.full((B,), 2))
    np.testing.assert_allclose(as_float(logits), as_float(trajectory[2][0]), rtol=TOL[dtype], atol=TOL[dtype])


def test_prefill_matches_own_decode_steps():
    """The chunked scan (kernel route and plain form) against the exact
    recurrence of the serve step, on the port alone, in fp32."""
    cfg = reduced(get_config("mamba2-1.3b"))
    params = decoder.init_params(cfg, seed=3, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(2).integers(0, cfg.vocab_size, (B, 150))).long()
    step = make_serve_step(cfg)
    cache = decoder.init_cache(cfg, B, 150, device="cpu")
    for t in range(150):
        logits, cache = step(params, cache, tokens[:, t : t + 1], torch.full((B,), t))
    for use_kernel in (True, False):
        prefill = make_prefill_step(cfg, use_kernel=use_kernel)(params, {"tokens": tokens})
        torch.testing.assert_close(prefill, logits, rtol=1e-4, atol=1e-4)
    full, aux = decoder.forward_logits(cfg, params, tokens[:, :20])
    assert full.shape == (B, 20, cfg.vocab_size) and aux.item() == 0.0


def test_params_round_trip_bit_exact():
    """Reference -> port -> reference is the identity on every bit, whether
    bf16 leaves come as ml_dtypes.bfloat16 or as a uint16 view."""
    jcfg, cfg = configs("bfloat16")
    np_params = jax.tree.map(np.asarray, jdecoder.init_params(jcfg, jax.random.PRNGKey(7)))
    as_uint16 = jax.tree.map(lambda a: a.view(np.uint16) if a.dtype == jnp.bfloat16 else a, np_params)
    for source in (np_params, as_uint16):
        params = convert.decoder_params_from_reference(source, cfg, device="cpu")
        assert params["embed"].dtype == torch.bfloat16 and params["layers"][0]["ssm"]["A_log"].dtype == torch.float32
        assert len(params["layers"]) == cfg.num_layers
        back = convert.decoder_params_to_reference(params, cfg)
        assert jax.tree.structure(back) == jax.tree.structure(as_uint16)
        for got, want in zip(jax.tree.leaves(back), jax.tree.leaves(as_uint16)):
            assert got.dtype == want.dtype and got.shape == want.shape
            assert np.array_equal(got, want)


def test_params_layer_order_follows_block_period():
    """Layer b·period + j is entry b of the reference's position j."""
    jcfg, cfg = configs("float32")
    np_params = jax.tree.map(np.asarray, jdecoder.init_params(jcfg, jax.random.PRNGKey(8)))
    period = cfg.block_period
    params = convert.decoder_params_from_reference(np_params, cfg, device="cpu")
    for i, layer in enumerate(params["layers"]):
        want = np_params["blocks"][i % period]["ssm"]["in_proj"][i // period]
        assert np.array_equal(layer["ssm"]["in_proj"].numpy(), want)


def test_configs_match_reference():
    """The port's own copies of the configs, their reduced variants and
    their parameter counts equal the reference's, field for field.  The
    port registers one arch of its own, deepseek-v2-lite (MLA, which the
    JAX package lacks); the fields it added stay at their defaults in every
    arch the two share."""
    assert set(jlist_configs()) <= set(list_configs())
    assert set(list_configs()) - set(jlist_configs()) == {"deepseek-v2-lite"}
    assert len(list_configs()) == 11
    jfields = {f.name for f in dataclasses.fields(type(jget_config(jlist_configs()[0])))}
    for name in jlist_configs():
        for full in (False, True):
            j = jget_config(name)
            t = get_config(name)
            if not full:
                j, t = jreduced(j), reduced(t)
            for f in dataclasses.fields(ModelConfig):
                if f.name not in jfields:  # the port's own fields
                    assert getattr(t, f.name) == f.default, (name, f.name)
                    continue
                jv, tv = getattr(j, f.name), getattr(t, f.name)
                if f.name == "dtype":
                    assert str(tv).replace("torch.", "") == jnp.dtype(jv).name
                else:
                    assert tv == jv, f.name
            assert (t.d_inner, t.ssm_heads, t.block_period) == (j.d_inner, j.ssm_heads, j.block_period)
            assert t.param_count() == j.param_count()
    assert get_config("mamba2-1.3b").param_count() == 1_343_625_216
    # term for term the reference's, which counts three d x ff matrices for
    # StarCoder2's two-matrix gelu MLP (the model has 3,180,905,472 elements)
    assert get_config("starcoder2-3b").param_count() == 4_313_084_928


@pytest.mark.parametrize(
    "changes",
    [
        dict(ssm_state=0, num_heads=4, num_kv_heads=4, use_rope=True),  # a dense transformer
        dict(ssm_state=0, num_heads=4, num_kv_heads=2, use_rope=True, d_ff=128),  # with a gated MLP
        dict(d_ff=128),  # SSM layers with an MLP
    ],
)
def test_attention_and_mlp_layer_kinds_run(changes):
    """Dense attention and dense MLP layers, once refused, now build, prefill
    and decode, and the prefill's last logits equal the decoded ones."""
    cfg = dataclasses.replace(reduced(get_config("mamba2-1.3b")), **changes)
    params = decoder.init_params(cfg, seed=1, device="cpu")
    layer = params["layers"][0]
    assert ("attn" in layer) == (cfg.ssm_state == 0) and ("mlp" in layer) == (cfg.d_ff > 0)
    tokens = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab_size, (1, 12))).long()
    cache = decoder.init_cache(cfg, 1, 12, device="cpu")
    for t in range(12):
        logits, cache = decoder.decode_step(cfg, params, cache, tokens[:, t : t + 1], torch.full((1,), t))
    prefill, _ = decoder.forward_logits(cfg, params, tokens, last_only=True)
    torch.testing.assert_close(prefill, logits, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize(
    "changes",
    [
        # a dense transformer without RoPE (mamba2's use_rope=False): learned positions
        dict(ssm_state=0, num_heads=4, num_kv_heads=4),
        # the hybrid: layer 0 SSM, layer 1 attention (no positions)
        dict(attn_period=2, attn_offset=1, num_heads=4, num_kv_heads=4),
        # MoE on a dense transformer
        dict(ssm_state=0, num_heads=4, num_kv_heads=4, use_rope=True, num_experts=4, experts_per_token=2, d_ff=128),
        # MoE on SSM layers
        dict(num_experts=4, experts_per_token=2, d_ff=128),
        # an encoder-decoder: SSM encoder and decoder, cross-attention
        dict(is_encoder_decoder=True, num_encoder_layers=2, encoder_seq=16, num_heads=4, num_kv_heads=4),
    ],
    ids=["learned_positions", "hybrid", "moe_dense", "moe_ssm", "encoder_decoder"],
)
def test_once_refused_layer_kinds_run(changes):
    """The layer kinds the port once refused (learned positions, the hybrid
    interleave, MoE, the encoder-decoder) build, prefill and decode, and
    the prefill's last logits equal the decoded ones.  The configurations
    are the refused ones, with the attention heads that mamba2's config
    (which has none) lacks where a layer attends; MoE runs at
    capacity_factor E / k, so that the prefill drops nothing, as the decode
    step never does."""
    cfg = no_drop(dataclasses.replace(reduced(get_config("mamba2-1.3b")), **changes))
    params = decoder.init_params(cfg, seed=1, device="cpu", max_seq=64)
    learned_positions = cfg.is_encoder_decoder or (cfg.ssm_state == 0 and not cfg.use_rope)
    assert ("pos_embed" in params) == decoder.has_pos_embed(cfg) == learned_positions
    assert ("moe" in params["layers"][-1]) == (cfg.num_experts > 0)
    tokens = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab_size, (1, 12))).long()
    batch = {"tokens": tokens}
    cache = decoder.init_cache(cfg, 1, 12, device="cpu", cross_cache=cfg.is_encoder_decoder)
    if cfg.is_encoder_decoder:
        batch["encoder_frames"] = torch.randn(1, cfg.encoder_seq, cfg.d_model, generator=torch.Generator().manual_seed(4))
        enc = decoder.encode(cfg, params, batch["encoder_frames"])
        cache = decoder.prefill_cross_cache(cfg, params, cache, enc)
    for t in range(12):
        logits, cache = decoder.decode_step(cfg, params, cache, tokens[:, t : t + 1], torch.full((1,), t))
    for use_kernel in (True, False):
        prefill = make_prefill_step(cfg, use_kernel=use_kernel)(params, batch)
        torch.testing.assert_close(prefill, logits, rtol=1e-4, atol=1e-4)
    _, aux = decoder.forward_logits(cfg, params, **batch)
    assert (aux.item() > 0) == (cfg.num_experts > 0)


def test_prefix_embeddings_run_and_are_stripped():
    """Prefix embeddings go before the tokens (RoPE over all positions) and
    are stripped before the head.  With the first 4 tokens' own embeddings
    as the prefix, a dense RoPE stack over prefix + the other 6 tokens must
    give the logits of the 10 tokens' last 6 positions."""
    cfg = dataclasses.replace(reduced(get_config("mamba2-1.3b")), ssm_state=0, num_heads=4, num_kv_heads=4,
                              use_rope=True)
    params = decoder.init_params(cfg, seed=2, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 10))).long()
    prefix = params["embed"][tokens[:, :4]]
    got, _ = decoder.forward_logits(cfg, params, tokens[:, 4:], prefix_embeddings=prefix)
    want, _ = decoder.forward_logits(cfg, params, tokens)
    assert got.shape == (2, 6, cfg.vocab_size)
    torch.testing.assert_close(got, want[:, 4:], rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# StarCoder2-3B: dense GQA attention with a sliding window, gelu MLP
# ---------------------------------------------------------------------------


def sc_configs(dtype, num_kv_heads=1):
    jd, td = DTYPES[dtype]
    return (
        dataclasses.replace(jreduced(jget_config("starcoder2-3b")), dtype=jd, num_kv_heads=num_kv_heads),
        dataclasses.replace(reduced(get_config("starcoder2-3b")), dtype=td, num_kv_heads=num_kv_heads),
    )


def with_nonzero_biases(np_params, seed):
    """The initialiser zeroes the qkv and output biases and the layernorm
    biases; perturb them so that a wrong use of any of them shows."""
    rng = np.random.default_rng(seed)

    def nudge(path, a):
        name = jax.tree_util.keystr(path)
        if not any(k in name for k in ("'bq'", "'bk'", "'bv'", "'bo'", "'bias'")):
            return a
        return (a.astype(np.float32) + rng.standard_normal(a.shape).astype(np.float32) * 0.1).astype(a.dtype)

    return jax.tree_util.tree_map_with_path(nudge, np_params)


@pytest.fixture(
    scope="module", params=[("float32", 1), ("float32", 2), ("bfloat16", 1)], ids=lambda p: f"{p[0]}-kv{p[1]}"
)
def sc_world(request):
    """reduced(starcoder2-3b) in both packages with the same weights and
    prompts, the JAX package's prefill logits over P tokens, and its serve
    steps over SC_STEPS tokens through the rolling cache (logits, caches)."""
    dtype, nkv = request.param
    jcfg, cfg = sc_configs(dtype, nkv)
    np_params = with_nonzero_biases(jax.tree.map(np.asarray, jdecoder.init_params(jcfg, jax.random.PRNGKey(0))), 1)
    jparams = jax.tree.map(jnp.asarray, np_params)
    params = convert.decoder_params_from_reference(np_params, cfg, device="cpu")
    tokens = np.random.default_rng(2).integers(0, cfg.vocab_size, (B, SC_STEPS)).astype(np.int32)
    want_prefill = jax.jit(jsteps.make_prefill_step(jcfg))(jparams, {"tokens": jnp.asarray(tokens[:, :P])})
    serve = jax.jit(jsteps.make_serve_step(jcfg))
    jcache = jdecoder.init_cache(jcfg, B, SC_STEPS)
    trajectory = []
    for t in range(SC_STEPS):
        logits, jcache = serve(jparams, jcache, jnp.asarray(tokens[:, t : t + 1]), jnp.full((B,), t))
        trajectory.append((logits, jax.tree.map(np.asarray, jcache)))
    return dtype, cfg, params, torch.from_numpy(tokens).long(), want_prefill, trajectory


@pytest.mark.parametrize("use_kernel", [True, False])
def test_starcoder2_prefill_step_matches(sc_world, use_kernel):
    dtype, cfg, params, tokens, want, _ = sc_world
    assert P > cfg.sliding_window
    got = make_prefill_step(cfg, use_kernel=use_kernel)(params, {"tokens": tokens[:, :P]})
    assert got.shape == (B, 1, cfg.vocab_size) and got.dtype == cfg.dtype
    np.testing.assert_allclose(as_float(got), as_float(want), rtol=TOL[dtype], atol=TOL[dtype])


def test_starcoder2_serve_steps_match(sc_world):
    """Every step's logits and K/V caches, past the window: the cache is a
    rolling buffer of width 64 and wraps at step 64."""
    dtype, cfg, params, tokens, _, trajectory = sc_world
    step = make_serve_step(cfg)
    cache = decoder.init_cache(cfg, B, SC_STEPS, device="cpu")
    assert cache[0]["k"].shape == (B, cfg.sliding_window, cfg.num_kv_heads, cfg.head_dim)
    for t, (want_logits, want_cache) in enumerate(trajectory):
        logits, cache = step(params, cache, tokens[:, t : t + 1], torch.full((B,), t))
        np.testing.assert_allclose(as_float(logits), as_float(want_logits), rtol=TOL[dtype], atol=TOL[dtype])
        got_cache = convert.decoder_cache_to_reference(cache, cfg)
        assert [set(c) for c in got_cache] == [set(c) for c in want_cache] == [{"k", "v"}]
        assert_tree_close(got_cache, want_cache, TOL[dtype])


def test_starcoder2_serve_step_from_a_reference_cache(sc_world):
    """A JAX cache carried across after the wrap continues identically."""
    dtype, cfg, params, tokens, _, trajectory = sc_world
    _, jcache = trajectory[69]
    cache = convert.decoder_cache_from_reference(jcache, cfg, device="cpu")
    logits, _ = make_serve_step(cfg)(params, cache, tokens[:, 70:71], torch.full((B,), 70))
    np.testing.assert_allclose(as_float(logits), as_float(trajectory[70][0]), rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("nkv", [1, 2])
def test_starcoder2_prefill_matches_own_decode_steps(nkv):
    """Both prefill routes against 150 serve steps of the port alone, in
    fp32: the rolling cache wraps twice, and the prefill's window mask must
    keep exactly the 64 keys i - 64 < j <= i that the cache holds.  A
    linear cache of 150 (``rolling=False`` and no window) is full attention
    and parts from it."""
    _, cfg = sc_configs("float32", nkv)
    params = decoder.init_params(cfg, seed=3, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(4).integers(0, cfg.vocab_size, (B, 150))).long()
    step = make_serve_step(cfg)
    cache = decoder.init_cache(cfg, B, 150, device="cpu")
    for t in range(150):
        logits, cache = step(params, cache, tokens[:, t : t + 1], torch.full((B,), t))
        if t in (40, 149):
            for use_kernel in (True, False):
                prefill = make_prefill_step(cfg, use_kernel=use_kernel)(params, {"tokens": tokens[:, : t + 1]})
                torch.testing.assert_close(prefill, logits, rtol=1e-4, atol=1e-4)
    full = dataclasses.replace(cfg, sliding_window=0)
    cache = decoder.init_cache(full, B, 150, device="cpu")
    for t in range(150):
        full_logits, cache = make_serve_step(full)(params, cache, tokens[:, t : t + 1], torch.full((B,), t))
    torch.testing.assert_close(make_prefill_step(full)(params, {"tokens": tokens}), full_logits, rtol=1e-4, atol=1e-4)
    assert (full_logits - logits).abs().max() > 1e-3


def test_starcoder2_init_cache_widths():
    _, cfg = sc_configs("float32")
    assert decoder.init_cache(cfg, 1, 40, device="cpu")[0]["k"].shape[1] == 40
    assert decoder.init_cache(cfg, 1, 400, device="cpu")[0]["k"].shape[1] == 64
    assert decoder.init_cache(cfg, 1, 400, rolling=True, device="cpu")[0]["k"].shape[1] == 400


def test_rolling_serve_step_without_window_matches_reference():
    """``rolling=True`` on a model with no sliding window: a cache of width
    16 wraps over 40 steps.  Every step's logits and K/V caches equal the
    JAX package's rolling serve step, and the last logits equal a prefill of
    the same model with a window of 16."""
    jcfg, cfg = (dataclasses.replace(c, sliding_window=0) for c in sc_configs("float32", 2))
    np_params = with_nonzero_biases(jax.tree.map(np.asarray, jdecoder.init_params(jcfg, jax.random.PRNGKey(5))), 6)
    jparams = jax.tree.map(jnp.asarray, np_params)
    params = convert.decoder_params_from_reference(np_params, cfg, device="cpu")
    tokens = np.random.default_rng(7).integers(0, cfg.vocab_size, (B, 40)).astype(np.int32)
    jserve = jax.jit(jsteps.make_serve_step(jcfg, rolling=True))
    jcache = jdecoder.init_cache(jcfg, B, 16, rolling=True)
    step = make_serve_step(cfg, rolling=True)
    cache = decoder.init_cache(cfg, B, 16, rolling=True, device="cpu")
    assert cache[0]["k"].shape[1] == 16
    for t in range(40):
        want, jcache = jserve(jparams, jcache, jnp.asarray(tokens[:, t : t + 1]), jnp.full((B,), t))
        logits, cache = step(params, cache, torch.from_numpy(tokens[:, t : t + 1]).long(), torch.full((B,), t))
        np.testing.assert_allclose(as_float(logits), as_float(want), rtol=1e-4, atol=1e-4)
        assert_tree_close(convert.decoder_cache_to_reference(cache, cfg), jax.tree.map(np.asarray, jcache), 1e-4)
    windowed = dataclasses.replace(cfg, sliding_window=16)
    prefill = make_prefill_step(windowed)(params, {"tokens": torch.from_numpy(tokens).long()})
    torch.testing.assert_close(prefill, logits, rtol=1e-4, atol=1e-4)


def test_starcoder2_params_and_cache_round_trip_bit_exact():
    """Reference -> port -> reference is the identity on every bit for
    attention-layer params (attn, norm2, mlp, lm_head) and K/V caches."""
    jcfg, cfg = sc_configs("bfloat16", 1)
    np_params = jax.tree.map(np.asarray, jdecoder.init_params(jcfg, jax.random.PRNGKey(7)))
    as_uint16 = jax.tree.map(lambda a: a.view(np.uint16) if a.dtype == jnp.bfloat16 else a, np_params)
    for source in (np_params, as_uint16):
        params = convert.decoder_params_from_reference(source, cfg, device="cpu")
        assert set(params) == {"embed", "final_norm", "layers", "lm_head"}
        assert set(params["layers"][1]) == {"norm1", "attn", "norm2", "mlp"}
        assert set(params["layers"][0]["attn"]) == {"wq", "wk", "wv", "wo", "bq", "bk", "bv", "bo"}
        back = convert.decoder_params_to_reference(params, cfg)
        assert jax.tree.structure(back) == jax.tree.structure(as_uint16)
        for got, want in zip(jax.tree.leaves(back), jax.tree.leaves(as_uint16)):
            assert got.dtype == want.dtype and got.shape == want.shape
            assert np.array_equal(got, want)
    rng = np.random.default_rng(8)
    jcache = jax.tree.map(
        lambda a: np.asarray(jnp.asarray(rng.standard_normal(a.shape), jnp.bfloat16)).view(np.uint16),
        jdecoder.init_cache(jcfg, B, 100),
    )
    cache = convert.decoder_cache_from_reference(jcache, cfg, device="cpu")
    assert cache[0]["k"].dtype == torch.bfloat16 and cache[0]["k"].shape == (B, 64, 1, 64)
    back = convert.decoder_cache_to_reference(cache, cfg)
    for got, want in zip(jax.tree.leaves(back), jax.tree.leaves(jcache)):
        assert got.dtype == want.dtype and np.array_equal(got, want)
