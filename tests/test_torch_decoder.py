"""The port's Mamba2 serving slice against the JAX package's, on the CPU.

``reduced(mamba2-1.3b)`` (2 layers, d 256, vocab 512, fp32) with the JAX
initialiser's weights carried across by ``checkpoint/convert.py``: the
prefill step's logits (scan through the kernel route and through the plain
chunked form) and a few serve steps' logits and caches are held to the JAX
package's at 1e-4 in fp32.  The bf16 variant is held at 0.05 absolute, about six
bf16 rounding steps at the logits' scale (~1): XLA keeps excess precision
across fused bf16 elementwise chains (the conv taps, silu, the gated norm)
where torch rounds after every op, so the two part by a few rounding steps
in each of the two layers (0.012 on the prefill logits).
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
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
    """The port's own copy of the config, its reduced variant and its
    parameter count equal the reference's, field for field."""
    assert list_configs() == ("mamba2-1.3b",)
    for full in (False, True):
        j = jget_config("mamba2-1.3b")
        t = get_config("mamba2-1.3b")
        if not full:
            j, t = jreduced(j), reduced(t)
        for f in dataclasses.fields(ModelConfig):
            jv, tv = getattr(j, f.name), getattr(t, f.name)
            if f.name == "dtype":
                assert str(tv).replace("torch.", "") == jnp.dtype(jv).name
            else:
                assert tv == jv, f.name
        assert (t.d_inner, t.ssm_heads, t.block_period) == (j.d_inner, j.ssm_heads, j.block_period)
        assert t.param_count() == j.param_count()
    assert get_config("mamba2-1.3b").param_count() == 1_343_625_216


@pytest.mark.parametrize(
    "changes,match",
    [
        (dict(ssm_state=0, num_heads=4, num_kv_heads=4), "attention"),  # a dense transformer
        (dict(attn_period=2, attn_offset=1), "attention"),  # hybrid
        (dict(d_ff=128), "MLP"),
        (dict(num_experts=4, experts_per_token=2, d_ff=128), "MoE"),
        (dict(is_encoder_decoder=True, num_encoder_layers=2), "encoder"),
    ],
)
def test_unported_layer_kinds_raise(changes, match):
    cfg = dataclasses.replace(reduced(get_config("mamba2-1.3b")), **changes)
    for call in (
        lambda: decoder.init_params(cfg, device="cpu"),
        lambda: decoder.init_cache(cfg, 1, 8, device="cpu"),
        lambda: decoder.forward_logits(cfg, {}, torch.zeros(1, 4, dtype=torch.long)),
    ):
        with pytest.raises(NotImplementedError, match=f"(?s){match}.*ROADMAP"):
            call()


def test_unported_inputs_raise():
    cfg = reduced(get_config("mamba2-1.3b"))
    params = decoder.init_params(cfg, device="cpu")
    tokens = torch.zeros(1, 4, dtype=torch.long)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        decoder.forward_logits(cfg, params, tokens, prefix_embeddings=torch.zeros(1, 2, cfg.d_model))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        decoder.forward_logits(cfg, params, tokens, encoder_frames=torch.zeros(1, 2, cfg.d_model))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        convert.decoder_params_from_reference({"pos_embed": np.zeros((4, 4)), "blocks": ()}, cfg, device="cpu")
