"""Both packages' serving paths for one ``reduced()`` arch, on the same
weights and inputs, for ``tests/test_torch_zoo*.py``.

A :class:`World` holds the JAX package's params (from its own initialiser,
with the zeroed biases nudged so that a misuse shows), the port's copy of
them through ``checkpoint/convert.py``, prompts and (for a VLM) prefix
embeddings and (for an encoder-decoder) encoder frames made with numpy from
a seed, and the JAX package's forward logits with their aux loss and
``STEPS`` serve steps (logits and caches).  An encoder-decoder steps
through the cross K/V cache (``prefill_cross_cache``); the serve step that
projects ``encoder_out`` per token is in the whisper test.
"""
import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.launch import steps as jsteps
from repro.models import decoder as jdecoder
from repro_torch.checkpoint import convert
from repro_torch.configs import get_config, reduced
from repro_torch.launch.steps import make_prefill_step, make_serve_step
from repro_torch.models import decoder

B, S, STEPS = 2, 20, 12
MAX_SEQ = 64
# fp32 at reduced(): the two packages part by summation order only
FP32_RTOL = 1e-4


def configs(name: str, **changes) -> Tuple[Any, Any]:
    return (
        dataclasses.replace(jreduced(jget_config(name)), **changes),
        dataclasses.replace(reduced(get_config(name)), **changes),
    )


def no_drop(cfg):
    """``cfg`` with capacity_factor = E / k: capacity C = G, so a prefill
    drops no token and equals the decode step (G = 1, which never drops)."""
    if not cfg.num_experts:
        return cfg
    return dataclasses.replace(cfg, capacity_factor=cfg.num_experts / cfg.experts_per_token)


def nudge_biases(np_params, seed: int):
    """The initialiser zeroes the attention and layernorm biases; perturb
    them so that a wrong use of any of them shows."""
    rng = np.random.default_rng(seed)

    def nudge(path, a):
        name = jax.tree_util.keystr(path)
        if not any(k in name for k in ("'bq'", "'bk'", "'bv'", "'bo'", "'bias'")):
            return a
        return (a.astype(np.float32) + rng.standard_normal(a.shape).astype(np.float32) * 0.1).astype(a.dtype)

    return jax.tree_util.tree_map_with_path(nudge, np_params)


def as_float(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    a = np.asarray(x)
    if a.dtype == np.uint16:
        a = a.view(jnp.bfloat16)
    return a.astype(np.float32)


def assert_rel_close(got, want, rtol: float = FP32_RTOL, what: str = "") -> None:
    """max |got - want| <= rtol * max(1, max |want|)."""
    g, w = as_float(got), as_float(want)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    err, scale = np.abs(g - w).max(), max(1.0, np.abs(w).max())
    assert err <= rtol * scale, f"{what}: max abs error {err} > {rtol} x {scale}"


def assert_cache_close(cache, jcache, cfg, rtol: float = FP32_RTOL) -> None:
    got = convert.decoder_cache_to_reference(cache, cfg)
    assert [set(c) for c in got] == [set(c) for c in jcache]
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(jcache)):
        assert_rel_close(g, w, rtol, "cache")


@dataclasses.dataclass
class World:
    jcfg: Any
    cfg: Any
    jparams: Any
    params: Dict[str, Any]
    tokens: np.ndarray  # (B, S + STEPS) int32
    prefix: Optional[np.ndarray]
    frames: Optional[np.ndarray]
    want_logits: Any  # the JAX package's forward logits over tokens[:, :S]
    want_aux: float
    trajectory: List[Tuple[Any, Any]]  # (logits, cache) per serve step

    def batch(self, n: int = S, prefix: bool = True) -> Dict[str, torch.Tensor]:
        out = {"tokens": torch.from_numpy(self.tokens[:, :n]).long()}
        if prefix and self.prefix is not None:
            out["prefix_embeddings"] = torch.from_numpy(self.prefix)
        if self.frames is not None:
            out["encoder_frames"] = torch.from_numpy(self.frames)
        return out

    def jbatch(self, n: int = S, prefix: bool = True) -> Dict[str, Any]:
        return {k: jnp.asarray(v.numpy()) for k, v in self.batch(n, prefix).items()}

    def port_cache(self, cfg=None):
        """The port's empty cache for STEPS tokens, its cross planes filled."""
        cfg = cfg or self.cfg
        cache = decoder.init_cache(cfg, B, STEPS, device="cpu", cross_cache=cfg.is_encoder_decoder)
        if cfg.is_encoder_decoder:
            enc = decoder.encode(cfg, self.params, torch.from_numpy(self.frames))
            cache = decoder.prefill_cross_cache(cfg, self.params, cache, enc)
        return cache

    def port_steps(self, cfg=None, params=None, n: int = STEPS):
        """The port's serve steps over tokens[:, :n]: [(logits, cache)]."""
        cfg, params = cfg or self.cfg, params or self.params
        step, cache, out = make_serve_step(cfg), self.port_cache(cfg), []
        for t in range(n):
            logits, cache = step(params, cache, torch.from_numpy(self.tokens[:, t : t + 1]).long(), torch.full((B,), t))
            out.append((logits, cache))
        return out


def make_world(name: str, seed: int = 0, **changes) -> World:
    jcfg, cfg = configs(name, **changes)
    rng = np.random.default_rng(seed)
    np_params = nudge_biases(
        jax.tree.map(np.asarray, jdecoder.init_params(jcfg, jax.random.PRNGKey(seed), max_seq=MAX_SEQ)), seed + 1
    )
    jparams = jax.tree.map(jnp.asarray, np_params)
    params = convert.decoder_params_from_reference(np_params, cfg, device="cpu")
    tokens = rng.integers(0, cfg.vocab_size, (B, S + STEPS)).astype(np.int32)
    prefix = frames = None
    if cfg.num_prefix_tokens:
        prefix = (rng.standard_normal((B, cfg.num_prefix_tokens, cfg.d_model)) * 0.5).astype(np.float32)
    if cfg.is_encoder_decoder:
        frames = (rng.standard_normal((B, cfg.encoder_seq, cfg.d_model)) * 0.5).astype(np.float32)
    w = World(jcfg, cfg, jparams, params, tokens, prefix, frames, None, 0.0, [])
    jb = w.jbatch()
    fwd = jax.jit(
        lambda p, b: jdecoder.forward_logits(
            jcfg, p, b["tokens"], prefix_embeddings=b.get("prefix_embeddings"), encoder_frames=b.get("encoder_frames")
        )
    )
    w.want_logits, aux = fwd(jparams, jb)
    w.want_aux = float(aux)
    jcache = jdecoder.init_cache(jcfg, B, STEPS, cross_cache=jcfg.is_encoder_decoder)
    if jcfg.is_encoder_decoder:
        enc = jax.jit(lambda p, f: jdecoder._encode(jcfg, p, f))(jparams, jb["encoder_frames"])
        jcache = jdecoder.prefill_cross_cache(jcfg, jparams, jcache, enc)
    serve = jax.jit(jsteps.make_serve_step(jcfg))
    for t in range(STEPS):
        logits, jcache = serve(jparams, jcache, jnp.asarray(tokens[:, t : t + 1]), jnp.full((B,), t))
        w.trajectory.append((logits, jax.tree.map(np.asarray, jcache)))
    return w


# ---------------------------------------------------------------------------
# The checks each arch's test file runs on its worlds
# ---------------------------------------------------------------------------


def check_forward_logits(w: World) -> None:
    """The port's plain forward (every position) and its aux loss against
    the JAX package's forward_logits."""
    logits, aux = decoder.forward_logits(w.cfg, w.params, **w.batch())
    assert logits.shape == (B, S, w.cfg.vocab_size) and aux.dtype == torch.float32
    assert_rel_close(logits, w.want_logits, what="forward logits")
    np.testing.assert_allclose(aux.item(), w.want_aux, rtol=1e-6, atol=1e-7)
    assert (aux.item() > 0) == any(w.cfg.layer_moe(i) for i in range(w.cfg.num_layers))


def check_serve_steps(w: World) -> None:
    """STEPS serve steps: logits and caches against the JAX package's."""
    for t, ((logits, cache), (want, jcache)) in enumerate(zip(w.port_steps(), w.trajectory)):
        assert_rel_close(logits, want, what=f"step {t} logits")
        assert_cache_close(cache, jcache, w.cfg)


def check_prefill_matches_own_decode(w: World) -> None:
    """The port's prefill step (kernel route and plain route) against its
    own serve steps at the last prompt token; MoE at capacity_factor E/k.
    A VLM's decode has no prefix path (nor has the reference's), so its
    prefill here runs without one."""
    cfg = no_drop(w.cfg)
    logits, _ = w.port_steps(cfg)[-1]
    for use_kernel in (True, False):
        pre = make_prefill_step(cfg, use_kernel=use_kernel)(w.params, w.batch(STEPS, prefix=False))
        torch.testing.assert_close(pre, logits, rtol=FP32_RTOL, atol=FP32_RTOL)


def check_round_trip_bit_exact(name: str) -> None:
    """Reference -> port -> reference is the identity on every bit of a bf16
    tree, leaves given as ml_dtypes.bfloat16 or as a uint16 view (the MoE
    router stays fp32), and of a bf16 decode cache (cross planes too)."""
    jcfg, cfg = configs(name, dtype=jnp.bfloat16)
    cfg = dataclasses.replace(cfg, dtype=torch.bfloat16)
    np_params = jax.tree.map(np.asarray, jdecoder.init_params(jcfg, jax.random.PRNGKey(7), max_seq=MAX_SEQ))
    as_uint16 = jax.tree.map(lambda a: a.view(np.uint16) if a.dtype == jnp.bfloat16 else a, np_params)
    for source in (np_params, as_uint16):
        params = convert.decoder_params_from_reference(source, cfg, device="cpu")
        assert len(params["layers"]) == cfg.num_layers and params["embed"].dtype == torch.bfloat16
        for layer in params["layers"]:
            if "moe" in layer:
                assert layer["moe"]["router"].dtype == torch.float32
                assert layer["moe"]["w_gate"].shape == (cfg.num_experts, cfg.d_model, cfg.d_ff)
        back = convert.decoder_params_to_reference(params, cfg)
        assert jax.tree.structure(back) == jax.tree.structure(as_uint16)
        for got, want in zip(jax.tree.leaves(back), jax.tree.leaves(as_uint16)):
            assert got.dtype == want.dtype and got.shape == want.shape and np.array_equal(got, want)
    rng = np.random.default_rng(8)
    jcache = jax.tree.map(
        lambda a: np.asarray(jnp.asarray(rng.standard_normal(a.shape), a.dtype)),
        jdecoder.init_cache(jcfg, B, 16, cross_cache=jcfg.is_encoder_decoder),
    )
    jcache = jax.tree.map(lambda a: a.view(np.uint16) if a.dtype == jnp.bfloat16 else a, jcache)
    cache = convert.decoder_cache_from_reference(jcache, cfg, device="cpu")
    back = convert.decoder_cache_to_reference(cache, cfg)
    assert jax.tree.structure(back) == jax.tree.structure(jcache)
    for got, want in zip(jax.tree.leaves(back), jax.tree.leaves(jcache)):
        assert got.dtype == want.dtype and np.array_equal(got, want)


def check_init_matches_reference_tree(name: str) -> None:
    """The port's own initialiser builds the tree the reference's does:
    the same leaves, shapes and dtypes after conversion."""
    jcfg, cfg = configs(name)
    params = decoder.init_params(cfg, seed=0, device="cpu", max_seq=MAX_SEQ)
    want = jax.eval_shape(lambda: jdecoder.init_params(jcfg, jax.random.PRNGKey(0), max_seq=MAX_SEQ))
    got = convert.decoder_params_to_reference(params, cfg)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert g.shape == w.shape and g.dtype == np.dtype(w.dtype), (g.shape, w.shape, g.dtype, w.dtype)
