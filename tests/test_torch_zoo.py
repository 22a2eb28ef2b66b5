"""The rest of the dense zoo, the VLM backbone and the encoder-decoder on
the port against the JAX package, on the CPU: ``reduced()`` qwen1.5-0.5b,
codeqwen1.5-7b, command-r-35b (dense: RoPE, MHA or GQA, QKV bias or none,
rmsnorm or layernorm, tied heads), internvl2-2b (prefix embeddings) and
whisper-large-v3 (learned positions, a non-causal encoder, cross-attention),
fp32, weights carried across by ``checkpoint/convert.py``
(``tests/_torch_zoo.py``).

For each: the plain forward's logits and aux loss, 12 serve steps (logits
and caches; whisper through its cross K/V cache) and the port's prefill
against its own serve steps, within 1e-4 of the largest logit (fp32:
summation order only); a bit-for-bit bf16 round trip through the
converter; and the port's initialiser against the reference's tree.
InternVL2's prefill with its prefix, and whisper's serve step that projects
the encoder output per token, against the JAX package's too.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import _torch_zoo as zoo  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import decoder as jdecoder  # noqa: E402
from repro_torch.launch.steps import make_prefill_step, make_serve_step  # noqa: E402
from repro_torch.models import decoder  # noqa: E402

ARCHS = ("qwen1.5-0.5b", "codeqwen1.5-7b", "command-r-35b", "internvl2-2b", "whisper-large-v3")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Many small ops: one intra-op thread, so that parallel test workers do
    not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=ARCHS)
def world(request, one_thread):
    return zoo.make_world(request.param)


def test_forward_logits_match(world):
    zoo.check_forward_logits(world)


def test_serve_steps_match(world):
    zoo.check_serve_steps(world)


def test_prefill_matches_own_decode(world):
    zoo.check_prefill_matches_own_decode(world)


@pytest.mark.parametrize("name", ARCHS)
def test_round_trip_bit_exact(name):
    zoo.check_round_trip_bit_exact(name)


@pytest.mark.parametrize("name", ARCHS)
def test_init_matches_reference_tree(name):
    zoo.check_init_matches_reference_tree(name)


def test_internvl2_prefill_with_prefix_matches():
    """The prefill step over 8 prefix embeddings + 20 tokens: RoPE and the
    causal mask over all 28 positions, the prefix stripped before the head;
    both routes against the JAX package's prefill step."""
    w = zoo.make_world("internvl2-2b", seed=3)
    want = jax.jit(jsteps.make_prefill_step(w.jcfg))(w.jparams, w.jbatch())
    for use_kernel in (True, False):
        got = make_prefill_step(w.cfg, use_kernel=use_kernel)(w.params, w.batch())
        assert got.shape == (zoo.B, 1, w.cfg.vocab_size)
        zoo.assert_rel_close(got, want, what="prefill with prefix")
    # the prefix moves the logits: it is not dropped
    plain = make_prefill_step(w.cfg)(w.params, w.batch(prefix=False))
    assert (plain - got).abs().max() > 1e-3


def test_whisper_serve_step_with_encoder_out_matches():
    """Whisper's serve step without cross K/V planes, projecting the encoder
    output per token (``make_serve_step(with_encoder=True)``), against the
    JAX package's, and against the cached-plane trajectory."""
    w = zoo.make_world("whisper-large-v3", seed=4)
    jenc = jdecoder._encode(w.jcfg, w.jparams, jnp.asarray(w.frames))
    enc = decoder.encode(w.cfg, w.params, torch.from_numpy(w.frames), use_kernel=True)
    zoo.assert_rel_close(enc, jenc, what="encoder output")
    jserve = jax.jit(jsteps.make_serve_step(w.jcfg, with_encoder=True))
    step = make_serve_step(w.cfg, with_encoder=True)
    jcache = jdecoder.init_cache(w.jcfg, zoo.B, zoo.STEPS)
    cache = decoder.init_cache(w.cfg, zoo.B, zoo.STEPS, device="cpu")
    assert all(set(c) == {"k", "v"} for c in cache)
    for t, (cached_logits, _) in enumerate(w.trajectory):
        tok = w.tokens[:, t : t + 1]
        want, jcache = jserve(w.jparams, jcache, jnp.asarray(tok), jnp.full((zoo.B,), t), jenc)
        logits, cache = step(w.params, cache, torch.from_numpy(tok).long(), torch.full((zoo.B,), t), enc)
        zoo.assert_rel_close(logits, want, what=f"step {t}")
        zoo.assert_rel_close(logits, cached_logits, what=f"step {t} against the cached planes")
    zoo.assert_cache_close(cache, jax.tree.map(np.asarray, jcache), w.cfg)
