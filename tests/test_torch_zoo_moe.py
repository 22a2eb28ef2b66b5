"""The MoE archs and the hybrid on the port against the JAX package, on the
CPU: ``reduced()`` deepseek-moe-16b (4 routed experts, top-2, one shared),
llama4-scout-17b-a16e (4 experts, top-1, one shared) and jamba-v0.1-52b
(SSM and attention layers interleaved, no positions, MoE on every second
layer), fp32, weights carried across by ``checkpoint/convert.py``
(``tests/_torch_zoo.py``).

For each: the plain forward's logits and its aux loss summed over the MoE
layers, 12 serve steps (logits and caches) and the port's prefill against
its own serve steps (at capacity_factor = E / k, so that the prefill drops
nothing, as the decode step never does), within 1e-4 of the largest logit;
a bit-for-bit bf16 round trip through the converter (the router stays
fp32); and the port's initialiser against the reference's tree.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import _torch_zoo as zoo  # noqa: E402
from repro_torch.launch.steps import make_prefill_step  # noqa: E402
from repro_torch.models import decoder  # noqa: E402

ARCHS = ("deepseek-moe-16b", "llama4-scout-17b-a16e", "jamba-v0.1-52b")


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


def test_jamba_layers_interleave_without_positions():
    """reduced(jamba): layer 0 SSM with a dense MLP, layer 1 attention with
    MoE; no learned positions (the reference gives the hybrid none)."""
    _, cfg = zoo.configs("jamba-v0.1-52b")
    params = decoder.init_params(cfg, seed=0, device="cpu")
    assert [set(p) for p in params["layers"]] == [{"norm1", "ssm", "norm2", "mlp"}, {"norm1", "attn", "norm2", "moe"}]
    assert "pos_embed" not in params and not decoder.has_pos_embed(cfg)
    full = dataclasses.replace(cfg, attn_period=8, attn_offset=4, num_layers=16, moe_period=2)
    assert [full.layer_kind(i) for i in range(16)].count("attn") == 2


def test_prefill_parts_from_decode_when_it_drops(world):
    """Below capacity (capacity_factor 0.5) the prefill drops token-expert
    choices and its last logits part from the decode step's, which never
    drops; at E / k it keeps every choice."""
    from repro_torch.models import moe

    cfg = world.cfg
    x = torch.randn(zoo.B, zoo.STEPS, cfg.d_model, generator=torch.Generator().manual_seed(0))
    layer = next(p["moe"] for p in world.params["layers"] if "moe" in p)
    assert moe.route(zoo.no_drop(cfg), layer, x).keep.all()
    low = dataclasses.replace(cfg, capacity_factor=0.5)
    assert not moe.route(low, layer, x).keep.all()
    decoded, _ = world.port_steps()[-1]
    pre = make_prefill_step(low)(world.params, world.batch(zoo.STEPS, prefix=False))
    assert (pre - decoded).abs().max() > 1e-3
