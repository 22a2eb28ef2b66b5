"""The EHFL simulator with routed LM clients (``lm_backend`` for the MoE
archs) against the JAX package on the CPU, and the MoE dispatch under
``torch.func.vmap``.

``run_simulation`` with ``lm_backend(reduced(arch))`` for deepseek-moe-16b,
llama4-scout-17b-a16e and jamba-v0.1-52b on ``tests/test_torch_lm_backend.py``'s
setup (4 clients of 24 sequences of 16 tokens, k = 2, kappa = 4, probe 4,
2 epochs), the reference's key chain replayed into the port's draws
(``tests/_torch_replay.py``) and its initial params carried over through
``checkpoint/convert.py``: the integer dynamics, ages and selections equal
exactly; the global params within ``PARAM_ATOL`` = 1e-5 and avg_m within
``M_ATOL`` = 1e-6 (fp32; the two sides differ in summation order).  The
simulator batches each client's ``grad_loss`` with ``vmap``, which
``models/moe.py``'s fixed-shape dispatch allows.

``vmap(grad)`` of ``apply_moe`` over two lanes must equal a loop of
per-lane ``grad`` bit for bit (fp32, capacity factors 1.25 and 0.5, where
tokens are dropped).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_replay import replay_draws  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.core import EHFLConfig as JEHFLConfig  # noqa: E402
from repro.core import init_carry as jinit_carry  # noqa: E402
from repro.core import run_simulation as jrun_simulation  # noqa: E402
from repro.core import simulator as jsim  # noqa: E402
from repro.core import vaoi as jvaoi  # noqa: E402
from repro.data import make_token_dataset as jmake_token_dataset  # noqa: E402
from repro.fl import lm_backend as jlm_backend  # noqa: E402
from repro_torch.checkpoint import convert  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core import simulator as tsim  # noqa: E402
from repro_torch.fl import lm_backend  # noqa: E402
from repro_torch.models import decoder, moe  # noqa: E402

PARAM_ATOL, M_ATOL = 1e-5, 1e-6
SIM = dict(num_clients=4, epochs=2, slots_per_epoch=8, kappa=4, p_bc=1.0, k=2, mu=0.01, e_max=9, eval_every=2,
           probe_size=4)
EXACT_METRICS = ("n_started", "n_uploaded", "energy", "avg_age")
ROUTED = ("deepseek-moe-16b", "llama4-scout-17b-a16e", "jamba-v0.1-52b")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Many small ops: one intra-op thread each, so that parallel test
    workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=ROUTED)
def runs(request):
    """The JAX package's LM run of ``arch``, and the port's on the same
    tokens, initial params and draws; the reference's selections stepped
    out of its epoch function."""
    arch = request.param
    jcfg, cfg = jreduced(jget_config(arch)), reduced(get_config(arch))
    toks = jmake_token_dataset(jax.random.PRNGKey(0), 4, 24, 16, jcfg.vocab_size)["tokens"]
    data = {
        "images": toks,
        "labels": jnp.zeros(toks.shape[:2], jnp.int32),
        "test_images": toks[0],
        "test_labels": jnp.zeros((toks.shape[1],), jnp.int32),
    }
    jbackend = jlm_backend(jcfg)
    ref = jrun_simulation(JEHFLConfig(**SIM), jbackend, data)
    epoch_fn = jax.jit(jsim.make_epoch_fn(JEHFLConfig(**SIM), jbackend, data))
    carry, ref["selected"] = jinit_carry(JEHFLConfig(**SIM), jbackend), []
    for t in range(SIM["epochs"]):
        ref["selected"].append(np.asarray(jvaoi.select_topk(carry.age, SIM["k"], jax.random.split(carry.key, 4)[0])))
        carry, _ = epoch_fn(carry, t)
    ref["stepped_age"] = np.asarray(carry.age)
    params0 = jax.tree.map(np.asarray, jinit_carry(JEHFLConfig(**SIM), jbackend).global_params)
    params0 = decoder.flat_params(convert.decoder_params_from_reference(params0, cfg, "cpu"))
    port = tsim.run_simulation(
        tsim.EHFLConfig(**SIM), lm_backend(cfg), {k: np.asarray(v) for k, v in data.items()},
        draws=replay_draws(JEHFLConfig(**SIM), jbackend, 24), params=params0, device="cpu",
    )
    return cfg, ref, port, params0


def test_routed_lm_simulation_dynamics_match_reference_exactly(runs):
    _, ref, port, _ = runs
    for k in EXACT_METRICS:
        np.testing.assert_array_equal(port["metrics"][k].numpy(), np.asarray(ref["metrics"][k]), err_msg=k)
    np.testing.assert_array_equal(port["metrics"]["selected"].numpy(), np.stack(ref["selected"]))
    np.testing.assert_array_equal(port["carry"].age.numpy(), ref["stepped_age"])
    assert port["metrics"]["n_started"].sum().item() > 0
    for field in ("age", "battery", "pending", "counter"):
        np.testing.assert_array_equal(getattr(port["carry"], field).numpy(), np.asarray(getattr(ref["carry"], field)),
                                      err_msg=field)


def test_routed_lm_simulation_floats_match_reference(runs):
    cfg, ref, port, params0 = runs
    np.testing.assert_allclose(port["metrics"]["avg_m"].numpy(), np.asarray(ref["metrics"]["avg_m"]), rtol=0,
                               atol=M_ATOL)
    assert np.isfinite(port["metrics"]["avg_m"].numpy()).all()
    want = decoder.flat_params(convert.decoder_params_from_reference(
        jax.tree.map(np.asarray, ref["global_params"]), cfg, "cpu"))
    got = port["global_params"]
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=0, atol=PARAM_ATOL, err_msg=k)
    # the run trained the routed experts
    routed = [k for k in got if k.endswith("w_gate") and "shared" not in k]
    assert routed and any(not torch.equal(got[k], params0[k]) for k in routed)


def tree_lane(tree, i):
    return {k: tree_lane(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


def tree_stack(tree, n):
    return {k: tree_stack(v, n) if isinstance(v, dict) else v.unsqueeze(0).expand((n,) + v.shape).contiguous()
            for k, v in tree.items()}


def tree_leaves(tree, prefix=""):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from tree_leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
@pytest.mark.parametrize("arch", ROUTED)
def test_vmap_grad_of_apply_moe_equals_a_loop_bit_for_bit(arch, capacity_factor):
    """Two lanes of one layer's params, each its own 64 tokens: the batched
    gradient of a loss through the output and the aux loss equals each
    lane's own gradient exactly, routing and drops included."""
    from torch.func import grad, vmap

    cfg = dataclasses.replace(reduced(get_config(arch)), capacity_factor=capacity_factor)
    g = torch.Generator().manual_seed(0)
    p = moe.init_moe(g, cfg, torch.float32)
    lanes = tree_stack(p, 2)
    lanes = {k: v * (1 + 0.1 * torch.randn(v.shape, generator=g)) if not isinstance(v, dict) else v
             for k, v in lanes.items()}
    xs = torch.randn(2, 64, cfg.d_model, generator=g)

    def loss(p, x):
        y, aux = moe.apply_moe(cfg, p, x[None])
        return (y ** 2).mean() + aux

    batched = vmap(grad(loss))(lanes, xs)
    dropped = 0
    for i in range(2):
        one = grad(loss)(tree_lane(lanes, i), xs[i])
        for (name, a), (_, b) in zip(tree_leaves(one), tree_leaves(tree_lane(batched, i))):
            assert torch.equal(a, b), (name, (a - b).abs().max().item())
        r = moe.route(cfg, tree_lane(lanes, i), xs[i][None])
        dropped += r.keep.numel() - int(r.keep.sum())
    if capacity_factor < 1:
        assert dropped > 0  # the drop path ran
