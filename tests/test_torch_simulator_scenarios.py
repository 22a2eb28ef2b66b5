"""The port's Alg. 1 under the scenario axes against the JAX package on
``tiny_world`` (the world of ``tests/test_torch_simulator.py``).

Three combinations cover every non-default scenario, the ones
``chip_smoke.py`` phase 9a drives at paper width: markov + drift + fading,
hetero + arrival + erasure (p_loss 0.3, concentration 1.0), and diurnal
(period 60) + shift (period 4) + aloha (2 channels).  markov takes p_on =
1.0 here: at tiny_world's p_bc = 0.8 its default p_on = 0.8 would hold every
phase ON for good.  Both sides start from the reference's initial model and
consume the same draws, the reference's key chains replayed
(``tests/_torch_replay.py``); the reference runs its plain path epoch by
epoch.

Tolerances as in ``tests/test_torch_simulator.py``: integer dynamics,
selections, ages, retries, backoff and the channel's counts exactly;
scenario state exactly (float state bit for bit); params to 5e-6."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from _torch_replay import replay_draws  # noqa: E402
from repro.configs.cifar_cnn import CNNConfig  # noqa: E402
from repro.core import EHFLConfig, init_carry, make_epoch_fn  # noqa: E402
from repro.core import policies as jpol  # noqa: E402
from repro.data import make_federated_dataset  # noqa: E402
from repro.fl import cnn_backend  # noqa: E402
from repro_torch.checkpoint.convert import params_from_reference, params_to_reference  # noqa: E402
from repro_torch.configs import CNNConfig as TCNNConfig  # noqa: E402
from repro_torch.core import EHFLConfig as TEHFLConfig  # noqa: E402
from repro_torch.core import simulator as tsim  # noqa: E402
from repro_torch.fl import cnn_backend as t_cnn_backend  # noqa: E402

CPU = torch.device("cpu")
TINY = dict(name="tiny", image_size=16, conv_channels=(4, 4, 8, 8, 8, 8), fc_dims=(32, 16))
CFG = dict(
    num_clients=8, epochs=8, slots_per_epoch=12, kappa=8, p_bc=0.8,
    k=3, mu=0.1, e_max=13, eval_every=4, probe_size=10, policy="vaoi",
)
COMBOS = {
    "markov_drift_fading": dict(
        harvest="markov", harvest_params=(("p_on", 1.0),), stream="drift", channel="fading"
    ),
    "hetero_arrival_erasure": dict(
        harvest="hetero", stream="arrival", channel="erasure",
        channel_params=(("p_loss", 0.3), ("concentration", 1.0)),
    ),
    "diurnal_shift_aloha": dict(
        harvest="diurnal", harvest_params=(("period", 60.0),), stream="shift",
        stream_params=(("period", 4.0),), channel="aloha", channel_params=(("num_channels", 2.0),),
    ),
}
PARAM_ATOL, FLOAT_RTOL = 5e-6, 1e-4
EXACT_METRICS = ("n_started", "n_uploaded", "energy", "avg_age", "n_delivered", "n_failed", "n_dropped")
EXACT_CARRY = ("battery", "pending", "counter", "age", "retries", "backoff")

@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Hundreds of small ops per epoch: one intra-op thread each (before the
    module's fixtures run), so that parallel test workers do not
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def world():
    data = make_federated_dataset(
        jax.random.PRNGKey(0), num_clients=8, samples_per_client=40, alpha=0.5,
        test_size=100, image_size=16,
    )
    return cnn_backend(CNNConfig(**TINY)), data, {k: np.asarray(v) for k, v in data.items()}


@pytest.fixture(scope="module", params=list(COMBOS))
def runs(request, world):
    """(combo, reference per-epoch metrics and selections and final carry,
    the port's run, the port's draws and initial params)."""
    backend, data, np_data = world
    cfg = EHFLConfig(**CFG, **COMBOS[request.param])
    spec = jpol.make_policy(cfg.policy, num_clients=cfg.num_clients, k=cfg.k, num_groups=cfg.num_groups)
    epoch_fn = jax.jit(make_epoch_fn(cfg, backend, data))
    carry = init_carry(cfg, backend)
    params0 = params_from_reference(np_tree(carry.global_params), CPU)
    draws = replay_draws(cfg, backend, 40)
    ref = {"selected": [], **{k: [] for k in EXACT_METRICS}}
    for t in range(cfg.epochs):
        k_sel = jax.random.split(carry.key, 4)[0]
        ref["selected"].append(np.asarray(jpol.epoch_selection(spec, carry.age, jnp.int32(t), cfg.k, k_sel)))
        carry, ms = epoch_fn(carry, jnp.int32(t))
        for k in EXACT_METRICS:
            ref[k].append(np.asarray(ms[k]))
    tcfg = TEHFLConfig(**CFG, **COMBOS[request.param])
    port = tsim.run_simulation(
        tcfg, t_cnn_backend(TCNNConfig(**TINY)), np_data, draws=draws, params=params0, device="cpu"
    )
    return request.param, {k: np.stack(v) for k, v in ref.items()}, carry, port, draws, params0


def test_scenario_dynamics_match_reference_exactly(runs):
    combo, ref, rcarry, port, *_ = runs
    pm, pc = port["metrics"], port["carry"]
    np.testing.assert_array_equal(pm["selected"].numpy(), ref["selected"], err_msg="selected")
    for k in EXACT_METRICS:
        np.testing.assert_array_equal(pm[k].numpy(), ref[k], err_msg=k)
    for f in EXACT_CARRY:
        np.testing.assert_array_equal(getattr(pc, f).numpy(), np.asarray(getattr(rcarry, f)), err_msg=f)
    # n_uploaded counts attempts: each lands or fails
    np.testing.assert_array_equal((pm["n_delivered"] + pm["n_failed"]).numpy(), pm["n_uploaded"].numpy())
    # training, losses and delivered retransmissions all ran
    assert pm["n_started"].sum() > 0 and pm["n_failed"].sum() > 0 and pm["n_resent"].sum() > 0
    assert (pm["n_retried"] >= pm["n_resent"]).all()


def test_scenario_state_matches_reference(runs):
    combo, _, rcarry, port, *_ = runs
    pc = port["carry"]
    harvest, stream, channel = combo.split("_")
    if harvest == "diurnal":  # the slot clock
        assert pc.harvest == int(rcarry.harvest[0]) == CFG["epochs"] * CFG["slots_per_epoch"]
    else:  # markov phases, hetero rates
        np.testing.assert_array_equal(pc.harvest.numpy(), np.asarray(rcarry.harvest[0]))
    if stream in ("drift", "arrival"):  # mixtures, arrival counts
        np.testing.assert_array_equal(pc.stream.numpy(), np.asarray(rcarry.stream[0]))
    else:
        assert pc.stream is None
    if channel in ("erasure", "fading"):  # link rates, link phases
        np.testing.assert_array_equal(pc.channel.numpy(), np.asarray(rcarry.channel[0]))
    else:
        assert pc.channel is None


def test_scenario_params_match_reference(runs):
    _, _, rcarry, port, *_ = runs
    got, want = params_to_reference(port["global_params"]), np_tree(rcarry.global_params)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=FLOAT_RTOL, atol=PARAM_ATOL, err_msg=k)
    np.testing.assert_allclose(port["carry"].h.numpy(), np.asarray(rcarry.h), rtol=FLOAT_RTOL, atol=1e-6)


def test_scenario_dense_matches_compact(world, runs):
    """``compact=False`` trains all N clients; the default trains the k-slab.
    Under a lossy channel the delivery mask gates both FedAvg passes alike:
    same dynamics exactly, same model to fp32 rounding."""
    combo, _, _, port, draws, params0 = runs
    dense = tsim.run_simulation(
        TEHFLConfig(**CFG, **COMBOS[combo], compact=False), t_cnn_backend(TCNNConfig(**TINY)), world[2],
        draws=draws, params=params0, device="cpu",
    )
    for k in EXACT_METRICS + ("selected",):
        np.testing.assert_array_equal(dense["metrics"][k].numpy(), port["metrics"][k].numpy(), err_msg=k)
    for f in EXACT_CARRY:
        np.testing.assert_array_equal(getattr(dense["carry"], f).numpy(), getattr(port["carry"], f).numpy())
    for k, v in port["global_params"].items():
        np.testing.assert_allclose(dense["global_params"][k].numpy(), v.numpy(), rtol=1e-5, atol=1e-6)
