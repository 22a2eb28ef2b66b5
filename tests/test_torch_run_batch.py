"""The port's ``run_batch`` (the seed axis) against the JAX package's on
``tiny_world``: 2 seeds x T=6 epochs with ``eval_every=4``, so the eval
schedule has a full chunk (epoch 4) and a tail (epoch 6).  The config runs
hetero harvest and a Beta erasure channel, so per-client scenario state
rides the stacked carry.  Each seed starts from the reference's initial
model for that seed and replays that seed's key chains
(``tests/_torch_replay.py``).

Tolerances as in ``tests/test_torch_simulator.py``: integer dynamics
exactly, params to 5e-6, f1 to 1e-6.  Seed i of the port's batch must
equal a solo port run of that seed bit for bit (both on the CPU).

The seeds are ones whose trajectories are not chaotic at this size: over
seeds 0-11 the reference's vmapped batch and its solo runs agree to 1.8e-7
in params, except at seed 11, where they part by 1.05e-3 (from epoch 3,
where one client's local SGD amplifies a 1e-7 difference in the global
model to 6e-5) and by one of 100 test predictions in f1; the port lands on
either side there depending on its thread count, so no implementation can
be held to 5e-6 on that trajectory.  The reference's own
``tests/test_run_batch.py`` holds its batch and solo runs to integer
dynamics and f1 to 1e-4.  The injected Beta rates are held to the
reference's solo draw, which the batch's vmapped draw can miss by an ulp."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from _torch_replay import replay_draws  # noqa: E402
from repro.configs.cifar_cnn import CNNConfig  # noqa: E402
from repro.core import EHFLConfig, init_carry, run_batch  # noqa: E402
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
    num_clients=8, epochs=6, slots_per_epoch=12, kappa=8, p_bc=0.8,
    k=3, mu=0.1, e_max=13, eval_every=4, probe_size=10, policy="vaoi",
    harvest="hetero", channel="erasure", channel_params=(("p_loss", 0.3), ("concentration", 1.0)),
)
SEEDS = (3, 10)
PARAM_ATOL, FLOAT_RTOL, F1_ATOL = 5e-6, 1e-4, 1e-6
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


@pytest.fixture(scope="module")
def world():
    data = make_federated_dataset(
        jax.random.PRNGKey(0), num_clients=8, samples_per_client=40, alpha=0.5,
        test_size=100, image_size=16,
    )
    cfg = EHFLConfig(**CFG)
    backend = cnn_backend(CNNConfig(**TINY))
    draws = [replay_draws(cfg, backend, 40, seed=s) for s in SEEDS]
    carries = [init_carry(cfg, backend, s) for s in SEEDS]
    params = [params_from_reference(jax.tree.map(np.asarray, c.global_params), CPU) for c in carries]
    np_data = {k: np.asarray(v) for k, v in data.items()}
    return cfg, backend, data, np_data, draws, params, carries


@pytest.fixture(scope="module")
def ref_batch(world):
    cfg, backend, data, *_ = world
    return run_batch(cfg, backend, data, list(SEEDS))


@pytest.fixture(scope="module")
def port_batch(world):
    *_, np_data, draws, params, _ = world
    return tsim.run_batch(
        TEHFLConfig(**CFG), t_cnn_backend(TCNNConfig(**TINY)), np_data, SEEDS,
        draws=draws, params=params, device="cpu",
    )


def test_run_batch_shapes(port_batch):
    R, T, N = len(SEEDS), CFG["epochs"], CFG["num_clients"]
    m = port_batch["metrics"]
    for k in EXACT_METRICS + ("avg_m", "epoch_s", "n_retried", "n_resent"):
        assert m[k].shape == (R, T), k
    assert m["selected"].shape == (R, T, N)
    assert m["f1"].shape == (R, 2) and m["total_energy"].shape == (R,)
    assert m["f1_epochs"].tolist() == [4, 6]  # one full eval chunk, then the tail
    np.testing.assert_array_equal(m["total_energy"].numpy(), m["energy"].sum(1).numpy())
    one = tsim.init_carry(TEHFLConfig(**CFG), t_cnn_backend(TCNNConfig(**TINY)), device="cpu")
    for k, v in one.global_params.items():
        assert port_batch["global_params"][k].shape == (R,) + v.shape
    c = port_batch["carry"]
    assert c.msg_params["fc0_w"].shape == (R, N) + one.global_params["fc0_w"].shape
    for f in EXACT_CARRY + ("harvest", "channel"):  # hetero rates, erasure rates
        assert getattr(c, f).shape == (R, N), f
    assert c.h.shape == (R, N, one.h.shape[1]) and c.stream is None


def test_run_batch_matches_reference(world, port_batch, ref_batch):
    pm, rm = port_batch["metrics"], ref_batch["metrics"]
    for k in EXACT_METRICS:
        np.testing.assert_array_equal(pm[k].numpy(), np.asarray(rm[k]), err_msg=k)
    np.testing.assert_array_equal(pm["f1_epochs"].numpy(), np.asarray(rm["f1_epochs"]))
    np.testing.assert_allclose(pm["f1"].numpy(), np.asarray(rm["f1"]), atol=F1_ATOL)
    np.testing.assert_array_equal(pm["total_energy"].numpy(), np.asarray(rm["total_energy"]))
    pc, rc = port_batch["carry"], ref_batch["carry"]
    for f in EXACT_CARRY:
        np.testing.assert_array_equal(getattr(pc, f).numpy(), np.asarray(getattr(rc, f)), err_msg=f)
    assert pm["n_failed"].sum() > 0
    want_params = jax.tree.map(np.asarray, ref_batch["global_params"])
    for i, init in enumerate(world[-1]):
        np.testing.assert_array_equal(pc.harvest[i].numpy(), np.asarray(init.harvest[0]))
        np.testing.assert_array_equal(pc.channel[i].numpy(), np.asarray(init.channel[0]))
        got = params_to_reference({k: v[i] for k, v in port_batch["global_params"].items()})
        for k, want in want_params.items():
            np.testing.assert_allclose(got[k], want[i], rtol=FLOAT_RTOL, atol=PARAM_ATOL, err_msg=f"seed {i} {k}")


def test_run_batch_seed_equals_solo(world, port_batch):
    """Seed i of the batch is ``run_simulation(replace(cfg, seed=seeds[i]))``
    with that seed's draws and init, bit for bit."""
    *_, np_data, draws, params, _ = world
    for i, seed in enumerate(SEEDS):
        solo = tsim.run_simulation(
            dataclasses.replace(TEHFLConfig(**CFG), seed=seed), t_cnn_backend(TCNNConfig(**TINY)), np_data,
            draws=draws[i], params=params[i], device="cpu",
        )
        for k, v in solo["metrics"].items():
            if k not in ("epoch_s", "f1_epochs"):
                assert torch.equal(port_batch["metrics"][k][i], v), k
        for k, v in solo["global_params"].items():
            assert torch.equal(port_batch["global_params"][k][i], v), k
        for f in EXACT_CARRY + ("h", "harvest", "channel"):
            assert torch.equal(getattr(port_batch["carry"], f)[i], getattr(solo["carry"], f)), f


def test_run_batch_default_draws_and_clock():
    """Without ``draws`` each seed takes ``TorchDraws(seed)``: the batch
    equals solo runs of those seeds; the diurnal slot clock (a Python int
    per run) stacks to an (R,) tensor."""
    cfg = TEHFLConfig(**{**CFG, "epochs": 2, "eval_every": 2, "harvest": "diurnal"})
    backend = t_cnn_backend(TCNNConfig(**TINY))
    from repro_torch.data import make_federated_dataset as t_make_data

    data = t_make_data(0, num_clients=8, samples_per_client=40, test_size=20, image_size=16, device="cpu")
    batch = tsim.run_batch(cfg, backend, data, [0, 5], device="cpu")
    assert batch["carry"].harvest.tolist() == [2 * CFG["slots_per_epoch"]] * 2
    for i, seed in enumerate((0, 5)):
        solo = tsim.run_simulation(dataclasses.replace(cfg, seed=seed), backend, data, device="cpu")
        for k, v in solo["global_params"].items():
            assert torch.equal(batch["global_params"][k][i], v), k
        assert torch.equal(batch["metrics"]["selected"][i], solo["metrics"]["selected"])
    with pytest.raises(ValueError, match="2 seeds"):
        tsim.run_batch(cfg, backend, data, [0, 5], draws=[None], device="cpu")


def test_torch_draws_differ_across_seeds():
    """Each seed draws its own epochs (torch's CPU generator keeps only 32
    bits of its seed, which once gave every seed seed 0's draws), and seed
    0's epoch t is still seeded with t."""
    from repro_torch.core.draws import TorchDraws, epoch_seed

    cfg = TEHFLConfig(**CFG)
    epochs = [[TorchDraws(s).epoch(t, cfg, 40, CPU) for t in range(3)] for s in (0, 1, 2)]
    for a in range(3):
        for b in range(a + 1, 3):
            for t in range(3):
                assert not torch.equal(epochs[a][t].noise, epochs[b][t].noise)
                assert not torch.equal(epochs[a][t].perms, epochs[b][t].perms)
    g = torch.Generator().manual_seed(2)
    assert torch.equal(epochs[0][2].noise, torch.rand(CFG["num_clients"], generator=g) * 1e-3)
    seeds = {epoch_seed(s, t) for s in range(64) for t in range(1000)}
    assert len(seeds) == 64 * 1000
