"""``chip_smoke.py``'s teacher-forced comparison of an EHFL epoch (phase
9a's CPU check), rehearsed on the CPU at ``tiny_world``'s size with the CPU
standing in for the card: from one device to itself every forced SGD step
agrees exactly, and a card whose SGD step is wrong fails the check.

The phase's profiled epoch needs a card, so ``profile_run`` is stubbed."""
import dataclasses
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke as cs  # noqa: E402
from repro_torch.configs import CNNConfig  # noqa: E402
from repro_torch.core import simulator as sim  # noqa: E402
from repro_torch.core.draws import TorchDraws  # noqa: E402
from repro_torch.data import make_federated_dataset  # noqa: E402
from repro_torch.fl import cnn_backend  # noqa: E402

CPU = torch.device("cpu")
TINY = CNNConfig(name="tiny", image_size=16, conv_channels=(4, 4, 8, 8, 8, 8), fc_dims=(32, 16))
CFG = sim.EHFLConfig(
    num_clients=8, epochs=2, slots_per_epoch=12, kappa=8, p_bc=0.8, k=3, mu=0.1, e_max=13,
    eval_every=2, probe_size=10, policy="vaoi", seed=0,
)
EXACT = cs.EXACT + ("retries", "backoff", "harvest", "stream", "channel")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world():
    data = make_federated_dataset(0, num_clients=8, samples_per_client=40, test_size=30, device="cpu", image_size=16)
    return cnn_backend(TINY), data


@pytest.fixture(autouse=True)
def no_profile(monkeypatch):
    monkeypatch.setattr(cs, "profile_run", lambda *a, **k: None)


def scenario(kw):
    kw = dict(kw)
    if kw.get("harvest") == "markov":  # at p_bc 0.8 markov's default p_on holds every phase ON
        kw["harvest_params"] = (("p_on", 1.0),)
    return dataclasses.replace(CFG, **kw)


def compare(world, cfg):
    backend, data = world
    return cs.phase_cpu_vs_gpu(torch, sim, cfg, backend, data, TorchDraws, CPU, exact=EXACT,
                               exact_metrics=cs.EXACT_METRICS + ("n_failed", "n_dropped"), forced=True)


@pytest.mark.parametrize("name", [name for name, _ in cs.SCENARIO_RUNS])
def test_forced_comparison_on_one_device_agrees_exactly(world, name):
    row = compare(world, scenario(dict(cs.SCENARIO_RUNS)[name]))
    assert row["step_max_abs_err"] == 0.0
    assert all(v == 0.0 for v in row["max_abs_err"].values())
    assert [e["sgd_steps"] for e in row["per_epoch"]] == [CFG.kappa] * CFG.epochs
    assert all(e["step_max_abs_update"] > 0.0 for e in row["per_epoch"])
    assert row["view_indices_compared"] == CFG.epochs * 8 * 40


@pytest.mark.parametrize("fault", ["lr_scaled", "step_skipped"])
def test_forced_comparison_fails_a_wrong_step(world, monkeypatch, fault):
    """The first (card) epoch of each forced pair takes a wrong SGD step."""
    real_wrap = cs.wrapped_sgd_update
    calls = []

    def wrong(real):
        if fault == "lr_scaled":
            return lambda p, grads, lr: real(p, grads, 1.5 * lr)
        return lambda p, grads, lr: p

    def faulty(sim_, wrap):
        calls.append(wrap)
        card = len(calls) % 2 == 1
        return real_wrap(sim_, (lambda real: wrap(wrong(real))) if card else wrap)

    monkeypatch.setattr(cs, "wrapped_sgd_update", faulty)
    with pytest.raises(AssertionError, match="SGD step from the GPU's weights"):
        compare(world, scenario(dict(cs.SCENARIO_RUNS)["hetero_arrival_erasure"]))
