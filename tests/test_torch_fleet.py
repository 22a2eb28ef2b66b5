"""The port's ``run_fleet`` (``core/fleet.py``) against its solo
``run_simulation`` and the JAX package, at the sizes of ``tests/test_fleet.py``
(``TINY_CNN``, N = 16 and 64, 40 samples a client, alpha 0.5, T=4 epochs,
k=3), on the port's synthetic data, which both packages read.

One gloo spawn of 4 ranks runs every fleet case (``tests/_torch_fleet_worker.py``):
the default configuration (vaoi, bernoulli, compacted) at N=16 over 1, 2 and 4
shards and at N=64 over 4; the other four policies; the dense path
(``compact=False``, and fedavg, which is always dense); and phase 9a's three
scenario combinations of ``chip_smoke.py``.  Each case starts from the
reference's initial model and replays the reference's key chains
(``tests/_torch_replay.py``), so the port's fleet, the port's solo run and
the JAX package's solo run consume the same draws.  Two child processes run
the JAX package meanwhile: every solo run, and its own 4-device
``run_fleet(use_kernel=True)`` (virtual CPU devices, Pallas in interpret
mode) on the default N=16 configuration.

Held to, per case: the slot dynamics and channel counts (energy, starts,
uploads, deliveries, failures, drops, retries), the ages and their mean,
the selections and the carry's integer fields and scenario state (the ranks'
rows gathered) exactly; params within 1e-5 on the default configuration
(which the JAX fleet is held to as well) and within the reference's own
``atol=1e-2`` (``tests/test_fleet.py``) elsewhere; avg_m within 1e-5; f1
within the reference's 0.1 (an argmax over 100 test images).
"""
import json
import os
import pickle
import subprocess
import sys
import textwrap
import threading
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import _torch_fleet_worker as worker  # noqa: E402
from _torch_replay import replay_draws  # noqa: E402
from repro.configs.cifar_cnn import CNNConfig  # noqa: E402
from repro.core import EHFLConfig, init_carry  # noqa: E402
from repro.fl import cnn_backend  # noqa: E402
from repro_torch.checkpoint.convert import params_from_reference, params_to_reference  # noqa: E402
from repro_torch.configs import CNNConfig as TCNNConfig  # noqa: E402
from repro_torch.core import EHFLConfig as TEHFLConfig  # noqa: E402
from repro_torch.core import fleet  # noqa: E402
from repro_torch.core import simulator as tsim  # noqa: E402
from repro_torch.data import make_federated_dataset  # noqa: E402
from repro_torch.fl import cnn_backend as t_cnn_backend  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
BASE = dict(epochs=4, slots_per_epoch=12, kappa=8, p_bc=0.6, k=3, mu=0.1, e_max=13, eval_every=4, probe_size=10)
COMBOS = {
    "markov_drift_fading": dict(harvest="markov", stream="drift", stream_params=(("period", 3.0),), channel="fading"),
    "hetero_arrival_erasure": dict(harvest="hetero", stream="arrival", channel="erasure",
                                   channel_params=(("p_loss", 0.3), ("concentration", 1.0))),
    "diurnal_shift_aloha": dict(harvest="diurnal", harvest_params=(("period", 60.0),), stream="shift",
                                stream_params=(("period", 3.0),), channel="aloha",
                                channel_params=(("num_channels", 2.0),)),
}
# (name, N, config, shard counts)
CASES = [
    ("default", 16, {}, (1, 2, 4)),
    ("default", 64, {}, (4,)),
    ("vaoi_soft", 16, dict(policy="vaoi_soft"), (4,)),
    ("fedavg", 16, dict(policy="fedavg"), (2,)),
    ("fedbacys", 16, dict(policy="fedbacys"), (4,)),
    ("fedbacys_odd", 64, dict(policy="fedbacys_odd"), (4,)),
    ("dense_vaoi", 16, dict(compact=False), (2,)),
    *[(name, 16, kw, (4,)) for name, kw in COMBOS.items()],
]
IDS = [f"{name}-N{n}-{s}shards" for name, n, _, shards in CASES for s in shards]
DEFAULT_ATOL, REFERENCE_ATOL, AVG_M_ATOL, F1_ATOL = 1e-5, 1e-2, 1e-5, 0.1
EXACT_METRICS = ("energy", "n_started", "n_uploaded", "n_delivered", "n_failed", "n_dropped", "avg_age")
PORT_ONLY_METRICS = ("selected", "n_retried", "n_resent", "f1_epochs", "total_energy")
EXACT_CARRY = ("age", "battery", "pending", "counter", "retries", "backoff")
# the JAX package's runs, in a child process beside the port's: the 4-device
# fleet (virtual CPU devices, set before jax is imported) or every solo run
JAX_CHILD = textwrap.dedent("""
    import os, pickle, sys
    mode, job, out = sys.argv[1:]
    if mode == "fleet":
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, numpy as np
    from repro.configs.cifar_cnn import CNNConfig
    from repro.core import EHFLConfig, run_simulation
    from repro.core.fleet import run_fleet
    from repro.fl import cnn_backend
    job = pickle.load(open(job, "rb"))
    backend = cnn_backend(CNNConfig(**job["tiny"]))
    rows = {}
    for key, (n, kw) in job["configs"].items():
        with np.load(job["data"][n]) as z:
            data = {k: jax.numpy.asarray(z[k]) for k in z.files}
        cfg = EHFLConfig(num_clients=n, **job["base"], **kw)
        if mode == "fleet":
            r = run_fleet(cfg, backend, data, use_kernel=True)
            assert r["num_shards"] == 4, r["num_shards"]
        else:
            r = run_simulation(cfg, backend, data)
        rows[key] = {"metrics": {k: np.asarray(v) for k, v in r["metrics"].items()},
                     "global_params": {k: np.asarray(v) for k, v in r["global_params"].items()},
                     "carry": {f: np.asarray(getattr(r["carry"], f)) for f in job["exact"]}}
    pickle.dump(rows, open(out, "wb"))
""")


def start_jax(mode, tmp, configs, data_paths):
    job = tmp / f"jax_{mode}.pkl"
    job.write_bytes(pickle.dumps(dict(tiny=worker.TINY, base=BASE, configs=configs, data=data_paths,
                                      exact=EXACT_CARRY)))
    return subprocess.Popen(
        [sys.executable, "-c", JAX_CHILD, mode, str(job), str(tmp / f"jax_{mode}.out")],
        env={**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu"},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )


def finish_jax(proc, mode, tmp):
    log, _ = proc.communicate(timeout=900)
    assert proc.returncode == 0, log
    return pickle.loads((tmp / f"jax_{mode}.out").read_bytes())


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Hundreds of small ops per epoch: one intra-op thread each, so that
    parallel test workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case: the port's fleet (rank results), the port's solo run and
    the JAX package's solo run, from the same data, draws and initial model;
    and the JAX package's 4-device fleet on the default N=16 configuration."""
    tmp = tmp_path_factory.mktemp("fleet")
    data, data_paths = {}, {}
    for n in sorted({n for _, n, _, _ in CASES}):
        data[n] = {k: v.numpy() for k, v in make_federated_dataset(
            0, num_clients=n, samples_per_client=40, alpha=0.5, test_size=100, image_size=16, device="cpu").items()}
        data_paths[n] = str(tmp / f"data{n}.npz")
        np.savez(data_paths[n], **data[n])
    configs = {(name, n): (n, kw) for name, n, kw, _ in CASES}
    jax_solo = start_jax("solo", tmp, configs, data_paths)
    jax_fleet = start_jax("fleet", tmp, {("default", 16): (16, {})}, data_paths)
    backend = cnn_backend(CNNConfig(**worker.TINY))
    jobs, refs = [], {}
    for name, n, kw, shards in CASES:
        cfg = EHFLConfig(num_clients=n, **BASE, **kw)
        params = params_from_reference(np_tree(init_carry(cfg, backend).global_params), CPU)
        draws = replay_draws(cfg, backend, 40)
        refs[(name, n)] = dict(tcfg=TEHFLConfig(num_clients=n, **BASE, **kw), params=params, draws=draws)
        jobs += [dict(kind="fleet", shards=s, n=n, cfg=dict(num_clients=n, **BASE, **kw), data=data_paths[n],
                      params=params, draws=draws) for s in shards]
    results = {}
    thread = threading.Thread(target=lambda: results.update(ranks=worker.run_job(jobs, tmp)))
    thread.start()
    for (name, n), ref in refs.items():  # the port's solo runs while the ranks work
        ref["port"] = tsim.run_simulation(ref["tcfg"], t_cnn_backend(TCNNConfig(**worker.TINY)), data[n],
                                          draws=ref["draws"], params=ref["params"], device="cpu")
    thread.join(timeout=900)
    assert "ranks" in results, "the fleet's ranks did not finish"
    for key, row in finish_jax(jax_solo, "solo", tmp).items():
        refs[key]["jax"] = row
    refs["jax_fleet"] = finish_jax(jax_fleet, "fleet", tmp)[("default", 16)]
    by_id, i = {}, 0
    for name, n, _, shards in CASES:
        for s in shards:
            by_id[f"{name}-N{n}-{s}shards"] = (refs[(name, n)], [results["ranks"][r][i] for r in range(s)], s)
            i += 1
    return by_id, refs


def max_param_err(got, want):
    return max(float(np.abs(np.asarray(got[k], np.float64) - np.asarray(want[k], np.float64)).max()) for k in want)


@pytest.mark.parametrize("case_id", IDS)
def test_fleet_matches_solo_and_reference(runs, case_id):
    by_id, _ = runs
    ref, ranks, shards = by_id[case_id]
    cfg = ref["tcfg"]
    atol = DEFAULT_ATOL if case_id.startswith("default") else REFERENCE_ATOL
    got, port, want = ranks[0], ref["port"], ref["jax"]
    assert all(r["num_shards"] == shards for r in ranks)
    for r in ranks[1:]:  # every rank returns the same fleet-wide metrics and global model
        for k, v in got["metrics"].items():
            if k != "epoch_s":
                assert torch.equal(r["metrics"][k], v), k
        assert all(torch.equal(r["global_params"][k], v) for k, v in got["global_params"].items())
    gm, pm, wm = got["metrics"], port["metrics"], want["metrics"]
    for k in EXACT_METRICS:
        assert torch.equal(gm[k], pm[k]), f"{k} against the port's solo run"
        np.testing.assert_array_equal(gm[k].numpy(), np.asarray(wm[k]), err_msg=f"{k} against the reference")
    for k in PORT_ONLY_METRICS:
        assert torch.equal(gm[k], pm[k]), f"{k} against the port's solo run"
    assert gm["selected"].shape == (cfg.epochs, cfg.num_clients)
    np.testing.assert_allclose(gm["avg_m"].numpy(), np.asarray(wm["avg_m"]), rtol=0, atol=AVG_M_ATOL)
    np.testing.assert_allclose(gm["f1"].numpy(), np.asarray(wm["f1"]), rtol=0, atol=F1_ATOL)
    carry = fleet.gather_carry(ref["tcfg"], [tsim.EpochCarry(**r["carry"]) for r in ranks])
    for f in EXACT_CARRY + ("harvest", "stream", "channel"):
        a, b = getattr(carry, f), getattr(port["carry"], f)
        assert (a is None and b is None) or torch.equal(torch.as_tensor(a), torch.as_tensor(b)), f
    for f in EXACT_CARRY:
        np.testing.assert_array_equal(getattr(carry, f).numpy(), want["carry"][f], err_msg=f)
    params = params_to_reference(got["global_params"])
    errs = {"port_solo": max_param_err(params, params_to_reference(port["global_params"])),
            "reference_solo": max_param_err(params, want["global_params"])}
    print(json.dumps({"case": case_id, "params_max_abs_err": errs, "atol": atol}))  # shown with -s
    assert max(errs.values()) <= atol, errs


def test_port_fleet_matches_the_reference_fleet(runs):
    """The port's 4-rank fleet against the JAX package's own 4-device
    ``run_fleet(use_kernel=True)`` on the same draws: integers exactly,
    params within 1e-5."""
    by_id, refs = runs
    _, ranks, _ = by_id["default-N16-4shards"]
    jf = refs["jax_fleet"]
    for k in EXACT_METRICS:
        np.testing.assert_array_equal(ranks[0]["metrics"][k].numpy(), jf["metrics"][k], err_msg=k)
    carry = fleet.gather_carry(TEHFLConfig(num_clients=16), [tsim.EpochCarry(**r["carry"]) for r in ranks])
    for f in EXACT_CARRY:
        np.testing.assert_array_equal(getattr(carry, f).numpy(), jf["carry"][f], err_msg=f)
    params = params_to_reference(ranks[0]["global_params"])
    assert max_param_err(params, jf["global_params"]) <= DEFAULT_ATOL
