"""The port's drivers beside the package: ``benchmarks/ehfl_grid_torch.py``
with its figure modules, and ``examples/quickstart_torch.py``, on the CPU.

One tiny cell of the torch grid (2 seeds x T = 4) against
``benchmarks.ehfl_grid.run_cell`` on the JAX cell's data, with each seed's
key chain replayed into the port's draws (``tests/_torch_replay.py``) and
the reference's initial params carried over: the counts and energy exactly,
f1 and the age trajectory within 1e-6 (``tests/test_torch_run_batch.py``'s
tolerances).  Both grids' caches point at a temp directory, so nothing is
written under ``experiments/``.  The figure modules must give the JAX
modules' rows on the same cells; every new entry point raises without CUDA
unless told to run on the CPU.
"""
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from _torch_replay import replay_draws  # noqa: E402
from benchmarks import ablation_mu as jablation  # noqa: E402
from benchmarks import ablation_mu_torch as tablation  # noqa: E402
from benchmarks import ehfl_grid as jgrid  # noqa: E402
from benchmarks import ehfl_grid_torch as tgrid  # noqa: E402
from benchmarks import fig4_f1 as jfig4  # noqa: E402
from benchmarks import fig4_f1_torch as tfig4  # noqa: E402
from benchmarks import fig5_vaoi as jfig5  # noqa: E402
from benchmarks import fig5_vaoi_torch as tfig5  # noqa: E402
from benchmarks import fig6_energy as jfig6  # noqa: E402
from benchmarks import fig6_energy_torch as tfig6  # noqa: E402
from repro.core import EHFLConfig as JEHFLConfig  # noqa: E402
from repro.core import init_carry as jinit_carry  # noqa: E402
from repro_torch.checkpoint.convert import params_from_reference  # noqa: E402

sys.path.insert(0, str(ROOT / "examples"))
import quickstart_torch  # noqa: E402

F1_ATOL, AGE_ATOL = 1e-6, 1e-6
TINY = dict(num_clients=6, samples=20, epochs=4, eval_every=2, k=2, seeds=(0, 1))
CELL = ("vaoi", 0.1, 1.0)
EXACT = ("seeds", "f1_epochs", "energy_per_epoch", "total_energy", "total_energy_per_seed", "n_started", "n_uploaded")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    """The tiny cell through both grids, each caching under a temp dir."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jgrid, "CACHE", tmp_path_factory.mktemp("jax_grid"))
    mp.setattr(tgrid, "CACHE", tmp_path_factory.mktemp("torch_grid"))
    try:
        policy, alpha, p_bc = CELL
        ref = jgrid.run_cell(policy, alpha, p_bc, TINY)
        jdata = jgrid._bench_data(TINY["num_clients"], TINY["samples"], alpha, 0)
        jcfg = JEHFLConfig(**vars(tgrid.cell_config(policy, alpha, p_bc, TINY)))
        backend = jgrid._bench_backend()
        draws = [replay_draws(jcfg, backend, TINY["samples"], seed=s) for s in TINY["seeds"]]
        params = [params_from_reference(jax.tree.map(np.asarray, jinit_carry(jcfg, backend, s).global_params),
                                        torch.device("cpu")) for s in TINY["seeds"]]
        port = tgrid.run_cell(policy, alpha, p_bc, TINY, data={k: np.asarray(v) for k, v in jdata.items()},
                              draws=draws, params=params, device="cpu")
        written = sorted(p.name for p in tgrid.CACHE.iterdir())
    finally:
        mp.undo()
    return ref, port, written


def test_grid_cell_counts_match_the_jax_grid_exactly(cells):
    ref, port, _ = cells
    assert sorted(port) == sorted(ref)  # the figure modules read the same fields
    for k in EXACT:
        assert port[k] == ref[k], k
    assert port["n_started"] > 0


def test_grid_cell_floats_match_the_jax_grid(cells):
    ref, port, written = cells
    np.testing.assert_allclose(port["f1_per_seed"], ref["f1_per_seed"], rtol=0, atol=F1_ATOL)
    np.testing.assert_allclose(port["f1"], ref["f1"], rtol=0, atol=F1_ATOL)
    np.testing.assert_allclose(port["f1_std"], ref["f1_std"], rtol=0, atol=F1_ATOL)
    np.testing.assert_allclose(port["avg_age"], ref["avg_age"], rtol=0, atol=AGE_ATOL)
    assert written == []  # a cell on given inputs is not cached


def fake_record(policy, alpha, p_bc, scenario="bernoulli"):
    """A cell record with the grid's keys, its numbers a function of the cell."""
    x = (hash((policy, alpha, p_bc, scenario)) % 997) / 997.0
    return {"policy": policy, "alpha": alpha, "p_bc": p_bc, "scenario": scenario, "seeds": [0, 1],
            "wall_s": 1.0 + x, "f1": [0.1, 0.2 + x / 2], "f1_std": [0.0, 0.01], "f1_epochs": [6, 12],
            "avg_age": [x, 2 * x, 0.5], "energy_per_epoch": [3.0, 4.0], "total_energy": 100.0 * (1 + x),
            "n_started": 4.0, "n_uploaded": 3.0}


def fake_grid(quick=True, seed=0, device=None):
    st = jgrid.grid_settings(quick)
    return {(pol, a, p): fake_record(pol, a, p) for a in st["alphas"] for p in st["pbcs"]
            for pol in jgrid.POLICIES}, st


def fake_scenarios(quick=True, seed=0, policy="vaoi", device=None):
    st = jgrid.grid_settings(quick)
    return {s: fake_record(policy, st["alphas"][0], st["pbcs"][0], s) for s in tgrid.SCENARIOS}, st


@pytest.mark.parametrize("jmod,tmod", [(jfig4, tfig4), (jfig5, tfig5), (jfig6, tfig6)],
                         ids=["fig4", "fig5", "fig6"])
def test_figure_rows_are_the_jax_modules_rows(monkeypatch, jmod, tmod):
    for mod in (jmod, tmod):
        monkeypatch.setattr(mod, "run_grid", fake_grid)
        if hasattr(mod, "run_scenarios"):
            monkeypatch.setattr(mod, "run_scenarios", fake_scenarios)
    assert tgrid.grid_settings(True) == jgrid.grid_settings(True)
    assert tgrid.grid_settings(False) == jgrid.grid_settings(False)
    assert tgrid.POLICIES == jgrid.POLICIES and tuple(tgrid.SCENARIOS) == tuple(jgrid.SCENARIOS)
    want, got = jmod.run(True), tmod.run(True, device="cpu")
    assert got == want and len(got) > 0


def test_ablation_rows_are_the_jax_modules_rows(monkeypatch, tmp_path):
    """Both ablations read the same cached records: the rows' names and
    fields agree."""
    import json

    monkeypatch.setattr(jgrid, "CACHE", tmp_path)
    monkeypatch.setattr(tgrid, "CACHE", tmp_path)
    st = jgrid.grid_settings(True)
    for i, (policy, mu) in enumerate(tablation.SETTINGS):
        rec = {"f1": 0.1 * i, "energy": 10.0 * i, "mean_age": 0.5 * i}
        (tmp_path / f"abl_{policy}_mu{mu}_N{st['num_clients']}_T{st['epochs']}.json").write_text(json.dumps(rec))
    want, got = jablation.run(True), tablation.run(True, device="cpu")
    assert got == want and [r["name"] for r in got][-1] == "ablation/vaoi_soft/mu0.5"


def test_quickstart_runs_a_cut_on_the_cpu(capsys):
    rows = quickstart_torch.main(["--device", "cpu", "--clients", "6", "--samples", "20", "--epochs", "2",
                                  "--gallery-epochs", "2", "--policies", "vaoi", "fedavg", "--scenarios",
                                  "bernoulli", "markov"])
    assert [r["policy"] for r in rows["policies"]] == ["vaoi", "fedavg"]
    assert [r["scenario"] for r in rows["scenarios"]] == ["bernoulli", "markov"]
    for r in rows["policies"] + rows["scenarios"]:
        f1 = r["f1"] if "f1" in r else r["f1_mean"]
        assert 0.0 <= f1 <= 1.0 and r["total_energy"] >= 0
    out = capsys.readouterr().out
    assert "fedavg" in out and "markov" in out


ENTRY_POINTS = {
    "quickstart": lambda: quickstart_torch.main(["--clients", "6", "--epochs", "1"]),
    "ehfl_grid_main": lambda: tgrid.main(["--quick"]),
    "ehfl_grid_run_cell": lambda: tgrid.run_cell(*CELL, TINY),
    "fig4": lambda: tfig4.run(True),
    "fig5": lambda: tfig5.run(True),
    "fig6": lambda: tfig6.run(True),
    "ablation": lambda: tablation.run(True),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_points_raise_without_cuda_unless_told_cpu(monkeypatch, tmp_path, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(tgrid, "CACHE", tmp_path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ENTRY_POINTS[name]()
    assert not any(tmp_path.iterdir())
