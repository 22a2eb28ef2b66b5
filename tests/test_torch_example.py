"""``examples/ehfl_cifar_torch.py``, the port's run of the paper's §V
experiment, on the CPU at a tiny size: a solo run and a two-seed sweep
under a lossy channel write the JAX example's files with its JSON keys;
without ``--device`` and without CUDA it fails rather than fall back;
``--fleet`` at 2 gloo ranks, under torchrun and started plainly, writes the
same files with a solo run's slot dynamics and ages; and ``--fleet`` with
``--num-seeds`` is refused, as in ``examples/ehfl_cifar.py``."""
import ast
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parent.parent
SMALL = ["--device", "cpu", "--clients", "4", "--rounds", "2", "--samples", "40", "--k", "2"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Hundreds of small ops per epoch: one intra-op thread each (before the
    module's fixtures run), so that parallel test workers do not
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def load_example():
    spec = importlib.util.spec_from_file_location("ehfl_cifar_torch", ROOT / "examples" / "ehfl_cifar_torch.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reference_metric_keys():
    """The keys of the dict that ``examples/ehfl_cifar.py`` writes to its
    metrics file (read from its source: running it would compile JAX)."""
    tree = ast.parse((ROOT / "examples" / "ehfl_cifar.py").read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "dumps":
            (arg,) = node.args
            return {k.value for k in arg.keys}
    raise AssertionError("no json.dumps in examples/ehfl_cifar.py")


@pytest.mark.parametrize(
    "extra, num_seeds",
    [([], 1), (["--num-seeds", "2", "--channel", "erasure", "--channel-params", "p_loss=0.5"], 2)],
    ids=["solo", "two_seeds_erasure"],
)
def test_example_writes_the_reference_files(tmp_path, extra, num_seeds):
    load_example().main(SMALL + extra + ["--out", str(tmp_path)])
    tag = "vaoi_bernoulli_static_a0.1_p0.1"
    model, metrics = tmp_path / f"{tag}_model.npz", tmp_path / f"{tag}_metrics.json"
    assert model.exists() and metrics.exists()
    got = json.loads(metrics.read_text())
    assert set(got) == reference_metric_keys()
    assert got["num_seeds"] == num_seeds and got["f1_epochs"] == [1, 2]
    assert len(got["energy"]) == 2 and all(0.0 <= f <= 1.0 for f in got["f1"])
    with np.load(model) as z:  # the JAX package's layout: HWIO conv kernels
        assert z["conv0_w"].shape == (3, 3, 3, 16) and np.isfinite(z["fc2_w"]).all()


def test_example_needs_cuda_without_device(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_example().main(["--clients", "4", "--rounds", "2", "--out", str(tmp_path)])


def test_example_fleet_names_the_roadmap(capsys):
    """``--fleet`` runs one seed: with ``--num-seeds 2`` it is refused,
    naming the two entry points (the refusal of ``examples/ehfl_cifar.py``)."""
    with pytest.raises(SystemExit):
        load_example().main(SMALL + ["--fleet", "--num-seeds", "2"])
    err = capsys.readouterr().err
    assert "--fleet runs a single seed" in err and "run_fleet" in err


FLEET = ["--clients", "4", "--rounds", "3", "--samples", "40", "--k", "2", "--p-bc", "0.9", "--device", "cpu"]


@pytest.mark.parametrize("start", ["torchrun", "plain"])
def test_example_fleet_two_ranks(tmp_path, start):
    """``--fleet`` over 2 gloo ranks: under torchrun (each process a shard)
    and started plainly (``--shards 2``: it starts the ranks itself).  The
    files have the reference's keys, and the run's energy and ages are a
    solo run's."""
    script = str(ROOT / "examples" / "ehfl_cifar_torch.py")
    launch = ([sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2", script]
              if start == "torchrun" else [sys.executable, script, "--shards", "2"])
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
    run = subprocess.run(launch + ["--fleet", *FLEET, "--out", str(tmp_path / "fleet")], env=env,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stdout + run.stderr
    assert "a fleet of 2 ranks over gloo" in run.stdout
    load_example().main(FLEET + ["--out", str(tmp_path / "solo")])
    tag = "vaoi_bernoulli_static_a0.1_p0.9"
    fleet, solo = (json.loads((tmp_path / d / f"{tag}_metrics.json").read_text()) for d in ("fleet", "solo"))
    assert set(fleet) == reference_metric_keys()
    assert fleet["energy"] == solo["energy"] and sum(fleet["energy"]) > 0
    assert fleet["avg_age"] == solo["avg_age"] and fleet["f1_epochs"] == solo["f1_epochs"]
    np.testing.assert_allclose(fleet["f1"], solo["f1"], atol=0.01)
    with np.load(tmp_path / "fleet" / f"{tag}_model.npz") as z:
        assert np.isfinite(z["fc2_w"]).all()
