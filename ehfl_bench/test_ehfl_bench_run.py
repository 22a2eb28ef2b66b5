"""The harness end to end on the CPU at the cells' tiny sizes: every cell
through the comparison with the reference, the result line's keys, the
control and each planted fault turning ``correct`` false, and the refusals
(no card, no port in the checkout).  The ``cuda`` test runs a cell on the
card at its own size."""
from __future__ import annotations

import io
import json
import shutil
import subprocess
import sys
from contextlib import redirect_stdout
from pathlib import Path

import pytest
import torch

from ehfl_bench import run, world
from ehfl_bench.faults import FAULTS

ROOT = Path(__file__).resolve().parent.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def last_line(cell: str, seed: int = 12_345_678_901, fault: str | None = None) -> tuple:
    """One run in a fresh interpreter: a run refuses to report once JAX is
    loaded, and this test process may hold it from other test files."""
    code = ("import sys, torch; torch.set_num_threads(1); from ehfl_bench import run; "
            f"sys.exit(run.main(['--workload', {cell!r}, '--seed', '{seed}', '--seconds', '0.3', '--trace', '0'], "
            f"device='cpu', tiny=True, fault={fault!r}))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    lines = proc.stdout.strip().splitlines()
    return proc.returncode, json.loads(lines[-1]) if lines else proc.stderr[-3000:]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_and_matches_the_reference(cell):
    rc, res = last_line(cell)
    assert rc == 0
    assert list(res) == KEYS  # the contract's keys, the compared numbers last
    assert res["correct"] is True, res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["metrics"]) == {m["name"] for m in BENCH["end_to_end"] if cell in m.get("workloads", [cell])}
    assert set(res["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    assert all(c["value"] <= c["limit"] for c in res["checks"].values())


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_planted_fault_is_not_correct(fault):
    rc, res = last_line("paper-cnn.n100.vaoi", fault=fault)
    assert rc == 0 and res["correct"] is False, (fault, res["checks"])


@pytest.mark.parametrize("cell", CELLS)
def test_the_tf32_control_is_not_correct(cell):
    """The reference in TF32 put in the program's place fails the limits."""
    from ehfl_bench import check

    w = run.build(world.load_cell(cell, tiny=True), 424242, torch.device("cpu"))
    _, snaps, _ = run.check_epochs(w, run.settle(w))
    assert check.passed(check.judge(run.compare(w, snaps), w.cell["limits"]))
    assert not check.passed(check.judge(run.compare(w, snaps, side="control"), w.cell["limits"]))


def test_no_card_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is here: the refusal is for machines without one")
    rc = run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1", "--trace", "0"])
    assert rc != 0 and capsys.readouterr().out == ""


def test_a_checkout_without_the_port_refuses(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "ehfl_bench", tmp_path / "ehfl_bench",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    code = ("import sys; from ehfl_bench import run; "
            f"sys.exit(run.main(['--workload', '{CELLS[0]}', '--seed', '1', '--seconds', '1', '--trace', '0'], "
            "device='cpu', tiny=True))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout == "", proc.stderr


@pytest.mark.cuda
def test_a_cell_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = io.StringIO()
    with redirect_stdout(out):
        rc = run.main(["--workload", CELLS[0], "--seed", "987654321987", "--seconds", "2", "--trace", "0"])
    res = json.loads(out.getvalue().strip().splitlines()[-1])
    assert rc == 0 and list(res) == KEYS and res["correct"] is True, res
    assert res["device"]["platform"] == "gpu" and res["device"]["memory_peak_bytes"] > 0
