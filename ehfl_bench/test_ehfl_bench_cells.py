"""A cell, a configuration's traffic and a per-layer metric are files of
their own that the harness finds by name: a cell dropped into a copy of
the benchmark runs without an edit to any file that was there."""
from __future__ import annotations

import hashlib
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def digests(tree: Path) -> dict:
    return {str(p.relative_to(tree)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(tree.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_a_new_cell_is_one_new_file(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "ehfl_bench", tmp_path / "ehfl_bench",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    (tmp_path / "src").symlink_to(ROOT / "src")
    before = digests(tmp_path / "ehfl_bench") | {"BENCHMARK.json": digests(tmp_path)["BENCHMARK.json"]}
    base = json.loads((ROOT / "ehfl_bench" / "workloads" / "paper-cnn.n100.vaoi.json").read_text())
    new = dict(base, sim=dict(base["sim"], num_clients=50, k=5), tiny={"sim": {"num_clients": 5, "k": 1},
                                                                      "settle_epochs": 2})
    (tmp_path / "ehfl_bench" / "workloads" / "paper-cnn.n50.vaoi.json").write_text(json.dumps(new))
    code = ("import sys, torch; torch.set_num_threads(1); from ehfl_bench import run; "
            "sys.exit(run.main(['--workload', 'paper-cnn.n50.vaoi', '--seed', '5', '--seconds', '0.3', '--trace', '0'],"
            " device='cpu', tiny=True))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["correct"] is True and res["attempted"] >= 1
    after = digests(tmp_path / "ehfl_bench") | {"BENCHMARK.json": digests(tmp_path)["BENCHMARK.json"]}
    assert set(after) - set(before) == {"workloads/paper-cnn.n50.vaoi.json"}
    assert all(after[k] == v for k, v in before.items())


def test_every_cell_config_and_metric_has_its_file():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        assert (ROOT / c["file"]).is_file()
    for w in bench["workloads"]:
        cell = json.loads((ROOT / "ehfl_bench" / "workloads" / f"{w['name']}.json").read_text())
        assert cell["config"] == w["config"] and cell["chips"] == w["chips"]
    for m in bench["per_layer"]:
        assert (ROOT / "ehfl_bench" / "metrics" / f"{m['name']}.py").is_file()
