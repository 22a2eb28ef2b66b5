"""The port's fleet bench (``benchmarks/fleet_bench_torch.py``) on the CPU:
2 gloo ranks at N = 64, dense and compact, in one spawn, written into a temp
dir; the rows keep the JAX bench's keys (``compile_s`` becomes
``first_epoch_s``) and the file passes ``tools/check_bench.py``'s schema.
The backend and rank-count refusals need no spawn."""
import importlib.util
import json
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from benchmarks import fleet_bench_torch as tfleet  # noqa: E402

N = 64
KEYS = {"N", "shards", "policy", "compact", "k", "epoch_s", "first_epoch_s", "clients_per_s"}


def check_bench():
    spec = importlib.util.spec_from_file_location("check_bench", ROOT / "tools" / "check_bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    out = tmp_path_factory.mktemp("fleet") / "BENCH_fleet_torch.json"
    mp = pytest.MonkeyPatch()
    mp.setattr(tfleet, "OUT", out)
    mp.setattr(tfleet, "sizes", lambda quick: (N,))
    try:
        csv = tfleet.run(True, device="cpu", shards=2, backend="gloo")
    finally:
        mp.undo()
    return out, json.loads(out.read_text()), csv


def test_fleet_rows_keep_the_jax_keys(written):
    _, doc, csv = written
    rows = doc["rows"]
    assert [(r["N"], r["compact"]) for r in rows] == [(N, False), (N, True)]
    for r in rows:
        assert set(r) == KEYS
        assert r["shards"] == 2 and r["policy"] == "vaoi" and r["k"] == 10
        assert r["epoch_s"] > 0 and r["first_epoch_s"] > 0
        assert abs(r["clients_per_s"] - N / r["epoch_s"]) <= 0.01 * r["clients_per_s"]
    assert [c["name"] for c in csv] == [f"fleet/N{N}_shards2", f"fleet/N{N}_shards2_compact"]


def test_fleet_file_passes_the_schema(written):
    path, doc, _ = written
    errors: list = []
    check_bench().check_schema(path, doc, errors)
    assert errors == []
    assert doc["bench"] == "fleet" and doc["backend"] == "cpu" and doc["devices"] == 1
    assert doc["dist_backend"] == "gloo" and doc["ranks"] == 2 and doc["device"]["name"] == "cpu"


def test_fleet_protocol_is_the_jax_benches():
    assert tfleet.sizes(True) == (1024, 4096) and tfleet.sizes(False) == (1024, 4096, 16384, 65536)
    cfg = tfleet.fleet_config(1024, "vaoi", True, epochs=4)
    assert (cfg.slots_per_epoch, cfg.kappa, cfg.p_bc, cfg.k, cfg.mu, cfg.e_max, cfg.probe_size) == (
        8, 4, 0.3, 10, 0.5, 8, 4)
    assert cfg.compact == "auto" and tfleet.fleet_config(1024, "vaoi", False, 4).compact is False
    data = tfleet.world(32)
    assert tuple(data["images"].shape) == (32, 8, 8, 8, 3) and data["test_images"].shape[0] == 64


def test_fleet_refuses_nccl_off_the_card():
    with pytest.raises(ValueError, match="NCCL runs on the card"):
        tfleet.bench((N,), backend="nccl", device="cpu")


def test_fleet_refuses_two_nccl_ranks_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="one rank a card"):
        tfleet.bench((N,), shards=2, backend="nccl", device="cuda")
