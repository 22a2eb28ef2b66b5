"""The port's per-device cost accounting (``launch/cost_analysis.py``).

``roofline_terms`` against ``repro.launch.hlo_analysis.roofline_terms``
(the same arithmetic) on ``tests/test_infra.py``'s cases and a seeded
sweep.  Then, over a fake group of 4 ranks on a (2, 2) ("data", "model")
mesh in a child process (``tests/_torch_launch_worker.py``), collectives
and FLOPs whose counts are known from the shapes: a (B, d) fp32 tensor
Shard(0) -> Replicate over ``data`` is one all-gather of B·d·4 bytes (its
output; the operand is half), Partial -> Replicate one all-reduce of
B·d·4, Partial -> Shard(0) one reduce-scatter (counted by its B·d·4-byte
operand); a matmul with replicated operands counts its whole 2·M·K·N
FLOPs on rank 0, one with its rows over ``data`` half of them."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_launch_worker as worker  # noqa: E402
from repro.launch import hlo_analysis  # noqa: E402
from repro_torch.launch import cost_analysis  # noqa: E402
from repro_torch.launch.mesh import HBM_BW, NET_BW, PEAK_FLOPS_BF16  # noqa: E402

INFRA_CASES = [
    (1e12, 1e9, 1e6, 197e12, 819e9, 50e9),
    (1e9, 1e12, 1e6, 197e12, 819e9, 50e9),
    (1e9, 1e9, 1e12, 197e12, 819e9, 50e9),
]


def _sweep():
    rng = np.random.default_rng(23)
    out = []
    for _ in range(40):
        f, h, c = 10.0 ** rng.uniform(6, 16, 3)
        out.append((f, h, c, PEAK_FLOPS_BF16, HBM_BW, NET_BW))
    return out


@pytest.mark.parametrize("args", INFRA_CASES + _sweep())
def test_roofline_terms_equal_the_reference(args):
    assert cost_analysis.roofline_terms(*args) == hlo_analysis.roofline_terms(*args)


B, D = 8, 6
MM = (8, 4, 6)
CASES = [
    dict(case="redistribute", src=("S0", "R"), dst=("R", "R"), shape=(B, D), kind="all-gather"),
    dict(case="redistribute", src=("P", "R"), dst=("R", "R"), shape=(B, D), kind="all-reduce"),
    dict(case="redistribute", src=("P", "R"), dst=("S0", "R"), shape=(B, D), kind="reduce-scatter"),
    dict(case="redistribute", src=("R", "S1"), dst=("R", "R"), shape=(B, D), kind="all-gather"),
    dict(case="matmul", shape=MM, sharded=False),
    dict(case="matmul", shape=MM, sharded=True),
]


@pytest.fixture(scope="module")
def fake(tmp_path_factory):
    return worker.run_fake(CASES, tmp_path_factory.mktemp("cost"))


@pytest.mark.parametrize("i", [0, 1, 2, 3])
def test_known_redistributions_count_known_collectives(fake, i):
    case, got = CASES[i], fake[i]
    assert "error" not in got, got
    want_counts = {k: int(k == case["kind"]) for k in cost_analysis.COLLECTIVES}
    assert got["collective_counts"] == want_counts
    assert got["collectives"][case["kind"]] == B * D * 4
    assert got["collectives"]["total"] == B * D * 4
    assert got["flops"] == 0


@pytest.mark.parametrize("i,share", [(4, 1.0), (5, 0.5)])
def test_matmul_flops_are_per_device(fake, i, share):
    M, K, N = MM
    got = fake[i]
    assert "error" not in got, got
    assert got["flops"] == share * 2 * M * K * N
    assert got["collectives"]["total"] == 0
    assert got["memory"]["peak_bytes"] >= int(share * M) * N * 2  # the output lives on rank 0
