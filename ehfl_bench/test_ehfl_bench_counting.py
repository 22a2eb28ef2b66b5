"""The yardstick's arithmetic against hand counts: the CNN's parameters and
forward FLOPs, the useful FLOPs behind ``epoch_mfu``, the FedAvg byte bound
(zero-weight rows not counted), the idle share and the breakdown's gaps."""
from __future__ import annotations

import pytest

from ehfl_bench import run, world
from ehfl_bench.families import cnn
from ehfl_bench.trace import Trace, breakdown

PAPER = world.load_cell("paper-cnn.n100.vaoi")
FWD = 78_383_616  # hand count: convs 77,266,944 + dense 1,116,672 (2 FLOPs a multiply-add)


def trace(**kw) -> Trace:
    fields = dict(window_s=1.0, epochs=2, evals=0, device_ops=[], ranges=[], epoch_metrics=[], cell=PAPER,
                  cfg=world.ehfl_config(PAPER, 0), family=cnn, peaks=world.load_json(world.BENCH / "peaks.json"))
    fields.update(kw)
    return Trace(**fields)


def test_cnn_counts():
    model = PAPER["model_config"]["model"]
    assert cnn.param_count(model) == 845_738 == PAPER["model_config"]["param_count"]
    assert cnn.forward_flops(model) == FWD == PAPER["model_config"]["forward_flops_per_image"]
    assert abs(FWD / 1e6 - 78.3) < 0.1


def test_epoch_mfu_counts_started_lanes_probe_and_eval():
    run.import_port()
    read = run.load_reader("epoch_mfu")
    tr = trace(evals=1, epoch_metrics=[{"n_started": 2}, {"n_started": 1}])
    per_client = 20 * 15 * FWD * 4  # kappa steps of 15 samples: forward, backward (2x), the feature tap
    probe = 100 * 20 * FWD  # N x probe_size images an epoch
    flops = 3 * per_client + 2 * probe + 500 * FWD
    assert read(tr) == pytest.approx(100 * flops / 67e12)


def test_fedavg_bytes_skip_zero_weight_rows():
    run.import_port()
    read = run.load_reader("fedavg_reduce.roofline_pct")
    ops = [("fedavg_leaves_kernel<false>", 0.0, 100.0, None), ("fedavg_leaves_kernel<false>", 500.0, 600.0, None)]
    tr = trace(device_ops=ops, epoch_metrics=[{"n_delivered": 3}, {"n_delivered": 0}])
    cols, weights = 845_738, 110  # the slab's 10 weights and the old stack's 100
    epoch1 = 3 * cols * 4 + 4 * weights + 4 * cols  # three weighted rows, every weight, the output
    epoch2 = 4 * weights + 4 * cols  # nobody delivered: no row counts
    bound_us = (epoch1 + epoch2) / 2 / 3.35e12 * 1e6
    assert read(tr) == pytest.approx(100 * bound_us / 100.0)


def test_idle_share_gaps_and_device_time_by_range():
    ops = [("k1", 0.0, 100.0, 0.0), ("k2", 50.0, 150.0, 210.0), ("k3", 300.0, 400.0, 340.0), ("Memcpy", 450.0, 460.0, None)]
    ranges = [("ehfl.outer", 0.0, 500.0), ("ehfl.inner", 200.0, 350.0), ("ehfl.inner", 600.0, 700.0)]
    tr = trace(window_s=1e-3, device_ops=ops, ranges=ranges)
    assert run.load_reader("device_idle_share")(tr) == pytest.approx(74.0)
    assert run.load_reader("kernel_launches_per_epoch")(tr) == 1.5  # the copy is no kernel launch
    assert tr.range_ms("ehfl.inner") == (pytest.approx(0.25), pytest.approx(0.2), 2)  # k2 and k3 were launched in it
    assert tr.range_ms("ehfl.outer")[1] == pytest.approx(0.25)  # k1 and k2 overlap: their union
    gaps = breakdown(tr)["idle_gaps"]
    assert gaps == [["ehfl.inner", pytest.approx(150e-6)], ["ehfl.outer", pytest.approx(50e-6)]]


def test_readers_return_nothing_without_records():
    run.import_port()
    tr = trace(epoch_metrics=[{"n_started": 0, "n_delivered": 0}] * 2)
    for name in ("device_idle_share", "kernel_launches_per_epoch", "probe.device_ms", "local_train.device_ms",
                 "vaoi_distance.roofline_pct", "fedavg_reduce.roofline_pct"):
        assert run.load_reader(name)(tr) is None, name
