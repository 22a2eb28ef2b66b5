"""The readers of the local-training stage spans and the write-back span
against hand counts on a synthetic traced window: two epochs of two SGD
steps each (batch, grad, update, feature), the write-back and FedAvg; the
breakdown's idle gaps split by stage; nothing read where the window has no
such records (a program without the spans); and which cells report them."""
from __future__ import annotations

import pytest

from ehfl_bench import run
from ehfl_bench.test_ehfl_bench_counting import trace
from ehfl_bench.trace import breakdown

NEW = {"local_train.grad.device_ms", "local_train.grad.launches_per_step", "local_train.feature.device_ms",
       "scatter.device_ms"}
CELLS = {"paper-cnn.n100.vaoi": set(), "paper-cnn.n100.fedavg": NEW - {"local_train.feature.device_ms"},
         "paper-cnn.n1000.vaoi": NEW}
TRAIN = ("ehfl.local_train", "ehfl.local_train.batch", "ehfl.local_train.grad", "ehfl.local_train.update",
         "ehfl.local_train.feature")

# one epoch (us): ranges, and device operations (name, start, end, launch)
EPOCH_RANGES = [
    ("ehfl.epoch", 0, 1000), ("ehfl.local_train", 100, 700),
    ("ehfl.local_train.batch", 100, 150), ("ehfl.local_train.grad", 150, 300),
    ("ehfl.local_train.update", 300, 350), ("ehfl.local_train.feature", 350, 400),
    ("ehfl.local_train.batch", 446, 455), ("ehfl.local_train.grad", 455, 600),
    ("ehfl.local_train.update", 600, 650), ("ehfl.local_train.feature", 650, 700),
    ("ehfl.scatter", 720, 760), ("ehfl.fedavg", 760, 900),
]
EPOCH_OPS = [
    ("gather", 105, 110, 102), ("gather", 130, 140, 120),
    ("fprop", 170, 250, 160), ("dgrad", 240, 320, 200), ("Memcpy DtoD", 320, 330, 210),  # step 1's grad
    ("sgd", 335, 345, 310), ("feature", 380, 420, 360),
    ("fprop", 470, 560, 460), ("dgrad", 560, 600, 500), ("wgrad", 600, 610, 590),  # step 2's grad
    ("sgd", 615, 640, 610), ("feature", 690, 720, 660),
    ("where", 740, 780, 730), ("fedavg_leaves_kernel<false>", 790, 850, None),  # a ctypes launch: no host op
]


def shifted(rows, by):
    return [(r[0], r[1] + by, r[2] + by, *[None if x is None else x + by for x in r[3:]]) for r in rows]


def window(with_steps: bool = True):
    ranges = EPOCH_RANGES if with_steps else [r for r in EPOCH_RANGES if r[0] in ("ehfl.local_train",
                                                                                  "ehfl.fedavg")]
    return trace(epochs=2, ranges=ranges + shifted(ranges, 1000), device_ops=EPOCH_OPS + shifted(EPOCH_OPS, 1000))


def read(name, tr):
    return run.load_reader(name)(tr)


def test_readers_against_hand_counts():
    tr = window()
    # step 1: the union of fprop, dgrad and the copy, 170-330; step 2: 470-610
    assert read("local_train.grad.device_ms", tr) == pytest.approx(0.300)
    # 2 + 3 kernels an epoch (the copy is no kernel) over 2 steps
    assert read("local_train.grad.launches_per_step", tr) == pytest.approx(2.5)
    assert read("local_train.feature.device_ms", tr) == pytest.approx(0.070)
    assert read("scatter.device_ms", tr) == pytest.approx(0.040)


def test_breakdown_splits_local_training_idle_by_stage():
    tr = window()
    gaps = dict(breakdown(tr, top=100)["idle_gaps"])
    assert gaps["ehfl.epoch"] == pytest.approx(255e-6)  # between the epochs: not local training's
    # a gap is named after the innermost range open at its midpoint, an epoch: 20 (batch), 30 (grad),
    # 5 + 5 (update) and 35 + 50 (feature) us, and 50 us between the steps (local training itself)
    hand = {"ehfl.local_train.batch": 20e-6, "ehfl.local_train.grad": 30e-6, "ehfl.local_train.update": 10e-6,
            "ehfl.local_train.feature": 85e-6, "ehfl.local_train": 50e-6}
    assert {k: v for k, v in gaps.items() if k in TRAIN} == pytest.approx({k: 2 * v for k, v in hand.items()})


def test_readers_return_nothing_without_records():
    for name in sorted(NEW):
        assert read(name, trace()) is None, name
    # the parent's program: local training and FedAvg spanned, no stage or write-back span
    tr = window(with_steps=False)
    for name in sorted(NEW):
        assert read(name, tr) is None, name


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_cells_report_the_span_metrics(cell):
    metrics = [m for m in run.per_layer_metrics(cell) if m["name"] in NEW]
    assert {m["name"] for m in metrics} == CELLS[cell]
    assert all(m["source"] == "program_span" and m["moves"] == "epoch_ms" and m["better"] == "lower"
               for m in metrics)
