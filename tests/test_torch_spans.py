"""The ``ehfl.*`` ranges of the port's epoch under ``torch.profiler`` (CPU
activity), on a tiny CNN world, on the compacted VAoI path and on the dense
fedavg path: one ``ehfl.epoch`` an epoch around every range of that epoch
but the eval; inside each ``ehfl.local_train`` the κ SGD steps as
``ehfl.local_train.batch``, ``.grad``, ``.update`` and, under VAoI only,
``.feature``; the write-back inside ``ehfl.scatter`` and the FedAvg input
selection inside ``ehfl.fedavg``.  The spans change nothing: the carry and
the metrics are bit for bit those of a run without the profiler."""
import pytest

torch = pytest.importorskip("torch")

from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch.configs import CNNConfig  # noqa: E402
from repro_torch.core import EHFLConfig, run_simulation  # noqa: E402
from repro_torch.data import make_federated_dataset  # noqa: E402
from repro_torch.fl import cnn_backend  # noqa: E402

TINY = dict(name="tiny", image_size=16, conv_channels=(4, 4, 8, 8, 8, 8), fc_dims=(32, 16))
CFG = dict(num_clients=8, epochs=3, slots_per_epoch=12, kappa=4, p_bc=0.8, k=3, mu=0.1, e_max=9, eval_every=2,
           probe_size=10)
STEP = ["ehfl.local_train.batch", "ehfl.local_train.grad", "ehfl.local_train.update"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data():
    return make_federated_dataset(0, num_clients=8, samples_per_client=40, test_size=20, image_size=16, device="cpu")


def simulate(policy: str, data, traced: bool):
    """T epochs of ``policy`` through ``run_simulation`` (evals included);
    with ``traced`` under the profiler, returning also the host events as
    (name, start ns, end ns) in time order."""
    run = lambda: run_simulation(EHFLConfig(**CFG, policy=policy), cnn_backend(CNNConfig(**TINY)), data,
                                 device="cpu")
    if not traced:
        return run(), []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = run()
    events = sorted(((k.name(), k.start_ns(), k.end_ns()) for k in prof.profiler.kineto_results.events()
                     if k.device_type() == DeviceType.CPU), key=lambda ev: ev[1])
    return out, events


def inside(events, outer):
    _, s, e = outer
    return [ev for ev in events if s <= ev[1] and ev[2] <= e and ev != outer]


def named(events, name):
    return [ev for ev in events if ev[0] == name]


@pytest.fixture(scope="module", params=["vaoi", "fedavg"])
def traced(request, data):
    out, events = simulate(request.param, data, traced=True)
    return request.param, out, events


def test_one_epoch_span_an_epoch_around_its_ranges(traced):
    _, _, events = traced
    epochs = named(events, "ehfl.epoch")
    assert len(epochs) == CFG["epochs"]
    ranges = [ev for ev in events if ev[0].startswith("ehfl.") and ev[0] != "ehfl.epoch"]
    assert len(named(ranges, "ehfl.eval")) == 2  # after epoch 2 (eval_every) and after the last
    for ev in ranges:
        holders = [ep for ep in epochs if ep[1] <= ev[1] and ev[2] <= ep[2]]
        assert len(holders) == (0 if ev[0] == "ehfl.eval" else 1), ev
    for ep in epochs:
        held = {ev[0] for ev in inside(ranges, ep)}
        assert {"ehfl.select", "ehfl.slot_scan", "ehfl.channel", "ehfl.local_train", "ehfl.scatter",
                "ehfl.fedavg"} <= held
        assert all(len(named(inside(ranges, ep), name)) == 1 for name in ("ehfl.local_train", "ehfl.scatter",
                                                                          "ehfl.fedavg"))


def test_local_train_holds_kappa_steps_in_order(traced):
    policy, _, events = traced
    trains = named(events, "ehfl.local_train")
    assert len(trains) == CFG["epochs"]
    step = STEP + (["ehfl.local_train.feature"] if policy == "vaoi" else [])
    for tr in trains:
        stages = [ev[0] for ev in inside(events, tr) if ev[0].startswith("ehfl.local_train.")]
        assert stages == step * CFG["kappa"]
    # no step span opens outside local training
    spans = [ev for ev in events if ev[0].startswith("ehfl.local_train.")]
    assert len(spans) == len(step) * CFG["kappa"] * CFG["epochs"]


def test_write_back_and_fedavg_inputs_inside_their_spans(traced):
    """Every ``torch.where`` of the epoch runs inside one of its ranges; on
    the dense path ``ehfl.scatter`` holds one a message leaf (and the Eq. 6
    moments' under VAoI), and ``ehfl.fedavg`` the input selection's."""
    policy, out, events = traced
    leaves = len(out["global_params"])
    for ep in named(events, "ehfl.epoch"):
        held = inside(events, ep)
        spans = [ev for ev in held if ev[0].startswith("ehfl.")]
        for w in named(held, "aten::where"):
            assert any(s[1] <= w[1] and w[2] <= s[2] for s in spans), w
        (scatter,), (fedavg,) = named(held, "ehfl.scatter"), named(held, "ehfl.fedavg")
        assert named(held, "ehfl.local_train")[0][2] <= scatter[1] and scatter[2] <= fedavg[1]
        if policy == "fedavg":  # the dense path
            assert len(named(inside(events, scatter), "aten::where")) == leaves
            assert len(named(inside(events, fedavg), "aten::where")) >= leaves


def test_spans_change_nothing(traced, data):
    policy, on, _ = traced
    off, _ = simulate(policy, data, traced=False)
    for k, v in off["global_params"].items():
        assert torch.equal(on["global_params"][k], v), k
    for field, value in off["carry"]._asdict().items():
        if isinstance(value, torch.Tensor):
            assert torch.equal(getattr(on["carry"], field), value), field
        elif isinstance(value, dict):
            assert all(torch.equal(getattr(on["carry"], field)[k], v) for k, v in value.items()), field
    for k, v in off["metrics"].items():
        if k != "epoch_s":  # the host clock
            assert torch.equal(on["metrics"][k], v), k
