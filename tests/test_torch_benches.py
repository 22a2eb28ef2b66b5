"""The port's bench suite on the CPU: ``benchmarks/stream_bench_torch.py``,
``channel_bench_torch.py``, ``kernels_bench_torch.py`` and the harness
``run_torch.py`` (the fleet bench is ``tests/test_torch_bench_fleet.py``).

One stream row (arrival, vaoi, compact) and one channel row (erasure at
p_loss 0.5, vaoi) of the port against the JAX benches' ``bench_one`` on the
JAX micro world (``stream_bench._world``, as numpy), with each key chain
replayed into the port's draws (``tests/_torch_replay.py``) and the
reference's initial model carried over: the counts exactly, the rounded
floats within one unit of their last kept digit.  The port's own quick
channel grid and the static rows of its stream grid then run, written into
a temp dir: every ideal channel row must repeat its static stream row (``check_ideal_bitmatch``), both files pass
``tools/check_bench.py``'s schema, and a tampered row must fail the check.
"""
import dataclasses
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from _torch_replay import replay_draws  # noqa: E402
from benchmarks import channel_bench as jchannel  # noqa: E402
from benchmarks import channel_bench_torch as tchannel  # noqa: E402
from benchmarks import kernels_bench_torch as tkernels  # noqa: E402
from benchmarks import run_torch  # noqa: E402
from benchmarks import stream_bench as jstream  # noqa: E402
from benchmarks import stream_bench_torch as tstream  # noqa: E402
from repro.core import EHFLConfig as JEHFLConfig  # noqa: E402
from repro.core import init_carry as jinit_carry  # noqa: E402
from repro_torch.checkpoint.convert import params_from_reference  # noqa: E402

CPU = torch.device("cpu")
N, SAMPLES, EPOCHS = tstream.protocol(True)
# the rounded fields and their kept digits; the counts compared exactly
ROUNDED = {"f1": 4, "avg_age_mean": 4, "avg_m_mean": 5}
EXACT = ("scenario", "policy", "compact", "epochs", "N", "n_uploaded")
CHANNEL_EXACT = EXACT + ("params", "delivery_rate", "retries", "drops")


def check_schema(path: Path) -> list:
    spec = importlib.util.spec_from_file_location("check_bench", ROOT / "tools" / "check_bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    errors: list = []
    mod.check_schema(path, json.loads(path.read_text()), errors)
    return errors


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_world():
    data, backend = jstream._world(N, SAMPLES)
    return data, backend, {k: np.asarray(v) for k, v in data.items()}


def port_inputs(tcfg, jbackend):
    """The reference's key chain and initial model for the config the port runs."""
    jcfg = JEHFLConfig(**vars(tcfg))
    params = params_from_reference(jax.tree.map(np.asarray, jinit_carry(jcfg, jbackend, jcfg.seed).global_params), CPU)
    return replay_draws(jcfg, jbackend, SAMPLES), params


def assert_rows_agree(port, ref, exact):
    assert set(port) == set(ref)
    for k in exact:
        assert port[k] == ref[k], k
    for k, digits in ROUNDED.items():
        assert abs(port[k] - ref[k]) <= 10.0 ** -digits * (1 + 1e-9), (k, port[k], ref[k])


def test_stream_row_matches_the_jax_bench(jax_world):
    jdata, jbackend, data = jax_world
    args = ("arrival", "vaoi")
    ref = jstream.bench_one(*args, jdata, jbackend, EPOCHS, N, compact=True)
    draws, params = port_inputs(tstream.bench_config(*args, EPOCHS, N, compact=True), jbackend)
    port = tstream.bench_one(*args, data, tstream.cnn_backend(tstream.MICRO), EPOCHS, N, compact=True,
                             draws=draws, params=params, device="cpu")
    assert_rows_agree(port, ref, EXACT)
    assert port["n_uploaded"] > 0


@pytest.mark.parametrize("channel,params", [("erasure", (("p_loss", 0.5),)), ("aloha", (("num_channels", 1.0),))])
def test_channel_row_matches_the_jax_bench(jax_world, channel, params):
    """ALOHA on one channel too: the row that may deliver nothing
    (``channel_bench_torch.silent_by_design``) does so in both packages
    alike."""
    jdata, jbackend, data = jax_world
    args = (channel, params, "vaoi")
    ref = jchannel.bench_one(*args, jdata, jbackend, EPOCHS, N)
    draws, params = port_inputs(tchannel.bench_config(*args, EPOCHS, N), jbackend)
    port = tchannel.bench_one(*args, data, tstream.cnn_backend(tstream.MICRO), EPOCHS, N, draws=draws,
                              init_params=params, device="cpu")
    assert_rows_agree(port, ref, CHANNEL_EXACT)
    assert port["retries"] > 0 and port["delivery_rate"] < 1
    assert tchannel.check_channel_semantics({"rows": [port]}) == []


def test_grids_are_the_jax_benches():
    assert tstream.STREAM_PARAMS == jstream._STREAM_PARAMS
    assert tstream.protocol(True) == (16, 32, 8) and tstream.protocol(False) == (64, 64, 32)
    assert tstream.cnn_backend(tstream.MICRO).num_classes == 10
    for n in (16, 64):
        assert tchannel.grid(n) == jchannel._grid(n)
        for pol in tstream.POLICIES:
            assert tstream.compacts(pol, n) == jstream._compacts(pol, n)
    jcfg = dataclasses.asdict(JEHFLConfig(**vars(tstream.bench_config("drift", "fedbacys", 8, 16, True))))
    assert jcfg["stream_params"] == jstream._STREAM_PARAMS["drift"] and jcfg["k"] == 4 and jcfg["mu"] == 0.3


@pytest.fixture(scope="module")
def port_files(tmp_path_factory):
    """The port's quick channel grid on the CPU and the static rows of its
    stream grid (the rows the ideal rows repeat), written into a temp dir."""
    tmp = tmp_path_factory.mktemp("bench")
    mp = pytest.MonkeyPatch()
    mp.setattr(tstream, "STREAM_SCENARIOS", ("static",))
    mp.setattr(tstream, "OUT", tmp / "BENCH_stream_torch.json")
    mp.setattr(tchannel, "OUT", tmp / "BENCH_channel_torch.json")
    try:
        csv = {"stream": tstream.run(True, device="cpu"), "channel": tchannel.run(True, device="cpu")}
    finally:
        mp.undo()
    return tmp, csv


def load(tmp, name):
    return json.loads((tmp / f"BENCH_{name}_torch.json").read_text())


@pytest.mark.parametrize("name", ["stream", "channel"])
def test_port_files_pass_the_schema(port_files, name):
    tmp, csv = port_files
    doc = load(tmp, name)
    assert check_schema(tmp / f"BENCH_{name}_torch.json") == []
    assert doc["bench"] == name and doc["backend"] == "cpu" and doc["devices"] == 1 and doc["quick"] is True
    assert doc["deterministic"] is True and set(doc["device"]) == {"name", "power_limit"}
    assert [r["name"].split("/")[0] for r in csv[name]] == [name] * len(doc["rows"])


def test_port_ideal_rows_repeat_the_static_rows(port_files):
    tmp, csv = port_files
    stream, channel = load(tmp, "stream"), load(tmp, "channel")
    assert len(stream["rows"]) == 9 and len(channel["rows"]) == 17
    assert tchannel.check_ideal_bitmatch(stream, channel) == []
    lossy = [r for r in channel["rows"] if r["scenario"] != "ideal"]
    assert all(0 < r["delivery_rate"] < 1 for r in lossy if not tchannel.silent_by_design(r))
    assert all(r["retries"] for r in lossy)
    names = [r["name"] for r in csv["channel"]]
    assert "channel/erasure_vaoi_p_loss0.5" in names and "channel/ideal_vaoi_compact" in names


@pytest.mark.parametrize("tamper,want", [
    (("ideal", "f1", lambda x: round(x + 1e-4, 4)), "'f1'"),
    (("ideal", "n_uploaded", lambda x: x + 1), "'n_uploaded'"),
    (("ideal", "drops", lambda x: 1), "ideal but lossy"),
    (("erasure", "retries", lambda x: x + 1), "does not account"),
    (("fading", "delivery_rate", lambda x: 0.0), "does not account"),
])
def test_tampered_rows_fail_the_check(port_files, tamper, want):
    tmp, _ = port_files
    stream, channel = load(tmp, "stream"), load(tmp, "channel")
    scenario, key, fn = tamper
    row = next(r for r in channel["rows"] if r["scenario"] == scenario)
    row[key] = fn(row[key])
    errors = tchannel.check_ideal_bitmatch(stream, channel)
    assert errors and want in errors[0]


def test_a_silent_lossy_row_fails_but_aloha_on_one_channel(port_files):
    tmp, _ = port_files
    channel = load(tmp, "channel")
    silent = {"n_uploaded": 12, "retries": 12, "delivery_rate": 0.0, "drops": 3, "policy": "vaoi"}
    rows = [{**silent, "scenario": "erasure", "params": {"p_loss": 0.8}},
            {**silent, "scenario": "aloha", "params": {"num_channels": 2.0}},
            {**silent, "scenario": "aloha", "params": {"num_channels": 1.0}}]
    errors = tchannel.check_channel_semantics({"rows": rows})
    assert len(errors) == 2 and all("not in (0, 1]" in e for e in errors[:2])
    assert errors[0].startswith("rows[0]") and errors[1].startswith("rows[1]")
    assert [r for r in channel["rows"] if tchannel.silent_by_design(r)] == [channel["rows"][12]]


def test_an_ideal_row_without_its_static_row_fails(port_files):
    tmp, _ = port_files
    stream, channel = load(tmp, "stream"), load(tmp, "channel")
    stream["rows"] = [r for r in stream["rows"] if not (r["scenario"] == "static" and r["policy"] == "fedavg")]
    assert tchannel.check_ideal_bitmatch(stream, channel) == ["ideal row ('fedavg', 16, 8, False) has no static "
                                                               "stream row"]


def test_kernels_bench_on_the_cpu_has_the_jax_rows_only():
    small = dict(vaoi=(32, 64), fedavg=(8, 256), swa=(1, 2, 64, 16))
    rows = tkernels.run(True, device="cpu", shapes=small)
    assert [r["name"] for r in rows] == [
        "kernel/vaoi_distance_ref/N32xF64", "kernel/fedavg_reduce_ref/K8xP256",
        "kernel/fedavg_reduce_ref/slab_K10xP256", "kernel/swa_attention_ref/S64w256",
    ]
    assert all(r["us_per_call"] > 0 for r in rows)
    assert rows[0]["derived"].startswith(f"bytes={2 * 32 * 64 * 4};GBps=")
    # the quick and full shapes are the JAX bench's
    names = [c["name"] for c in tkernels.cases(tkernels.SHAPES[True], CPU)]
    assert names == ["vaoi_distance_ref/N1024xF4096", "fedavg_reduce_ref/K64xP1048576",
                     "fedavg_reduce_ref/slab_K10xP1048576", "swa_attention_ref/S1024w256"]
    assert tkernels.SHAPES[False] == dict(vaoi=(8192, 16384), fedavg=(128, 1 << 24), swa=(2, 8, 4096, 128))


def test_kernels_bench_bounds():
    assert tkernels.live_pairs(4, 2) == 1 + 2 + 2 + 2
    us, by = tkernels.bound_us(2 * 1024 * 4096 * 4 + 4 * 1024 * 4, 0)
    assert by == "bytes" and abs(us - 10.02) < 0.01
    us, by = tkernels.bound_us(4 * 4 * 1024 * 64 * 4, 4 * 4 * tkernels.live_pairs(1024, 256) * 64)
    assert by == "operations" and 3.4 < us < 3.6


def test_run_torch_fails_on_an_unknown_suite(capsys):
    with pytest.raises(SystemExit) as e:
        run_torch.main(["--only", "no_such_suite", "--device", "cpu"])
    assert e.value.code == 1
    assert "no_such_suite/ERROR,0,UnknownSuite" in capsys.readouterr().err


def _roofline_records(d: Path) -> None:
    """Dry-run records in the reference's schema: one ok, one skipped, one
    failed, under the dry-run's file names."""
    ok = {"arch": "qwen1.5-0.5b", "shape": "train_4k", "mesh": "16x16", "mode": "fsdp",
          "roofline": {"compute_s": 0.0123, "memory_s": 0.0456, "collective_s": 0.00789, "bottleneck": "memory"},
          "useful_flop_ratio": 0.7512}
    (d / "qwen1.5-0.5b__train_4k__sp__fsdp.json").write_text(json.dumps(ok))
    (d / "qwen1.5-0.5b__train_4k__sp__fsdp__act__cechunk128.json").write_text(
        json.dumps({**ok, "roofline": {**ok["roofline"], "collective_s": 0.5, "bottleneck": "collective"}}))
    (d / "whisper-large-v3__long_500k__sp__fsdp.json").write_text(json.dumps(
        {"arch": "whisper-large-v3", "shape": "long_500k", "mesh": "16x16", "skipped": "enc-dec: no analogue"}))
    (d / "jamba-v0.1-52b__decode_32k__mp__tp.json").write_text(json.dumps(
        {"arch": "jamba-v0.1-52b", "shape": "decode_32k", "mesh": "2x16x16", "error": "RuntimeError: x"}))


def test_run_torch_roofline_rows_equal_the_reference(tmp_path, monkeypatch, capsys):
    """``run_torch --only roofline`` over records in a monkeypatched
    directory prints ``benchmarks/roofline.py::run``'s rows, name and value,
    over the same records; an empty directory gives NO_DRYRUN_DATA."""
    from benchmarks import roofline as jroofline
    from benchmarks import roofline_torch

    empty, full = tmp_path / "empty", tmp_path / "full"
    empty.mkdir()
    full.mkdir()
    _roofline_records(full)
    for d in (full, empty):
        monkeypatch.setattr(jroofline, "DRYRUN", d)
        monkeypatch.setattr(roofline_torch, "DRYRUN", d)
        run_torch.main(["--only", "roofline", "--device", "cpu"])
        lines = capsys.readouterr().out.strip().splitlines()
        assert lines[0] == "name,us_per_call,derived"
        want = jroofline.run()
        assert len(lines) - 1 == len(want)
        for line, r in zip(lines[1:], want):
            name, us, derived = line.split(",", 2)
            assert (name, us) == (r["name"], f"{r['us_per_call']:.1f}")
            if d is full:
                assert derived == r["derived"]
    assert [r["name"] for r in roofline_torch.run()] == ["roofline/NO_DRYRUN_DATA"]


def test_run_torch_fails_a_suite_that_raises_and_runs_the_rest(monkeypatch, capsys):
    monkeypatch.setitem(run_torch.SUITES, "broken", lambda quick, device: 1 / 0)
    monkeypatch.setitem(run_torch.SUITES, "fine", lambda quick, device: [
        {"name": f"fine/{device}", "us_per_call": 2.0, "derived": f"quick={quick}"}])
    with pytest.raises(SystemExit) as e:
        run_torch.main(["--only", "broken,fine", "--device", "cpu"])
    out = capsys.readouterr()
    assert e.value.code == 1
    assert "broken/ERROR,0,ZeroDivisionError" in out.out and "fine/cpu,2.0,quick=True" in out.out
    assert "FAILED suites: broken" in out.err


def test_run_torch_without_cuda_fails_unless_told_cpu(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        run_torch.main(["--only", "kernels"])
    assert e.value.code == 1 and "device='cpu'" in capsys.readouterr().out


def test_run_torch_watchdog_ends_a_hung_suite():
    script = (
        "import sys, time; sys.path[:0] = [{root!r}, {src!r}]\n"
        "from benchmarks import run_torch\n"
        "run_torch.SUITES['sleepy'] = lambda quick, device: time.sleep(60)\n"
        "run_torch.main(['--only', 'sleepy', '--suite-timeout', '1', '--device', 'cpu'])\n"
        "print('not reached')\n"
    ).format(root=str(ROOT), src=str(ROOT / "src"))
    p = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True, timeout=50)
    assert p.returncode == 1 and "not reached" not in p.stdout
    assert "sleepy/TIMEOUT,0,exceeded 1s wall clock" in p.stderr
