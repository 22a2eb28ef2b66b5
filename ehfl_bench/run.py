"""The benchmark of ``repro_torch``, the PyTorch/CUDA port of the EHFL
simulator: one run of one cell.

    python3 -m ehfl_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  A cell is ``workloads/<cell>.json`` (the
configuration it names is ``configs/<config>.json``).  Set-up makes the
inputs on the card from the seed, builds the port's epoch function
(``repro_torch.core.simulator.make_epoch_fn``) and drives it from the empty
start (``init_carry``'s batteries) through ``settle_epochs`` epochs, until
the fleet runs as it does from then on, and ``check_epochs`` more whose
state the comparison keeps; they warm every shape the window runs.  The window is a closed loop: epoch after epoch of Alg. 1, with
the macro-F1 eval every ``eval_every`` epochs as ``drive_epochs`` runs it,
for ``--seconds``, ended by one synchronize.  With ``--trace 1`` the
window is ``trace_epochs`` epochs under the profiler instead, and the
cell's per-layer metrics (``metrics/<name>.py``) read it.  Then the
program's state is freed and the plain reference (``reference/``)
follows the check epochs from the same inputs; ``check.py`` compares.

The last line of standard output is one JSON object: ``correct``,
``attempted`` (epochs the window ran), ``failed`` (epochs that raised or
left a non-finite model or metric), ``metrics``, ``device``, with
``--trace 1`` ``breakdown``, and last ``checks``: each compared number
beside its limit, which also close standard error.
"""
from __future__ import annotations

import time

_START = time.perf_counter()  # set-up is counted from here: imports, build, inputs, warm-up

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")  # top-level module names, compared whole
CACHE = BENCH / "_cache"  # listed in .gitignore

# kernel caches at fixed paths inside the checkout (the port's nvcc output
# goes to src/repro_torch/_build, a fixed path inside it too)
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
# one host thread for CPU ops: the epoch is paced by the host's launches, and
# idle OpenMP workers on a shared host made runs slower and wider apart
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[var] = "1"

import numpy as np  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(1)

from ehfl_bench import check, world as world_lib  # noqa: E402
from ehfl_bench.trace import Trace, breakdown, capture  # noqa: E402


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def benchmark_entry() -> dict:
    return world_lib.load_json(ROOT / "BENCHMARK.json")


def per_layer_metrics(cell_name: str) -> list:
    """The per-layer metrics of BENCHMARK.json that the cell reports."""
    return [m for m in benchmark_entry()["per_layer"] if cell_name in m.get("workloads", [cell_name])]


def end_to_end_metrics(cell_name: str) -> list:
    """The end-to-end metrics of BENCHMARK.json that the cell reports."""
    return [m for m in benchmark_entry()["end_to_end"] if cell_name in m.get("workloads", [cell_name])]


def load_reader(name: str):
    """``metrics/<name>.py``'s ``read``."""
    spec = importlib.util.spec_from_file_location(f"ehfl_bench_metric_{name}", BENCH / "metrics" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def import_port():
    """The port from ``src/``; nothing else of the repo is imported."""
    src = str(ROOT / "src")
    if not (ROOT / "src" / "repro_torch").is_dir():
        raise ImportError(f"the port is not in this checkout ({src}/repro_torch is missing)")
    if src not in sys.path:
        sys.path.insert(0, src)
    from repro_torch.core import simulator

    return simulator


def build(cell: dict, seed: int, device: torch.device) -> SimpleNamespace:
    """Everything a run needs, made from the seed: the port's configuration,
    backend and epoch function; the inputs (pools, test set, weights, the
    epochs' draws), which the reference gets too; the initial carry."""
    simulator = import_port()
    family = importlib.import_module(f"ehfl_bench.families.{cell['model_config']['family']}")
    model = cell["model_config"]["model"]
    cfg = world_lib.ehfl_config(cell, seed)
    data = family.make_data(model, cell["model_config"]["ehfl"], cfg.num_clients, seed, device)
    params = family.init_params(model, seed, device)
    draws = world_lib.make_draws(cfg, data["images"].shape[1], seed, device)
    w = SimpleNamespace(cell=cell, cfg=cfg, family=family, data=data, params=params, draws=draws, device=device,
                        simulator=simulator, seed=seed, fault=None)
    return start(w)


def start(w: SimpleNamespace) -> SimpleNamespace:
    """The port's backend, epoch function and initial carry (empty
    batteries, as ``init_carry`` makes them), anew."""
    w.backend = w.family.backend(w.cell["model_config"]["model"])
    w.carry = w.simulator.init_carry(w.cfg, w.backend, w.device, params=w.params, draws=w.draws)
    w.epoch_fn = epoch_fn(w, w.backend)
    return w


def epoch_fn(w: SimpleNamespace, backend):
    """The port's ``make_epoch_fn`` over ``backend``, with the planted
    fault (``faults.py``) where there is one."""
    on_backend, on_epoch = w.fault or (None, None)
    fn = w.simulator.make_epoch_fn(w.cfg, on_backend(backend) if on_backend else backend, w.data)
    return on_epoch(fn) if on_epoch else fn


def plant(w: SimpleNamespace, fault: str) -> None:
    """Break the timed path underneath with ``faults.FAULTS[fault]``."""
    from ehfl_bench.faults import FAULTS

    w.fault = FAULTS[fault]
    w.epoch_fn = epoch_fn(w, w.backend)


def run_epochs(w: SimpleNamespace, t: int, stop, f1s: list) -> tuple:
    """Epochs from ``t`` until ``stop(epochs run)``, each followed by the
    eval where ``drive_epochs`` puts it; returns (next t, metrics, evals)."""
    from repro_torch.models.cnn import macro_f1
    from torch.profiler import record_function

    n_samples, per_epoch, evals, run = w.data["images"].shape[1], [], 0, 0
    w.starts = [time.perf_counter()]  # host clock at each epoch's start, no synchronize
    while not stop(run):
        w.carry, ms = w.epoch_fn(w.carry, t, w.draws.epoch(t, w.cfg, n_samples, w.device))
        per_epoch.append(ms)
        if (t + 1) % w.cfg.eval_every == 0:
            with record_function("ehfl.eval"):
                preds = w.backend.predict(w.carry.global_params, w.data["test_images"])
                f1s.append(macro_f1(preds, w.data["test_labels"], w.backend.num_classes))
            evals += 1
        t, run = t + 1, run + 1
        w.starts.append(time.perf_counter())
    return t, per_epoch, evals


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def settle(w: SimpleNamespace) -> int:
    """The cell's ``settle_epochs`` from the empty start, through the
    window's own call, until the fleet runs as it does from then on;
    returns the next epoch."""
    t, _, _ = run_epochs(w, 0, lambda run: run == w.cell["settle_epochs"], [])
    sync(w.device)
    return t


def check_epochs(w: SimpleNamespace, t: int) -> tuple:
    """``check_epochs`` epochs from ``t`` through the port's epoch function
    with a tap on the backend's ``grad_loss`` (:class:`check.Recorder`),
    each kept for the comparison (:func:`check.epoch_snapshot`), then one
    eval; returns (next t, snapshots, seconds spent keeping them)."""
    from repro_torch.core import policies
    from repro_torch.models.cnn import macro_f1

    spec = policies.make_policy(w.cfg.policy, num_clients=w.cfg.num_clients, k=w.cfg.k, num_groups=w.cfg.num_groups)
    compact = w.simulator.resolve_compact_cap(w.cfg, spec) is not None
    rng = np.random.default_rng(world_lib.seed_words(w.seed, 5))
    window_fn, snaps, snap_s = w.epoch_fn, [], 0.0
    for _ in range(w.cell["check_epochs"]):
        before, rec = w.carry, check.Recorder()
        w.epoch_fn = epoch_fn(w, rec.tap(w.backend))
        t1, (ms,), _ = run_epochs(w, t, lambda run: run == 1, [])
        sync(w.device)  # the epoch's own time stays in set-up; the copies' does not
        t0 = time.perf_counter()
        snaps.append(check.epoch_snapshot(t, before, w.carry, ms, rec.steps, compact, w.cell["check_lanes"], rng,
                                          w.cfg.policy == "vaoi", w.cfg.kappa))
        before = rec = None
        snap_s += time.perf_counter() - t0
        t = t1
    w.epoch_fn = window_fn
    macro_f1(w.backend.predict(w.carry.global_params, w.data["test_images"]), w.data["test_labels"],
             w.backend.num_classes)
    sync(w.device)
    return t, snaps, snap_s


def reference_run(w: SimpleNamespace, snaps: list, rounding: bool = False, fused: bool = False) -> list:
    """The plain reference over the check epochs, each from the program's
    state (``rounding``: the TF32 control; ``fused``: SGD updates fused)."""
    from ehfl_bench.reference import ehfl as ref

    model = w.family.reference(w.cell["model_config"]["model"], rounding=rounding)
    cfg = {k: getattr(w.cfg, k) for k in ("policy", "k", "probe_size", "mu", "slots_per_epoch", "kappa", "e_max",
                                          "lr")}
    out = []
    for snap in snaps:
        lanes = {c: lane["grads"] for c, lane in snap["out"]["lanes"].items()}
        inp = {**snap["in"], "global": {k: v.to(w.device) for k, v in snap["in"]["global"].items()}}
        out.append(ref.forced_epoch(model, inp, lanes, snap["rows"], w.draws.host(snap["t"]), w.data, cfg, fused))
    return out


def compare(w: SimpleNamespace, snaps: list, side: str = "program", raw: list | None = None) -> dict:
    """The compared numbers of the program against the reference; with
    ``side`` "control" the TF32 control's in the program's place, with
    "fused" the reference's own with fused SGD updates (``raw``: see
    :func:`check.numbers`)."""
    ref = reference_run(w, snaps)
    if side == "program":
        got = [s["out"] for s in snaps]
    else:
        got = reference_run(w, snaps, rounding=side == "control", fused=side == "fused")
    return check.numbers(got, ref, [s["in"] for s in snaps], w.cfg.policy == "vaoi", raw)


def finite(x) -> bool:
    return bool(torch.isfinite(torch.as_tensor(x, dtype=torch.float64)).all())


def count_failed(w: SimpleNamespace, per_epoch: list, f1s: list, raised: bool) -> int:
    """Epochs that left a non-finite metric; all of them where the final
    global model or an eval is not finite (a non-finite model stays so);
    one more for an epoch that raised."""
    bad = sum(not finite([float(ms[k]) for k in ("avg_m", "avg_age", "energy")]) for ms in per_epoch)
    if not all(finite(v) for v in w.carry.global_params.values()) or not all(finite(f) for f in f1s):
        bad = len(per_epoch)
    return bad + int(raised)


def resident_bytes(carry) -> int:
    """Bytes of the distinct tensors an epoch carry holds (global model,
    messages, moments, ages, batteries, scenario state)."""
    seen, total = set(), 0

    def walk(x):
        nonlocal total
        if isinstance(x, torch.Tensor):
            if x.data_ptr() not in seen:
                seen.add(x.data_ptr())
                total += x.numel() * x.element_size()
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (tuple, list)):
            for v in x:
                walk(v)

    walk(tuple(carry))
    return total


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "not read"
    except (OSError, subprocess.SubprocessError):
        return "not read"


def parse(argv) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python3 -m ehfl_bench.run", description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None, *, device: str | None = None, tiny: bool = False, fault: str | None = None) -> int:
    """One run.  ``device``, ``tiny`` and ``fault`` are the CPU tests':
    a device other than the card (no look for one), the cells' ``tiny``
    sizes, and a fault of ``faults.py`` planted under the timed path."""
    args = parse(argv)
    try:
        cell = world_lib.load_cell(args.workload, tiny=tiny)
    except FileNotFoundError as e:
        print(f"ehfl_bench: {e}", file=sys.stderr)
        return 2
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            print(f"ehfl_bench: the cell needs {cell['chips']} CUDA device(s); "
                  f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
            return 2
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
    else:
        dev = torch.device(device)
    # fp32 stays fp32: no TF32 in the program's convolutions and matmuls, nor in the reference's
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"ehfl_bench: set-up {time.perf_counter() - _START:.2f} s at the card", file=sys.stderr)
    try:
        w = build(cell, args.seed, dev)
    except ImportError as e:
        print(f"ehfl_bench: {e}", file=sys.stderr)
        return 3
    sync(dev)
    print(f"ehfl_bench: set-up {time.perf_counter() - _START:.2f} s with the inputs made", file=sys.stderr)
    t = settle(w)
    if fault is not None:
        plant(w, fault)
    t, snaps, snap_s = check_epochs(w, t)
    setup_s = time.perf_counter() - _START - snap_s
    print(f"ehfl_bench: set-up {setup_s:.2f} s with the warm-up ({snap_s:.2f} s of copies for the check left out)",
          file=sys.stderr)

    f1s: list = []
    raised = False
    per_epoch, evals, trace_raw = [], 0, None
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    if args.trace:
        def traced():
            return run_epochs(w, t, lambda run: run == cell["trace_epochs"], f1s)

        (t, per_epoch, evals), trace_raw = capture(traced)
        window_s = trace_raw["window_s"]
    else:
        t0 = time.perf_counter()
        try:
            t, per_epoch, evals = run_epochs(w, t, lambda run: time.perf_counter() - t0 >= args.seconds, f1s)
        except Exception:
            traceback.print_exc()
            raised = True
        sync(dev)
        window_s = time.perf_counter() - t0
        blocks = [(b - a) * 1e2 for a, b in zip(w.starts[::10], w.starts[10::10])]
        print(f"ehfl_bench: host ms an epoch, by 10 epochs: {', '.join(f'{b:.1f}' for b in blocks)}", file=sys.stderr)
    attempted = len(per_epoch) + int(raised)
    failed = count_failed(w, per_epoch, f1s, raised)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type,
                   "count": 1, "memory_peak_bytes": int(peak)}
    result = {}
    if args.trace:
        numbers = [{k: float(v) for k, v in ms.items() if v.dim() == 0} for ms in per_epoch]
        peaks = world_lib.load_json(BENCH / "peaks.json")
        tr = Trace(window_s=window_s, epochs=len(per_epoch), evals=evals, device_ops=trace_raw["device_ops"],
                   ranges=trace_raw["ranges"], epoch_metrics=numbers, cell=cell, cfg=w.cfg, family=w.family,
                   peaks=peaks, resident_bytes=resident_bytes(w.carry))
        metrics = {}
        for m in per_layer_metrics(args.workload):
            value = load_reader(m["name"])(tr)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device_info.update(busy_s=tr.busy_s(), window_s=window_s)
        linked = sum(op[3] is not None for op in tr.device_ops)
        print(f"ehfl_bench: {len(tr.device_ops)} device operations in the traced window, {linked} linked to the "
              f"host op that launched them", file=sys.stderr)
        result["breakdown"] = breakdown(tr)
    else:
        values = {"epoch_ms": window_s * 1e3 / max(len(per_epoch), 1), "peak_mem_gib": peak / 2**30,
                  "setup_s": setup_s}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]} for m in end_to_end_metrics(args.workload)}

    # the program's state goes before the reference runs
    w.carry = w.epoch_fn = None
    per_epoch = None
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    values = compare(w, snaps)
    checks = check.judge(values, cell["limits"])
    correct = check.passed(checks) and failed == 0 and attempted > 0
    device_info["power_limit"] = power_limit() if dev.type == "cuda" else "not a card"

    out = {"correct": correct, "attempted": attempted, "failed": failed, "metrics": metrics,
           "device": device_info, **result, "checks": checks}
    # last, after every reader and the reference: nothing the run loaded may be JAX or the JAX package
    found = forbidden_modules()
    if found:
        print(f"ehfl_bench: the run loaded {', '.join(found)}; the benchmark runs the port alone", file=sys.stderr)
        return 4
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
