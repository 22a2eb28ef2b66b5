"""Benchmark harness of the PyTorch/CUDA port; the counterpart of
``benchmarks/run.py``.

Prints ``name,us_per_call,derived`` CSV.  Default is the quick protocol
(the same structural constants as the paper); ``--full`` runs the larger
grids.  The ``fleet``, ``stream`` and ``channel`` suites also write
``BENCH_fleet_torch.json``, ``BENCH_stream_torch.json`` and
``BENCH_channel_torch.json`` at the repo root.  Every suite runs on the
card unless ``--device cpu`` says otherwise; ``roofline`` reads the
dry-run's records (``experiments/dryrun_torch/``) and runs nothing.

Every suite runs under a wall-clock watchdog (``--suite-timeout``, default
900 s): a suite that hangs (a deadlocked collective, a runaway build) kills
the harness with exit 1.  A suite that fails, or a name that is not a
suite, makes the harness exit 1 after the rest have run.

  PYTHONPATH=src python -m benchmarks.run_torch --only kernels,stream,channel,fleet
  PYTHONPATH=src python -m benchmarks.run_torch --device cpu --only stream,channel
"""
from __future__ import annotations

import argparse
import importlib
import os
import sys
import threading
import time
from typing import Callable, Dict


def _suite(module: str) -> Callable:
    """A suite that imports its module when it runs."""

    def run(quick: bool, device):
        return importlib.import_module(f"benchmarks.{module}").run(quick=quick, device=device)

    return run


SUITES: Dict[str, Callable] = {
    "kernels": _suite("kernels_bench_torch"),
    "fig4": _suite("fig4_f1_torch"),
    "fig5": _suite("fig5_vaoi_torch"),
    "fig6": _suite("fig6_energy_torch"),
    "ablation": _suite("ablation_mu_torch"),
    "fleet": _suite("fleet_bench_torch"),
    "stream": _suite("stream_bench_torch"),
    "channel": _suite("channel_bench_torch"),
    "roofline": _suite("roofline_torch"),
}


def _watchdog(suite: str, timeout_s: float) -> threading.Timer:
    """Arm a wall-clock kill switch for one suite.  ``os._exit`` (not
    ``sys.exit``) so that a hang in native code cannot swallow the exit."""

    def _kill() -> None:
        print(f"{suite}/TIMEOUT,0,exceeded {timeout_s:.0f}s wall clock", file=sys.stderr, flush=True)
        os._exit(1)

    t = threading.Timer(timeout_s, _kill)
    t.daemon = True
    t.start()
    return t


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--only", default=None, help=f"comma list from: {','.join(SUITES)}")
    ap.add_argument(
        "--suite-timeout", type=float, default=900.0,
        help="per-suite wall-clock limit in seconds; a suite that exceeds it fails the harness (exit 1)",
    )
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    quick = not args.full
    wanted = args.only.split(",") if args.only else list(SUITES)

    print("name,us_per_call,derived", flush=True)
    failed = []
    for name in wanted:
        if name not in SUITES:
            print(f"{name}/ERROR,0,UnknownSuite", file=sys.stderr)
            failed.append(name)
            continue
        t0 = time.time()
        watchdog = _watchdog(name, args.suite_timeout)
        try:
            rows = SUITES[name](quick, args.device)
        except Exception as e:  # keep the harness going, but record the failure
            print(f"{name}/ERROR,0,{type(e).__name__}:{e}", flush=True)
            failed.append(name)
            continue
        finally:
            watchdog.cancel()
        for r in rows:
            print(f"{r['name']},{r['us_per_call']:.1f},{r['derived']}")
        print(f"{name}/_suite_wall,{(time.time() - t0) * 1e6:.0f},ok", file=sys.stderr, flush=True)
    if failed:
        print(f"FAILED suites: {','.join(failed)}", file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main()
