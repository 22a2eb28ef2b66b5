"""The readings that the cells' limits are set from, on the card at the
cell's own size, many seeds in one process:

- ``program``: the port's ``check_epochs`` epochs after the fleet has
  settled, against the reference (the lower readings);
- ``fused``: the reference with each SGD update fused into one rounding,
  in the program's place: what a sound program with a fused update reads;
- ``control``: the reference computed in TF32 (every operand of a
  convolution or matrix product rounded to 10 mantissa bits, forward and
  backward) put in the program's place, against the fp32 reference (the
  upper readings);
- each fault of ``faults.py`` planted in the port, against the reference.

    python3 -m ehfl_bench.control --workload paper-cnn.n100.vaoi --seeds 1,2,3 \\
        --modes program,fused,control,unchanged,half_batch,altered_message,altered_global

prints one JSON line a (seed, mode) with the compared numbers, then a
summary (``--dump FILE`` also keeps each sampled client's per-step
losses and leaf gradient norms): each number's largest program and fused reading and each other
mode's smallest.  Each seed settles once; every mode runs its check epochs
from that settled state.  Not part of a benchmark run.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from ehfl_bench import check, run, world as world_lib

MODES = ("program", "fused", "control", "unchanged", "half_batch", "altered_message", "altered_global",
         "stale_moment")


def readings(workload: str, seeds, modes, device: str | None = None, tiny: bool = False,
             dump: str | None = None) -> dict:
    cell = world_lib.load_cell(workload, tiny=tiny)
    dev = torch.device(device or "cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    table = {}
    for seed in seeds:
        w = run.build(cell, seed, dev)
        t = run.settle(w)
        settled, window_fn = w.carry, w.epoch_fn
        for mode in modes:
            t0 = time.perf_counter()
            w.carry, w.fault, w.epoch_fn = settled, None, window_fn
            if mode not in ("program", "fused", "control"):
                run.plant(w, mode)
            _, snaps, _ = run.check_epochs(w, t)
            raw = [] if dump else None
            values = run.compare(w, snaps, side=mode if mode in ("fused", "control") else "program", raw=raw)
            if dump:
                with open(dump, "a") as f:
                    f.write(json.dumps({"workload": workload, "seed": seed, "mode": mode, "steps": raw}) + "\n")
            table.setdefault(mode, []).append(values)
            ok = check.passed(check.judge(values, cell["limits"]))
            print(json.dumps({"workload": workload, "seed": seed, "mode": mode, "correct": ok, **values,
                              "seconds": time.perf_counter() - t0}), flush=True)
            snaps = None
        w = settled = None
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    summary = {}
    for mode, rows in table.items():
        pick = max if mode in ("program", "fused") else min
        summary[mode] = {k: pick(r[k] for r in rows) for k in rows[0]}
    return summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m ehfl_bench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--modes", default=",".join(MODES))
    ap.add_argument("--dump", help="append each sampled client's per-step losses and leaf gradient norms here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("ehfl_bench.control: needs a CUDA device", file=sys.stderr)
        return 2
    seeds = [int(s) for s in args.seeds.split(",")]
    summary = readings(args.workload, seeds, args.modes.split(","), dump=args.dump)
    print(json.dumps({"workload": args.workload, "summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
