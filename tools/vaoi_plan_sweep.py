#!/usr/bin/env python3
"""Every segment count of ``vaoi_distance``'s cluster route at a set of
shapes, on one GPU: each held to the plain version and to itself bit for
bit, then timed on the device.

    PYTHONPATH=src python3 tools/vaoi_plan_sweep.py [--quick] [--out FILE]

The sweep passes each S of {1, 2, 4, 8, 16} to the C launcher in the
wrapper's parameter block (``split_plan`` picks one of them).  Every S must
give m within 1e-5 of the plain version's (relative to the largest m), the
ages exactly (mu between the rows' m, so both branches of Eq. 7 are taken),
and two calls the same bits, also on rows one element off 16-byte
alignment (v and h alike, and v alone).  Timing uses ``chip_smoke.py``'s
helpers: each S's kernel time under ``torch.profiler`` (``device_ms``),
back to back (inputs of 50 MB or less then sit in L2) and with a 128 MB
write between launches (cold); the wrapper, its launch floor and
``vector_norm(v - h)`` by CUDA events in turns (``interleaved_ms``).
Prints one JSON line a (shape, dtype): the segment counts by warm device
time, the chosen one's rank and the byte bound (2·N·F·elt + 16·N over
3.35 TB/s), then the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke as cs  # noqa: E402  (puts src/ on the path)
import torch  # noqa: E402

from repro_torch.kernels import build, ref  # noqa: E402
from repro_torch.kernels import vaoi_distance as kv  # noqa: E402

# the LM shapes and the kernels bench's, one row over 16 segments, --full's
# bench shape; short rows of many clients and a few (S = 1, a block a row)
SHAPES = [(8, 151_936), (4, 102_400), (1024, 4096), (1, 151_936), (8192, 16_384), (16_384, 256), (100, 130)]
QUICK = SHAPES[:3]
ITERS = 20


def launcher(segments, v, h, age, q, mu):
    """A call of the C launcher on ``segments``: fresh outputs, raises on a launch error."""
    m, a = torch.empty_like(age), torch.empty_like(age)
    args = kv._ARGS.pack(v.data_ptr(), h.data_ptr(), age.data_ptr(), q.data_ptr(), m.data_ptr(), a.data_ptr(),
                         torch.cuda.current_stream().cuda_stream, mu, *v.shape, v.dtype == torch.bfloat16, segments)
    fn = kv._launcher("vaoi_distance_launch")

    def call():
        err = fn(args)
        if err:
            raise RuntimeError(f"S = {segments}: CUDA error {err}")
        return m, a
    return call


def inputs(n, f, dtype, g, offset=(0, 0)):
    """v, h (each ``offset`` elements into its storage), age, q on the card."""
    def at(off):
        x = torch.empty(n * f + off, dtype=dtype, device="cuda")[off:].view(n, f)
        return x.copy_(torch.randn(n, f, generator=g).to(dtype))
    age = torch.randint(0, 9, (n,), generator=g).float().cuda()
    return at(offset[0]), at(offset[1]), age, (torch.rand(n, generator=g) < 0.4).float().cuda()


def check(segments, v, h, age, q) -> float:
    mu = cs.vaoi_mu_between(torch, v, h)
    call = launcher(segments, v, h, age, q, mu)
    m1, a1 = (t.clone() for t in call())
    m2, a2 = call()
    rm, ra = ref.vaoi_distance_ref(v, h, age, q, mu)
    err = ((m1 - rm).abs().max() / rm.abs().max().clamp_min(1.0)).item()
    what = f"S = {segments} at {tuple(v.shape)} {v.dtype}"
    if not (err <= 1e-5 and torch.equal(a1, ra)):
        raise AssertionError(f"{what}: m off by {err} or ages differ")
    if not (torch.equal(m1, m2) and torch.equal(a1, a2)):
        raise AssertionError(f"{what}: two calls differ")
    return err


def kernel_ms(call, flush=None) -> float:
    """The vaoi kernel's device time a call."""
    got = cs.device_ms(call if flush is None else (lambda: (flush.zero_(), call())), ITERS, only="vaoi")
    if not got["kernels_per_call"]:
        raise AssertionError("the profiler caught no vaoi launch in five sessions")
    return got["ms"]


def sweep(n, f, dtype, g, sms, flush) -> dict:
    v, h, age, q = inputs(n, f, dtype, g)
    counts = list(kv.SEGMENTS)
    chosen = kv.split_plan(n, f, v.element_size(), sms)
    errs = [check(s, v, h, age, q) for s in counts]
    for offset in ((1, 1), (1, 0)):  # both off 16 bytes alike (head, body, tail), v alone (scalar loads)
        vo, ho, ao, qo = inputs(n, f, dtype, g, offset)
        errs += [check(s, vo, ho, ao, qo) for s in counts]
        del vo, ho
    mu = cs.vaoi_mu_between(torch, v, h)
    calls = [launcher(s, v, h, age, q, mu) for s in counts]
    warm = [kernel_ms(c) for c in calls]
    cold = [kernel_ms(c, flush) for c in calls]
    order = sorted(range(len(counts)), key=lambda i: warm[i])
    timed = cs.interleaved_ms({
        "ms": lambda: kv.vaoi_distance(v, h, age, q, mu),
        "launch_floor_ms": lambda: kv.launch_floor(v, h, age, q, mu),
        "library_ms": lambda: torch.linalg.vector_norm(v - h, dim=-1),
    }, cs.EHFL_ITERS)
    bound_ms, _ = cs.bound(2 * n * f * v.element_size() + 16 * n, 0)
    i = counts.index(chosen)
    return {
        "shape": [n, f], "dtype": str(dtype).removeprefix("torch."), "bound_ms": bound_ms,
        "plan": kv.plan_of(v), "chosen_rank": order.index(i), "chosen_warm_ms": warm[i], "chosen_cold_ms": cold[i],
        **timed, "max_rel_err": max(errs),
        "by_warm_ms": [{"segments": counts[j], "warm_ms": warm[j], "cold_ms": cold[j]} for j in order],
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--quick", action="store_true", help="the three shapes of the main paths and the bench")
    ap.add_argument("--out", help="also write the lines to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("vaoi_plan_sweep: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    build.build(["vaoi_distance"])
    for r in build.ptxas_report("vaoi_distance"):
        print(json.dumps({"ptxas": r}), flush=True)
    sms = kv.sm_count(torch.cuda.current_device())
    cs.device_ms(lambda: torch.ones(1, device="cuda").add_(1))  # the first session misses launches
    flush = torch.empty(32 << 20, dtype=torch.float32, device="cuda")
    g = torch.Generator().manual_seed(0)
    lines = []
    for n, f in QUICK if args.quick else SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            line = sweep(n, f, dtype, g, sms, flush)
            lines.append(line)
            print(json.dumps(line), flush=True)
            torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    if args.out:
        with open(args.out, "w") as fh:
            fh.writelines(json.dumps(x) + "\n" for x in lines)
    print(json.dumps({"card": smi, "sms": sms, "shapes": len(lines)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
