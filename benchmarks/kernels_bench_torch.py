"""Kernel micro-benchmarks on the PyTorch/CUDA port; the counterpart of
``benchmarks/kernels_bench.py``.

The same rows at the same shapes, all fp32: ``vaoi_distance`` (Eq. 5 +
Eq. 7), ``fedavg_reduce`` over the fleet and over the slab (K = 10, the
paper's k) in the TPU kernel's (K, P) signature, and ``swa_attention``
(window 256).  Each plain version (``repro_torch/kernels/ref.py``) is timed
on the chosen device under the JAX bench's row name.  On the card each
Hopper kernel (through ``repro_torch/kernels/ops.py``) is timed beside it at
the same inputs, with CUDA events, and held against it; its row adds the
achieved GB/s or GFLOP/s, the row's bound (bytes over the HBM rate or
operations over the fp32 peak, the larger), the share of that bound, the
library call that computes the same function (``vector_norm``, ``mv``,
SDPA with the band mask) and the kernel's launches, which must equal its
calls.

  PYTHONPATH=src python benchmarks/kernels_bench_torch.py               # quick shapes, on the card
  PYTHONPATH=src python benchmarks/kernels_bench_torch.py --full
  PYTHONPATH=src python benchmarks/kernels_bench_torch.py --device cpu  # the plain versions only
"""
from __future__ import annotations

import argparse
import statistics
import time
from typing import Callable, Dict, List

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import ops, ref
from repro_torch.launch.mesh import HBM_BW as HBM_BYTES_PER_S  # H100 SXM data sheet, defined once there
from repro_torch.launch.mesh import PEAK_FLOPS_FP32 as FP32_FLOPS

WINDOW = 256
SLAB = 10  # the compacted path's training slab: the paper's k
SHAPES = {
    True: dict(vaoi=(1024, 4096), fedavg=(64, 1 << 20), swa=(1, 4, 1024, 64)),
    False: dict(vaoi=(8192, 16384), fedavg=(128, 1 << 24), swa=(2, 8, 4096, 128)),
}
# the kernel against its plain version: the largest elementwise error over
# the largest element (at least 1)
TOL = {"vaoi_distance": 1e-6, "fedavg_reduce": 1e-5, "swa_attention": 2e-5}
CPU_ITERS = 5
CUDA_ITERS = 25


def cpu_us(fn: Callable, iters: int = CPU_ITERS) -> float:
    """Mean host time of ``iters`` calls after one warm-up (the JAX bench's
    protocol)."""
    fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters * 1e6


def cuda_us(fn: Callable, iters: int = CUDA_ITERS, warmup: int = 5) -> float:
    """Median CUDA-event time of ``iters`` calls after ``warmup``."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs) * 1e3


def bound_us(nbytes: float, flops: float) -> tuple:
    """The least time (µs) for this work, and whether bytes or operations set it."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
    return max(t_bytes, t_ops) * 1e6, "bytes" if t_bytes >= t_ops else "operations"


def live_pairs(s: int, window: int) -> int:
    """(query, key) pairs inside the causal band of ``window`` keys."""
    return sum(min(i + 1, window) for i in range(s))


def cases(shapes: Dict[str, tuple], device: torch.device) -> List[dict]:
    """Each row's inputs: its JAX name, the plain version, the kernel's
    entry, the library call, and the work for the rate and the bound."""
    g = torch.Generator().manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=g).to(device)

    out = []
    n, f = shapes["vaoi"]
    v, h, age, q = randn(n, f), randn(n, f), torch.ones(n, device=device), torch.zeros(n, device=device)
    nbytes = 2 * n * f * 4 + 4 * n * 4
    out.append(dict(
        kernel="vaoi_distance", name=f"vaoi_distance_ref/N{n}xF{f}", tag=f"N{n}xF{f}",
        plain=lambda: ref.vaoi_distance_ref(v, h, age, q, 0.5),
        port=lambda: ops.vaoi_distance(v, h, age, q, 0.5),
        library=lambda: torch.linalg.vector_norm(v - h, dim=1),
        nbytes=nbytes, flops=3 * n * f + 4 * n, rate="GBps",
        ref_derived=lambda us: f"bytes={2 * n * f * 4};GBps={2 * n * f * 4 / us / 1e3:.2f}",
    ))
    k, p = shapes["fedavg"]
    for rows, label in ((k, f"K{k}xP{p}"), (SLAB, f"slab_K{SLAB}xP{p}")):
        msgs, w = randn(rows, p), torch.full((rows,), 1.0 / rows, device=device)
        out.append(dict(
            kernel="fedavg_reduce", name=f"fedavg_reduce_ref/{label}", tag=label,
            plain=lambda msgs=msgs, w=w: ref.fedavg_reduce_ref(msgs, w),
            port=lambda msgs=msgs, w=w: ops.fedavg_reduce(msgs, w),
            library=lambda msgs=msgs, w=w: torch.mv(msgs.T, w),
            nbytes=rows * p * 4 + rows * 4 + p * 4, flops=2 * rows * p, rate="GBps",
            ref_derived=lambda us, rows=rows: f"GBps={rows * p * 4 / us / 1e3:.2f}",
        ))
    b, hh, s, d = shapes["swa"]
    qq, kk, vv = randn(b, hh, s, d), randn(b, hh, s, d), randn(b, hh, s, d)
    i = torch.arange(s, device=device)
    band = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - WINDOW)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out.append(dict(
        kernel="swa_attention", name=f"swa_attention_ref/S{s}w{WINDOW}", tag=f"S{s}w{WINDOW}",
        plain=lambda: ref.swa_attention_ref(qq, kk, vv, window=WINDOW),
        port=lambda: ops.swa_attention(qq, kk, vv, window=WINDOW),
        library=lambda: sdpa(qq, kk, vv, attn_mask=band),
        # the JAX row's rate counts s·w pairs; the bound counts the band's
        nbytes=4 * b * hh * s * d * 4, flops=4 * b * hh * live_pairs(s, WINDOW) * d, rate="GFLOPs",
        ref_derived=lambda us: f"GFLOPs={4 * b * hh * s * WINDOW * d / us / 1e3:.2f}",
    ))
    return out


def errors(got, want) -> tuple:
    """The largest elementwise error over the outputs, and the largest
    element of the plain version's."""
    got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
    return (max((a.float() - b.float()).abs().max().item() for a, b in zip(got, want)),
            max(b.float().abs().max().item() for b in want))


def kernel_row(case: dict) -> dict:
    """The kernel at the case's inputs on the card: held against its plain
    version, timed beside the plain version and the library call, and its
    launches counted."""
    name = case["kernel"]
    before = ops.launch_counts()[name]
    err, scale = errors(case["port"](), case["plain"]())
    if not err <= TOL[name] * max(1.0, scale):
        raise AssertionError(f"{name} at {case['tag']} parts from its plain version: {err} over a largest "
                             f"element of {scale} (tolerance {TOL[name]})")
    us = cuda_us(case["port"])
    launches = ops.launch_counts()[name] - before
    calls = 1 + 5 + CUDA_ITERS
    if launches != calls:
        raise AssertionError(f"{name} launched {launches} times for {calls} calls: the kernel did not run")
    b_us, b_by = bound_us(case["nbytes"], case["flops"])
    rate = case["nbytes"] / us / 1e3 if case["rate"] == "GBps" else case["flops"] / us / 1e3
    return {
        "name": f"kernel/{name}/{case['tag']}",
        "us_per_call": us,
        "derived": f"{case['rate']}={rate:.2f};bound_us={b_us:.4f};bound_by={b_by};bound_share={b_us / us:.4f}"
                   f";plain_us={cuda_us(case['plain']):.2f};library_us={cuda_us(case['library']):.2f}"
                   f";launches={launches};max_abs_err={err:.3g}",
    }


def run(quick: bool = True, device: str | torch.device | None = None, shapes: Dict[str, tuple] | None = None):
    """``benchmarks/run_torch.py`` suite entry: the plain versions' rows
    under the JAX bench's names; on the card also each kernel's row."""
    device = resolve_device(device)
    cuda = device.type == "cuda"
    rows = []
    for case in cases(shapes or SHAPES[quick], device):
        us = cuda_us(case["plain"]) if cuda else cpu_us(case["plain"])
        rows.append({"name": f"kernel/{case['name']}", "us_per_call": us, "derived": case["ref_derived"](us)})
        if cuda:
            rows.append(kernel_row(case))
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--full", action="store_true", help="the larger shapes")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    print("name,us_per_call,derived")
    for r in run(quick=not args.full, device=args.device):
        print(f"{r['name']},{r['us_per_call']:.1f},{r['derived']}")


if __name__ == "__main__":
    main()
