"""The traced window: epochs under ``torch.profiler``, read into the plain
record that the per-layer metric readers (``metrics/*.py``) take.

The port's kernels are read by name: their ctypes launches belong to no
host op.  A range's device time is that of the device operations whose
launching host op (linked by correlation id) started while the range was
open, as the union of their intervals: cuDNN runs some of them side by
side, so a sum of durations (the profiler's own per-range sums) read more
device time for a range than the whole window was busy.  A profiler session
now and then delivers none of its kernel records; then up to
``SESSIONS`` - 1 more are taken, each over new epochs, and a window that
still has none fails the run (a roofline would divide by its zero).
"""
from __future__ import annotations

import bisect
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Tuple

import torch

SESSIONS = 5
NOT_KERNELS = ("Memcpy", "Memset")  # device operations that are not kernel launches


@dataclass
class Trace:
    window_s: float  # host wall time of the traced epochs, ended by a synchronize
    epochs: int
    evals: int
    device_ops: List[Tuple[str, float, float, Any]]  # (name, start us, end us, launch us or None): each once
    ranges: List[Tuple[str, float, float]]  # (name, start us, end us) of the ehfl.* / lm.* ranges on the host
    epoch_metrics: List[Dict[str, float]]  # the traced epochs' metrics, as numbers
    cell: Dict[str, Any]
    cfg: Any  # the port's EHFLConfig
    family: Any  # the cell's module under families/
    peaks: Dict[str, float]
    resident_bytes: int = 0  # bytes of the tensors the epoch carry holds after the traced epochs
    memo: Dict[str, Any] = field(default_factory=dict)

    @property
    def kernels(self) -> List[Tuple[str, float, float, Any]]:
        return [op for op in self.device_ops if not op[0].startswith(NOT_KERNELS)]

    def kernel_us(self, part: str, exclude: str | None = None) -> Tuple[float, int]:
        """Summed device time (us) and count of the kernels whose name holds ``part``."""
        hits = [e - s for n, s, e, _ in self.kernels if part in n and (exclude is None or exclude not in n)]
        return sum(hits), len(hits)

    def range_ms(self, name: str) -> Tuple[float, float, int]:
        """Host ms of the ranges called ``name``, the device ms in which
        operations launched inside them ran (the union of their intervals:
        cuDNN runs some kernels side by side), and the ranges' count."""
        if "by_launch" not in self.memo:
            ops = sorted((launch, s, e) for _, s, e, launch in self.device_ops if launch is not None)
            self.memo["by_launch"] = ([op[0] for op in ops], ops)
        times, ops = self.memo["by_launch"]
        rows = [r for r in self.ranges if r[0] == name]
        spans = [op[1:] for _, s, e in rows for op in ops[bisect.bisect_left(times, s):bisect.bisect_right(times, e)]]
        return sum(e - s for _, s, e in rows) / 1e3, _union_us(spans) / 1e3, len(rows)

    def busy_intervals(self) -> List[Tuple[float, float]]:
        if "busy" not in self.memo:
            self.memo["busy"] = _merged([op[1:3] for op in self.device_ops])
        return self.memo["busy"]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e6


def _merged(spans) -> List[Tuple[float, float]]:
    """The union of (start, end) intervals, as disjoint intervals in order."""
    merged: List[List[float]] = []
    for s, e in sorted(spans):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def _union_us(spans) -> float:
    return sum(e - s for s, e in _merged(spans))


def capture(run: Callable[[], Any], prefixes=("ehfl.", "lm.")) -> Tuple[Any, Dict[str, Any]]:
    """``run()`` (some epochs, returning what it ran) under the profiler,
    taken again while a session holds no device operation.  Reads the
    profiler's raw records: every device operation once, its launch (the
    host op it is linked to by correlation id) and the ranges."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(SESSIONS):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            info = run()
            torch.cuda.synchronize()
            window_s = time.perf_counter() - t0
        host, device, ranges = {}, [], []
        for k in prof.profiler.kineto_results.events():
            kind, name = k.device_type(), k.name()
            if kind == DeviceType.CPU:
                host[k.correlation_id()] = k.start_ns() / 1e3
                if name.startswith(prefixes):
                    ranges.append((name, k.start_ns() / 1e3, k.end_ns() / 1e3))
            # the ranges' own device-side annotations are not operations
            elif kind == DeviceType.CUDA and not k.is_user_annotation() and not name.startswith(prefixes):
                device.append((name, k.start_ns() / 1e3, k.end_ns() / 1e3, k.linked_correlation_id()))
        if device:
            ops = [(name, s, e, host.get(link) if link > 0 else None) for name, s, e, link in device]
            return info, {"window_s": window_s, "device_ops": ops, "ranges": ranges}
    raise RuntimeError(f"the profiler returned no device operations in {SESSIONS} sessions")


def breakdown(trace: Trace, top: int = 10) -> Dict[str, List[List[Any]]]:
    """The device operations that took most time, and the idle gaps between
    device operations summed by the innermost ``ehfl.*`` / ``lm.*`` range
    the host was in at the gap's middle (seconds)."""
    by_op: Dict[str, float] = {}
    for name, s, e, _ in trace.device_ops:
        by_op[name[:100]] = by_op.get(name[:100], 0.0) + (e - s) / 1e6
    busy = trace.busy_intervals()
    # host ranges nest, so a sweep in time order keeps the innermost open one last
    marks = sorted([(s, 1, i) for i, (_, s, _) in enumerate(trace.ranges)]
                   + [(e, 0, i) for i, (_, _, e) in enumerate(trace.ranges)])
    open_ranges: List[int] = []
    j = 0
    by_range: Dict[str, float] = {}
    for (_, e0), (s1, _) in zip(busy, busy[1:]):
        mid = (e0 + s1) / 2
        while j < len(marks) and marks[j][0] <= mid:
            _, opening, i = marks[j]
            if opening:
                open_ranges.append(i)
            elif i in open_ranges:
                open_ranges.remove(i)
            j += 1
        where = trace.ranges[open_ranges[-1]][0] if open_ranges else "outside ehfl.* ranges"
        by_range[where] = by_range.get(where, 0.0) + (s1 - e0) / 1e6
    order = lambda d: sorted(([k, v] for k, v in d.items()), key=lambda kv: kv[1], reverse=True)[:top]
    return {"device_ops": order(by_op), "idle_gaps": order(by_range)}
