"""Per-device cost of one traced step: FLOPs, collectives, bytes, memory.

The counterpart of ``repro.launch.hlo_analysis``.  The port has no HLO:
the dry-run (``launch/dryrun.py``) runs a step on DTensors whose local
shards are fake tensors (``FakeTensorMode``: shapes, no data, nothing
allocated) over a ``fake`` process group, and :class:`StepCost` watches
the ops rank 0 runs on its own shards, as XLA's post-SPMD cost analysis
reads the per-device program:

* ``flops``: the matmul-class FLOPs (``torch.utils.flop_counter``'s
  formulas: mm, addmm, bmm, baddbmm, convolutions, attention) of every
  local op, the backward pass included.  A replicated op counts whole on
  every device; one sharded over ``data`` counts its shard.  Elementwise
  ops are not counted (XLA counts them; they are a small share of a
  transformer's FLOPs).
* ``collectives``: the bytes of every collective rank 0 issues, by the
  reference's five kinds, each op counted as max(operand bytes, output
  bytes) (the per-device link-traffic proxy ``hlo_analysis``'s docstring
  describes), with ``total`` and ``counts``.
* ``unfused_bytes``: the input plus output bytes of every local op that
  is not a view.  No fusion runs, so this is an upper bound of the HBM
  traffic (XLA's ``bytes accessed`` is after fusion); the roofline's
  memory term uses it.
* ``memory``: argument, output and peak live bytes of rank 0's tensors.

The ops DTensor runs on whole-shape fakes to propagate shapes
(``ShardingPropagator._propagate_tensor_meta_non_cached``) are not rank
0's work and are not counted.
"""
from __future__ import annotations

import contextlib
import weakref
from collections import defaultdict
from typing import Any, Dict, Iterator, List

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")

_KINDS = (
    ("all_gather", "all-gather"),
    ("reduce_scatter", "reduce-scatter"),
    ("all_reduce", "all-reduce"),
    ("all_to_all", "all-to-all"),
    ("permute", "collective-permute"),
    ("send", "collective-permute"),
    ("recv", "collective-permute"),
)


def roofline_terms(
    flops: float,
    hbm_bytes: float,
    coll_bytes: float,
    peak_flops: float,
    hbm_bw: float,
    net_bw: float,
) -> Dict[str, float]:
    """All inputs are PER-DEVICE quantities; returns seconds per term and
    the largest term's name (``hlo_analysis.roofline_terms``' arithmetic)."""
    t_compute = flops / peak_flops
    t_memory = hbm_bytes / hbm_bw
    t_collective = coll_bytes / net_bw
    terms = {"compute_s": t_compute, "memory_s": t_memory, "collective_s": t_collective}
    terms["bottleneck"] = max(terms, key=lambda k: terms[k] if k.endswith("_s") else -1).replace("_s", "")
    return terms


def _collective_kind(func) -> str | None:
    ns = func.namespace
    if "c10d" not in ns:
        return None
    name = func._overloadpacket.__name__
    for key, kind in _KINDS:
        if key in name:
            return kind
    return None


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree: Any) -> List[torch.Tensor]:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _local(t: torch.Tensor) -> torch.Tensor:
    return t._local_tensor if isinstance(t, DTensor) else t


@contextlib.contextmanager
def _marking_propagation(cost: "StepCost") -> Iterator[None]:
    """Mark the ops DTensor runs on whole-shape fakes to propagate shapes:
    ``cost.in_propagation`` is nonzero while they run."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    name = "_propagate_tensor_meta_non_cached"
    original = getattr(ShardingPropagator, name, None)
    if original is None:
        raise RuntimeError(f"this torch's ShardingPropagator has no {name}: the cost mode cannot tell its ops apart")

    def marked(self, *args, **kwargs):
        cost.in_propagation += 1
        try:
            return original(self, *args, **kwargs)
        finally:
            cost.in_propagation -= 1

    setattr(ShardingPropagator, name, marked)
    try:
        yield
    finally:
        setattr(ShardingPropagator, name, original)


class StepCost(TorchDispatchMode):
    """Counts rank 0's local ops while active (see the module docstring).
    ``track_arguments`` registers the step's inputs before it runs and
    ``track_outputs`` its results after; ``summary()`` is the record.
    ``record_collectives`` keeps one entry a collective (kind, bytes,
    shape, the ``record_function`` range that issued it, or "backward")."""

    def __init__(self, record_collectives: bool = False):
        super().__init__()
        self.flops = 0
        self.unfused_bytes = 0
        self.coll_bytes: Dict[str, int] = {k: 0 for k in COLLECTIVES}
        self.coll_counts: Dict[str, int] = {k: 0 for k in COLLECTIVES}
        self.flops_by_range: Dict[str, int] = defaultdict(int)
        self.bytes_by_range: Dict[str, int] = defaultdict(int)
        self.record = record_collectives
        self.collectives: List[Dict[str, Any]] = []
        self.live = 0
        self.peak = 0
        self.argument_bytes = 0
        self.output_bytes = 0
        self._live_ids: set = set()
        self._ranges: List[str] = []
        self.in_propagation = 0
        self._marking = _marking_propagation(self)

    def __enter__(self):
        self._marking.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._marking.__exit__(*exc)

    # -- memory ---------------------------------------------------------
    def _hold(self, t: torch.Tensor) -> int:
        """Count ``t``'s storage as live until it is freed; its bytes if it
        was new."""
        st = t.untyped_storage()
        key = id(st)
        if key in self._live_ids:
            return 0
        n = st.nbytes()
        self._live_ids.add(key)
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._release, key, n)
        return n

    def _release(self, key: int, n: int) -> None:
        self._live_ids.discard(key)
        self.live -= n

    def track_arguments(self, *trees: Any) -> None:
        for tree in trees:
            for t in _tensors(tree):
                self.argument_bytes += self._hold(_local(t))

    def track_outputs(self, *trees: Any) -> None:
        self.output_bytes = sum(_nbytes(_local(t)) for tree in trees for t in _tensors(tree))

    # -- the ops ----------------------------------------------------------
    def _range(self) -> str:
        if torch._C._current_graph_task_id() != -1:
            return "backward"
        return self._ranges[-1] if self._ranges else "-"

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # DTensor runs it on the local shards, which come back here
        out = func(*args, **kwargs)
        if func is torch.ops.profiler._record_function_enter_new.default:
            self._ranges.append(args[0])
            return out
        if func is torch.ops.profiler._record_function_exit._RecordFunction:
            if self._ranges:
                self._ranges.pop()
            return out
        if self.in_propagation:
            return out
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        kind = _collective_kind(func)
        if kind is not None:
            nbytes = max(sum(map(_nbytes, ins)), sum(map(_nbytes, outs)))
            self.coll_bytes[kind] += nbytes
            self.coll_counts[kind] += 1
            if self.record:
                shape = tuple(outs[0].shape) if outs else ()
                dtype = str(outs[0].dtype).replace("torch.", "") if outs else ""
                self.collectives.append(
                    {"kind": kind, "bytes": nbytes, "shape": shape, "dtype": dtype, "range": self._range()}
                )
        elif func._overloadpacket in flop_registry:
            n = flop_registry[func._overloadpacket](*args, **kwargs, out_val=out)
            self.flops += n
            self.flops_by_range[self._range()] += n
        if kind is None and not func.is_view and "wait_tensor" not in func.name():
            n = sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
            self.unfused_bytes += n
            self.bytes_by_range[self._range()] += n
        for t in outs:
            self._hold(t)
        return out

    def summary(self) -> Dict[str, Any]:
        coll = dict(self.coll_bytes)
        coll["total"] = sum(self.coll_bytes.values())
        return {
            "flops": float(self.flops),
            "unfused_bytes": float(self.unfused_bytes),
            "collectives": coll,
            "collective_counts": dict(self.coll_counts),
            "memory": {
                "argument_bytes": self.argument_bytes,
                "output_bytes": self.output_bytes,
                "temp_bytes": self.peak - self.argument_bytes,
                "peak_bytes": self.peak,
            },
        }
