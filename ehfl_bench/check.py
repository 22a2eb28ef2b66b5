"""The comparison that decides ``correct``.

Set-up drives the program's epoch function through its first
``check_epochs`` epochs (the warm-up, the window's own call and feed) and
keeps, of each, the program's state before and after it, the messages it
holds, and, for up to ``check_lanes`` clients that trained (drawn from the
seed), each local SGD step's loss and gradient as the optimizer got them
(:class:`Recorder`).  After the window the reference follows each epoch
stage by stage from the program's own state (``reference/ehfl.py`` says
why), and :func:`numbers` sets the two side by side:

- ``state_mismatches`` (exact): the selection (Alg. 2), the ages (Eq. 7),
  the slot scan's batteries, pending flags, clients started and its
  counts (started, uploaded, delivered, energy), summed over the epochs;
- ``avg_m_gap`` (VAoI policies): each epoch's mean Eq. 5 distance, the
  probe's features of the global model against the moments, relative;
- ``loss_gap``: each SGD step's loss gap over the larger of its loss and
  the median loss of the epoch's sampled steps; the median over a
  client's steps, the worst client and epoch (one step whose gradient a
  rounding-sized ReLU flip moved would otherwise set the number alone);
- ``grad_norm_gap``: per leaf, the gap between the norms of a step's
  gradient on the two sides over the largest of the reference's norm of
  that leaf, of the step's median leaf, of that leaf's median norm over
  the epoch's sampled steps, and of the median of those over the leaves;
  the worst leaf, the median over a client's steps, the worst client and
  epoch;
- ``h_gap`` (VAoI policies): the largest difference in an Eq. 6 moment;
- ``update_gap``: each trained message against the program's own
  gradients applied to the global model step by step (the SGD update and
  the slab's write-back), per leaf as above against the message's change;
- ``fedavg_gap``: the new global model against the mean of the delivered
  messages, per leaf as above against the global model's change.
"""
from __future__ import annotations

import math
import statistics
from typing import Any, Dict, List

import numpy as np
import torch

EXACT = ("selected", "age", "battery", "pending")
COUNTS = ("n_started", "n_uploaded", "n_delivered", "energy")


def _cpu(params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach().float().cpu() for k, v in params.items()}


class _Tap(torch.autograd.Function):
    """The identity, whose ``vmap`` rule hands the batched tensors to the
    recording :class:`Recorder` (``_Tap.sink``).  One class for all
    recorders: a class made per recorder lives in a reference cycle, which
    only a full collection frees, and would keep its records on the card."""

    sink = None

    @staticmethod
    def forward(*xs):
        return tuple(x.clone() for x in xs)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, *xs):
        if _Tap.sink is not None:
            lanes = [x.movedim(d, 0) if d is not None else x.expand(info.batch_size, *x.shape)
                     for x, d in zip(xs, in_dims)]
            _Tap.sink.append([x.detach().clone() for x in lanes])
        return tuple(x.clone() for x in xs), tuple(in_dims)


class Recorder:
    """Keeps each local SGD step's per-lane loss and gradients, as the
    optimizer gets them.  :meth:`tap` gives the backend (the simulator's
    model plug-in) with ``grad_loss`` passed through an identity whose
    ``vmap`` rule sees the batched outputs: one entry each time the
    simulator calls the batched ``grad_loss``, one a SGD step.  It reads
    no private name of the simulator, and the window's backend has no tap."""

    def __init__(self):
        self.steps = []

    def tap(self, backend):
        steps, grad_loss = self.steps, backend.grad_loss

        def tapped(p, x, y):
            loss, grads = grad_loss(p, x, y)
            keys, got = list(grads), []
            _Tap.sink = got
            try:
                out = _Tap.apply(loss, *(grads[k] for k in keys))
            finally:
                _Tap.sink = None
            if got:  # a batched call: name the gradients by leaf
                steps.append((got[0][0], dict(zip(keys, got[0][1:]))))
            return out[0], dict(zip(keys, out[1:]))

        return backend._replace(grad_loss=tapped)


def epoch_snapshot(t: int, cin, cout, metrics: Dict[str, torch.Tensor], steps: list, compact: bool, keep: int,
                   rng: np.random.Generator, vaoi: bool, kappa: int) -> Dict[str, Any]:
    """One program epoch as the comparison reads it, on the host: its input
    state, its outputs, the messages the FedAvg may read, and the sampled
    clients' per-step losses and gradients.  The slab's lane j holds the
    j-th client that started (clients in ascending order); the dense path's
    lane i client i."""
    if len(steps) != kappa:
        raise RuntimeError(f"epoch {t}: the simulator called the batched grad_loss {len(steps)} times, not once "
                           f"for each of the {kappa} SGD steps; the check cannot follow its local training")
    changed = None
    for k, v in cout.msg_params.items():
        row = (v != cin.msg_params[k]).reshape(v.shape[0], -1).any(dim=1)
        changed = row if changed is None else changed | row
    started = np.flatnonzero(changed.cpu().numpy())
    pending_in = cin.pending.cpu().numpy()
    order = started if compact else np.arange(len(pending_in))
    lane_of = {int(c): j for j, c in enumerate(order)}
    kept = sorted(int(c) for c in rng.choice(started, size=min(keep, len(started)), replace=False))
    rows_of = lambda msgs, clients: {int(c): {k: v[int(c)].float().cpu() for k, v in msgs.items()} for c in clients}
    new_rows = rows_of(cout.msg_params, started)
    lanes = {}
    for c in kept:
        j = lane_of[c]
        lanes[c] = {"loss": [float(loss[j]) for loss, _ in steps],
                    "grads": [{k: g[j].float().cpu() for k, g in grads.items()} for _, grads in steps],
                    "h": cout.h[c].float().cpu() if vaoi else None, "final": new_rows[c]}
    return {
        "t": t,
        "in": {"global": _cpu(cin.global_params), "h": cin.h.float().cpu(), "age": cin.age.cpu().numpy(),
               "battery": cin.battery.cpu().numpy().astype(np.int64), "pending": pending_in},
        "rows": {"old": rows_of(cin.msg_params, np.flatnonzero(pending_in)), "new": new_rows},
        "out": {"selected": metrics["selected"].cpu().numpy(), "age": cout.age.cpu().numpy(),
                "battery": cout.battery.cpu().numpy().astype(np.int64), "pending": cout.pending.cpu().numpy(),
                "started": set(started.tolist()), **{k: int(metrics[k]) for k in COUNTS},
                "avg_m": float(metrics["avg_m"]), "global": _cpu(cout.global_params), "lanes": lanes},
    }


def _worst_leaf(gaps: Dict[str, float], norms: Dict[str, float]) -> float:
    """max over leaves of gaps[leaf] / max(norms[leaf], median norm)."""
    med = statistics.median(norms.values())
    worst = 0.0
    for k, gap in gaps.items():
        den = max(norms[k], med)
        worst = max(worst, gap / den if den > 0 else (0.0 if gap == 0 else math.inf))
    return worst


def _diff(a: Dict[str, torch.Tensor], b: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: a[k].detach().double().cpu() - b[k].detach().double().cpu() for k in b}


def _norms(d: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v.norm()) for k, v in d.items()}


def numbers(side: List[Dict[str, Any]], ref: List[Dict[str, Any]], inputs: List[Dict[str, Any]],
            vaoi: bool, raw: list | None = None) -> Dict[str, float]:
    """The compared numbers of one side's epochs (the program's outputs, or
    the control's) against the reference's, with the program's input
    state of each epoch.  ``raw``, where given, gets each sampled client's
    per-step losses and leaf gradient norms on both sides."""
    out = dict.fromkeys(("state_mismatches", "loss_gap", "grad_norm_gap", "update_gap", "fedavg_gap"), 0.0)
    if vaoi:
        out.update(avg_m_gap=0.0, h_gap=0.0)
    worse = lambda key, value: out.__setitem__(key, max(out[key], value))
    for e, (s, r, inp) in enumerate(zip(side, ref, inputs)):
        mism = sum(int(np.sum(np.asarray(s[k]) != np.asarray(r[k]))) for k in EXACT)
        mism += sum(abs(s[k] - r[k]) for k in COUNTS) + len(s["started"] ^ r["started"])
        out["state_mismatches"] += mism + (r["global"] is None)
        if vaoi:
            worse("avg_m_gap", abs(s["avg_m"] - r["avg_m"]) / max(abs(r["avg_m"]), 1e-30))
        lanes = sorted(set(s["lanes"]) & set(r["lanes"]))
        steps = {c: [(la, lb, _norms({k: v.double() for k, v in ga.items()}),
                      _norms({k: v.double() for k, v in gb.items()}))
                     for la, lb, ga, gb in zip(s["lanes"][c]["loss"], r["lanes"][c]["loss"], s["lanes"][c]["grads"],
                                               r["lanes"][c]["grads"])] for c in lanes}
        every = [st for c in lanes for st in steps[c]]
        if every:
            # floors over the epoch's sampled steps: a well-fit batch's loss and
            # gradients are all but zero, and a gap over them reads the
            # cancellation in log-softmax, not the program
            loss_floor = statistics.median(abs(lb) for _, lb, _, _ in every)
            leaf_floor = {k: statistics.median(gb[k] for _, _, _, gb in every) for k in every[0][3]}
            leaf_floor = {k: max(v, statistics.median(leaf_floor.values())) for k, v in leaf_floor.items()}
        for c in lanes:
            a, b = s["lanes"][c], r["lanes"][c]
            worse("loss_gap", statistics.median(abs(la - lb) / max(abs(lb), loss_floor, 1e-30)
                                                for la, lb, _, _ in steps[c]))
            worse("grad_norm_gap", statistics.median(
                max(abs(ga[k] - gb[k]) / max(gb[k], leaf_floor[k], statistics.median(gb.values()), 1e-30) for k in gb)
                for _, _, ga, gb in steps[c]))
            if raw is not None:
                raw.append({"epoch": e, "client": c, "loss": [[la, lb] for la, lb, _, _ in steps[c]],
                            "leaves": list(steps[c][0][3]) if steps[c] else [],
                            "norms": [[list(ga.values()), list(gb.values())] for _, _, ga, gb in steps[c]]})
            if vaoi:
                worse("h_gap", float((a["h"].double().cpu() - b["h"].double().cpu()).abs().max()))
            worse("update_gap", _worst_leaf(_norms(_diff(a["final"], b["final"])),
                                            _norms(_diff(b["final"], inp["global"]))))
        if r["global"] is not None:
            worse("fedavg_gap", _worst_leaf(_norms(_diff(s["global"], r["global"])),
                                            _norms(_diff(r["global"], inp["global"]))))
    return out


def judge(values: Dict[str, float], limits: Dict[str, float]) -> Dict[str, Dict[str, float]]:
    """Each compared number beside its limit (-1 where the cell has none)."""
    return {k: {"value": v, "limit": limits.get(k, -1.0)} for k, v in values.items()}


def passed(checks: Dict[str, Dict[str, float]]) -> bool:
    """Every number finite and within its limit; a number without a limit fails."""
    return all(math.isfinite(c["value"]) and c["limit"] >= 0 and c["value"] <= c["limit"] for c in checks.values())
