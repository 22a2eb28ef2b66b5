"""One epoch of the paper's Alg. 1 written out plainly, for the reference,
followed stage by stage from the program's own state.

The port's local SGD is chaotic on the card: cuDNN's algorithms sum in an
order of their own, and where a rounding-sized difference flips a ReLU or
a max-pool choice, that position's gradient changes, which later steps
amplify; two runs of the port from the same inputs part within an epoch.
So each stage is computed from the program's inputs to it:

- Alg. 2's selection from the program's ages and the epoch's noise (top-k
  of p_i = X_i / Σ X_j plus the noise; everyone under ``fedavg``);
- the probe and Eq. 5 + 7 from the program's global model, moments and ages;
- the slot-level energy dynamics of §III-C, a loop over slots and clients
  in numpy, from the program's batteries and pending flags;
- each sampled client's κ SGD steps: the loss, the gradient and the Eq. 6
  feature at every step from the program's weights before that step (the
  global model, then each step's ``p - lr * g`` of the program's gradient,
  the same fp32 operations);
- FedAvg as the fp64 mean of the delivered messages the program holds (a
  client that entered the epoch with an unsent message uploads that one).

``model`` gives ``loss(p, x, y)``, ``feature(p, x)`` and ``probe(p,
images)``.  Imports nothing of the program.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

Params = Dict[str, torch.Tensor]


def select(policy: str, age: np.ndarray, noise: np.ndarray, k: int) -> np.ndarray:
    n = len(age)
    if policy == "fedavg":
        return np.ones(n, bool)
    age = age.astype(np.float32)
    total = np.float32(age.sum(dtype=np.float64))
    p = age / max(total, np.float32(1e-12)) if total > 0 else np.zeros(n, np.float32)
    scores = (p.astype(np.float32) + noise.astype(np.float32)).astype(np.float32)
    top = np.argsort(-scores, kind="stable")[:k]
    mask = np.zeros(n, bool)
    mask[top] = True
    return mask


def slot_scan(battery, pending, selected, harvest, S: int, kappa: int, e_max: int) -> Dict[str, np.ndarray]:
    """S slots: an arrival at the start of a slot (battery capped at
    E_max); a selected client with kappa units, nothing pending and no run
    yet starts training at the first slot <= S - kappa; the run takes kappa
    slots; a finished (or carried) message is sent at the first later slot
    with a unit to spare, once an epoch."""
    n = len(battery)
    b, pend = np.asarray(battery, np.int64).copy(), np.asarray(pending, bool).copy()
    started, uploaded = np.zeros(n, bool), np.zeros(n, bool)
    start_slot = np.full(n, S)
    energy = np.zeros(n, np.int64)
    for s in range(S):
        for i in range(n):
            b[i] = min(b[i] + int(harvest[s, i]), e_max)
            busy = started[i] and start_slot[i] <= s < start_slot[i] + kappa
            if s <= S - kappa and selected[i] and not started[i] and not busy and not pend[i] and b[i] >= kappa:
                started[i], start_slot[i] = True, s
                b[i] -= kappa
                energy[i] += kappa
            busy = started[i] and start_slot[i] <= s < start_slot[i] + kappa
            done = started[i] and start_slot[i] + kappa == s + 1
            pend[i] = pend[i] or done
            if pend[i] and not busy and not done and b[i] >= 1 and not uploaded[i]:
                b[i] -= 1
                energy[i] += 1
                pend[i], uploaded[i] = False, True
    return {"battery": b, "pending": pend, "started": started, "uploaded": uploaded, "energy": energy}


def forced_sgd(model, p0: Params, x: torch.Tensor, y: torch.Tensor, perm: np.ndarray, kappa: int, lr: float,
               grads: list, with_feature: bool, fused: bool = False) -> Dict[str, Any]:
    """A client's kappa SGD steps from ``p0``, each step's loss, gradient and
    feature computed here from the weights the program's gradients
    ``grads`` lead to.  Returns the losses, gradients, the Eq. 6 moment and
    the weights after the last step.  ``fused``: each update as one
    ``add(p, g, alpha=-lr)``, the same step in one rounding where the card
    fuses it (the reading a fused SGD update of the program would give)."""
    bs = len(perm) // kappa
    p = {k: v.detach().float() for k, v in p0.items()}
    losses, my_grads, fsum = [], [], None
    for j in range(kappa):
        idx = torch.as_tensor(perm[j * bs : (j + 1) * bs], device=x.device)
        xb, yb = x[idx], y[idx]
        leaves = {k: v.clone().requires_grad_(True) for k, v in p.items()}
        loss = model.loss(leaves, xb, yb)
        g = torch.autograd.grad(loss, list(leaves.values()))
        losses.append(float(loss.detach()))
        my_grads.append({k: gi.detach() for k, gi in zip(leaves, g)})
        if fused:
            p = {k: torch.add(v, grads[j][k].to(v.device, v.dtype), alpha=-lr) for k, v in p.items()}
        else:
            p = {k: v - lr * grads[j][k].to(v.device, v.dtype) for k, v in p.items()}  # the program's update
        if with_feature:
            with torch.no_grad():
                f = model.feature(p, xb).double() * bs
            fsum = f if fsum is None else fsum + f
    return {"loss": losses, "grads": my_grads, "h": (fsum / (kappa * bs)).float() if with_feature else None,
            "final": p}


def forced_epoch(model, inp: Dict[str, Any], lanes: Dict[int, list], rows: Dict[str, Dict[int, Params]],
                 draws: Dict[str, np.ndarray], data: Dict[str, torch.Tensor], cfg: Dict[str, Any],
                 fused: bool = False) -> Dict[str, Any]:
    """The reference's epoch from the program's state ``inp`` (global model,
    moments h, ages, batteries, pending flags), the program's per-step
    gradients of the sampled clients ``lanes`` and the messages it holds
    (``rows["old"]``: before the epoch, of clients holding an unsent one;
    ``rows["new"]``: after it, of clients that trained)."""
    n = len(inp["age"])
    vaoi = cfg["policy"] == "vaoi"
    selected = select(cfg["policy"], inp["age"], draws["noise"], cfg["k"])
    if vaoi:
        with torch.no_grad():
            v = model.probe(inp["global"], data["images"][:, : cfg["probe_size"]])
        m = torch.linalg.vector_norm(v.double() - inp["h"].to(v.device).double(), dim=-1).cpu().numpy()
        age = (np.where(m >= cfg["mu"], inp["age"] + 1, inp["age"]) * (1 - selected)).astype(np.float32)
    else:
        m, age = np.zeros(n), np.asarray(inp["age"]).copy()
    scan = slot_scan(inp["battery"], inp["pending"], selected, draws["harvest"], cfg["slots_per_epoch"],
                     cfg["kappa"], cfg["e_max"])
    trained = {c: forced_sgd(model, inp["global"], data["images"][c], data["labels"][c], draws["perms"][c],
                             cfg["kappa"], cfg["lr"], grads, vaoi, fused)
               for c, grads in lanes.items()}
    delivered = np.flatnonzero(scan["uploaded"])  # the ideal channel delivers every upload
    contrib = [rows["old"].get(int(c)) if inp["pending"][c] else rows["new"].get(int(c)) for c in delivered]
    if any(r is None for r in contrib):
        new_global = None  # a message the program does not hold: the states already differ
    elif contrib:
        new_global = {k: torch.stack([r[k].double() for r in contrib]).mean(dim=0).float() for k in inp["global"]}
    else:
        new_global = {k: v.float() for k, v in inp["global"].items()}
    return {
        "selected": selected, "age": age, "battery": scan["battery"], "pending": scan["pending"],
        "started": set(np.flatnonzero(scan["started"]).tolist()), "n_started": int(scan["started"].sum()),
        "n_uploaded": int(scan["uploaded"].sum()), "n_delivered": int(len(delivered)),
        "energy": int(scan["energy"].sum()), "avg_m": float(m.sum() / n), "lanes": trained, "global": new_global,
    }
