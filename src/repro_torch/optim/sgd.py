"""Optimizers on dicts of tensors: plain SGD (the paper, γ=0.01) and AdamW
(at-scale training), the port of ``repro.optim.sgd``."""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

Tree = Dict[str, Any]  # a dict of tensors, or of nested dicts and lists of them


def _map(fn, tree: Any, *rest: Any) -> Any:
    """``fn`` over the tensors of ``tree`` (and the same places of ``rest``)."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    return fn(tree, *rest)


def _leaves(tree: Any):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def sgd_update(params: Tree, grads: Tree, lr: float) -> Tree:
    return _map(lambda p, g: p - lr * g.to(p.dtype), params, grads)


def adamw_init(params: Tree) -> Dict[str, Any]:
    """m and v zeros in fp32 in the params' structure, step 0 (int32)."""
    zeros = lambda: _map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)
    device = next(iter(_leaves(params))).device
    return {"m": zeros(), "v": zeros(), "step": torch.zeros((), dtype=torch.int32, device=device)}


def adamw_update(
    params: Tree,
    grads: Tree,
    state: Dict[str, Any],
    lr: float,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
) -> Tuple[Tree, Dict[str, Any]]:
    """The reference's AdamW term for term: m and v in fp32, the bias
    corrections from the int32 step, the update (with decoupled weight decay
    on the fp32 param) in fp32, rounded to the param's dtype once."""
    step = state["step"] + 1
    t = step.float()
    m = _map(lambda m_, g: b1 * m_ + (1 - b1) * g.float(), state["m"], grads)
    v = _map(lambda v_, g: b2 * v_ + (1 - b2) * torch.square(g.float()), state["v"], grads)
    bc1, bc2 = 1 - b1**t, 1 - b2**t

    def upd(p: torch.Tensor, m_: torch.Tensor, v_: torch.Tensor) -> torch.Tensor:
        u = (m_ / bc1) / (torch.sqrt(v_ / bc2) + eps) + weight_decay * p.float()
        return (p.float() - lr * u).to(p.dtype)

    return _map(upd, params, m, v), {"m": m, "v": v, "step": step}
