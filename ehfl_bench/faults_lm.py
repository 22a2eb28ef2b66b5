"""Faults of the DeepSeek-V2 expert and attention layers, planted in the
port for the tests and the control runs of the ``lm`` cells: each must
turn ``correct`` false.  Each is a pair (None, on the epoch function), as
in ``faults.py``: during the epoch (the probe, local training and its
feature taps) one function of the port's model modules is replaced, and
put back after it.

- ``renormalised_gates``: the top-k gates renormalised to sum to 1, as
  DeepSeekMoE-16B does and DeepSeek-V2 (``norm_topk_prob`` false) does not;
- ``capacity_drop``: routed choices past capacity factor 1.25 in their
  group of tokens dropped, as the port's older expert layer counts them
  (``moe.group_shape``) and the released DeepSeek-V2 code (dropless) does
  not;
- ``no_yarn_mscale``: the attention's softmax scale without YaRN's
  mscale(40, 0.707)^2 = 1.5896, 1/sqrt(192) alone;
- ``no_kv_norm``: ``kv_a_layernorm`` skipped, the latent fed to ``kv_b``
  as it comes out of ``kv_a``.

Added to ``faults.FAULTS`` (:func:`register`), ``run.plant`` finds them
by name.
"""
from __future__ import annotations

import dataclasses
from contextlib import contextmanager
from typing import Callable, Dict, Tuple


@contextmanager
def _swapped(module, name: str, make):
    """``module.name`` replaced by ``make(original)`` inside the block."""
    original = getattr(module, name)
    setattr(module, name, make(original))
    try:
        yield
    finally:
        setattr(module, name, original)


def _during_epoch(module_name: str, name: str, make):
    def on_epoch(epoch_fn):
        import importlib

        module = importlib.import_module(module_name)

        def fn(carry, t, draws):
            with _swapped(module, name, make):
                return epoch_fn(carry, t, draws)

        return fn

    return on_epoch


def _gates(renormalise: bool, capacity: bool):
    """A gate function in ``moe._share_gates``' place: the same routing
    with the top-k gates renormalised, or with the choices past capacity
    factor 1.25 in their group of tokens dropped; the balance term the
    layer's own."""

    def make(original):
        import torch

        from repro_torch.models import moe

        def share_gates(cfg, router, x):
            B, S, _ = x.shape
            E, k = cfg.num_experts, cfg.experts_per_token
            probs = torch.softmax(x.float() @ router, dim=-1)
            top_vals, top_idx = torch.sort(probs, dim=-1, descending=True, stable=True)
            top_vals, top_idx = top_vals[..., :k], top_idx[..., :k]
            if renormalise:
                top_vals = top_vals / top_vals.sum(dim=-1, keepdim=True)
            if capacity:
                G, ng, C = moe.group_shape(dataclasses.replace(cfg, capacity_factor=1.25), S)
                chosen = torch.zeros_like(probs).scatter(-1, top_idx, 1.0).reshape(B, ng, G, E)
                pos = torch.gather((torch.cumsum(chosen, dim=2) * chosen - 1.0).reshape(B, S, E), -1, top_idx)
                top_vals = torch.where(pos < C, top_vals, 0.0)
            gates = torch.zeros_like(probs).scatter(-1, top_idx, top_vals)
            _, aux = original(cfg, router, x)
            lo = cfg.expert_offset
            return gates[..., lo : lo + cfg.experts_here], aux

        return share_gates

    return make


def _no_kv_norm(original):
    def apply_norm(kind, p, x, eps=1e-5):
        return x

    return apply_norm


def _no_mscale(original):
    def mla_softmax_scale(cfg):
        return (cfg.q_head_dim_nope + cfg.q_head_dim_rope) ** -0.5

    return mla_softmax_scale


MOE, ATTENTION = "repro_torch.models.moe", "repro_torch.models.attention"

FAULTS: Dict[str, Tuple[Callable | None, Callable | None]] = {
    "renormalised_gates": (None, _during_epoch(MOE, "_share_gates", _gates(renormalise=True, capacity=False))),
    "capacity_drop": (None, _during_epoch(MOE, "_share_gates", _gates(renormalise=False, capacity=True))),
    "no_yarn_mscale": (None, _during_epoch(ATTENTION, "mla_softmax_scale", _no_mscale)),
    # attention.py calls apply_norm only for kv_a_layernorm
    "no_kv_norm": (None, _during_epoch(ATTENTION, "apply_norm", _no_kv_norm)),
}


def register() -> None:
    """The model's faults under ``faults.FAULTS``, where ``run.plant`` looks."""
    from ehfl_bench import faults

    faults.FAULTS.update(FAULTS)
