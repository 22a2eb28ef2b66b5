"""Mixture-of-Experts FFN: the port of ``repro.models.moe``.

Shared + routed experts with capacity-dropped top-k routing.  Experts are
stacked on a leading E axis; the router is kept in fp32 whatever the model
dtype.  The reference dispatches and combines with one-hot einsums over
(token, expert, slot); here the same function is a fixed-shape write of
every choice into a slot buffer and a gather back, so its shapes never
depend on the routing (``torch.func.vmap`` batches it over clients, and no
step waits on the host):

- dispatch: the (E B ng C + 1, d) buffer holds the experts' slots,
  expert-major, and one spare row.  Each choice (b, g, t, j) is written
  (``index_put``, no accumulation) to its slot's row when it kept a slot
  and to the spare row when it was dropped; a real slot gets at most one
  token, so the buffer is exactly the one-hot sum, and the spare row,
  whichever write lands there, is discarded.  The first E B ng C rows are
  the experts' (E, B ng C, d) input as they lie;
- combine: each token reads its k experts' outputs (a dropped choice its
  expert's slot 0, under gate 0), times its gate rounded to the model
  dtype, adds them in fp32 and rounds once (what XLA's bf16 einsum does;
  adding k bf16 terms in bf16 would be another function).

The expert products are batched matmuls (``torch.bmm``), outside any
kernel, as in the reference.

DeepSeek-V2's expert layer (``cfg.experts_held`` > 0) is another
function: the router scores all ``num_experts`` (softmax in fp32, top-k,
the gates as they are, not renormalised), and this chip holds experts
``[expert_offset, expert_offset + experts_held)`` of them, as when each
layer's experts are divided over chips; it computes its own experts' part
of the result and adds the shared experts' (every chip computes those
alike), and the absent experts' part is left out.  Dropless with fixed
shapes: every held expert computes every token, and each token takes its
experts' outputs under its gates, 0 for an expert it did not choose
(:func:`_share`).  The balance term is DeepSeek's, per sequence.

``COUNTS`` sums, from shapes alone (no synchronisation), the expert-MLP
rows each call computed (``rows``) and the tokens that entered an expert
layer (``tokens``); under ``vmap`` a call sees, and counts, one lane.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from repro_torch.configs.base import ModelConfig
from repro_torch.models import spmd
from repro_torch.models.common import Params, apply_mlp, dense_init, init_mlp

GROUP_SIZE = 512
COUNTS = {"rows": 0, "tokens": 0}


def reset_counts() -> None:
    COUNTS.update(rows=0, tokens=0)


def _count(rows: int, tokens: int) -> None:
    COUNTS["rows"] += int(rows)
    COUNTS["tokens"] += int(tokens)


def init_moe(generator: torch.Generator, cfg: ModelConfig, dtype: torch.dtype) -> Params:
    """One layer's experts, drawn from ``generator`` on its device: each
    (E, d, ff) stack drawn whole in fp32, then cast."""
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.experts_here
    dev = generator.device

    def stack(rows: int, cols: int) -> torch.Tensor:
        w = torch.randn(E, rows, cols, generator=generator, device=dev, dtype=torch.float32)
        return (w * (1.0 / math.sqrt(rows))).to(dtype)

    p: Params = {
        "router": dense_init(generator, d, cfg.num_experts, torch.float32),  # router kept fp32, over all experts
        "w_gate": stack(d, ff),
        "w_up": stack(d, ff),
        "w_down": stack(ff, d),
    }
    if cfg.num_shared_experts > 0:
        p["shared"] = init_mlp(generator, d, ff * cfg.num_shared_experts, "silu", dtype)
    return p


class Routing(NamedTuple):
    """Routing of x (B, S, d) in ``ng`` groups of ``G`` tokens, ``C`` slots
    per expert and group.  Per token and choice j < k: ``top_idx`` (B, ng,
    G, k) the expert, ``top_vals`` its renormalised probability (fp32),
    ``slot`` its slot in the expert (0 where dropped) and ``keep`` whether
    it got one; and the aux loss (fp32)."""

    G: int
    ng: int
    C: int
    top_idx: torch.Tensor
    top_vals: torch.Tensor
    slot: torch.Tensor
    keep: torch.Tensor
    aux: torch.Tensor


def group_shape(cfg: ModelConfig, S: int) -> Tuple[int, int, int]:
    """(G, ng, C): groups of GROUP_SIZE along the sequence (one group when
    S is not a multiple), and capacity min(G, ceil(k G / E * cf))."""
    G = min(GROUP_SIZE, S)
    if S % G:
        G = S
    C = max(1, int(math.ceil(cfg.experts_per_token * G / cfg.num_experts * cfg.capacity_factor)))
    return G, S // G, min(C, G)


def route(cfg: ModelConfig, p: Params, x: torch.Tensor) -> Routing:
    """The reference's routing: fp32 router logits and softmax, top-k of the
    probabilities (the lower index first on a tie, as ``lax.top_k``: a
    stable descending sort), renormalised; capacity taken in token order by
    the running count of each expert within its group."""
    B, S, d = x.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    G, ng, C = group_shape(cfg, S)
    logits = x.reshape(B, ng, G, d).float() @ p["router"]  # (B, ng, G, E)
    probs = torch.softmax(logits, dim=-1)
    sorted_vals, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_vals, top_idx = sorted_vals[..., :k], order[..., :k]
    top_vals = top_vals / top_vals.sum(dim=-1, keepdim=True)
    mask = torch.zeros_like(probs).scatter(-1, top_idx, 1.0)  # (B, ng, G, E) in {0, 1}
    # Switch-style load-balance loss
    aux = torch.mean(mask.mean(dim=2) * probs.mean(dim=2)) * (E * E) / k
    pos_in_exp = torch.cumsum(mask, dim=2) * mask - 1.0
    pos = torch.gather(pos_in_exp, -1, top_idx)  # (B, ng, G, k)
    keep = (pos >= 0) & (pos < C)
    slot = torch.where(keep, pos, 0.0).long()
    return Routing(G, ng, C, top_idx, top_vals, slot, keep, aux)


def _experts(p: Params, xe: torch.Tensor) -> torch.Tensor:
    """Gated-silu expert MLPs: xe (E, N, d) -> (E, N, d)."""
    h = F.silu(torch.bmm(xe, p["w_gate"])) * torch.bmm(xe, p["w_up"])
    return torch.bmm(h, p["w_down"])


def _dispatch(cfg: ModelConfig, x: torch.Tensor, router: torch.Tensor):
    """Route x (B, S, d) and write every choice to its slot: the experts'
    input (E, B ng C, d), and for the combine each choice's row in it
    (B, ng, G, k) and its gate (fp32, 0 where dropped); and the aux loss."""
    B, S, d = x.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    r = route(cfg, {"router": router}, x)
    G, ng, C = r.G, r.ng, r.C
    M = E * B * ng * C  # expert slots, expert-major: row ((e * B + b) * ng + g) * C + slot
    b_all = torch.arange(B, device=x.device)[:, None, None, None]
    g_all = torch.arange(ng, device=x.device)[None, :, None, None]
    rows = ((r.top_idx * B + b_all) * ng + g_all) * C + r.slot  # (B, ng, G, k)
    # dispatch: every choice is written to its slot's row, a dropped one to
    # the spare row M, whose contents are discarded
    xk = x.reshape(B, ng, G, 1, d).expand(B, ng, G, k, d).reshape(B * ng * G * k, d)
    slots = torch.index_put(x.new_zeros(M + 1, d), (torch.where(r.keep, rows, M).reshape(-1),), xk)
    gates = torch.where(r.keep, r.top_vals, 0.0).to(x.dtype).float()
    return slots[:M].view(E, B * ng * C, d), rows, gates, r.aux


def _combine(ye: torch.Tensor, rows: torch.Tensor, gates: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Each token's k expert outputs (a dropped choice reads its expert's
    slot 0 under gate 0) times its gates in the model dtype, added in fp32,
    rounded once: ye (E, B ng C, d) -> (B, S, d)."""
    B, ng, G, k = rows.shape
    d = ye.shape[-1]
    picked = ye.reshape(-1, d).index_select(0, rows.reshape(-1)).view(B, ng, G, k, d)
    return torch.einsum("bgtkd,bgtk->bgtd", picked.float(), gates).to(dtype).reshape(B, ng * G, d)


def _share_gates(cfg: ModelConfig, router: torch.Tensor, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """DeepSeek-V2's routing of x (B, S, d) over all ``num_experts``: the
    gates of the experts held here (B, S, held) in fp32, 0 where a token
    did not choose the expert, and the balance term (fp32)."""
    S = x.shape[1]
    E, k = cfg.num_experts, cfg.experts_per_token
    probs = torch.softmax(x.float() @ router, dim=-1)  # (B, S, E)
    top_vals, top_idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_vals, top_idx = top_vals[..., :k], top_idx[..., :k]
    choice = torch.zeros_like(probs).scatter(-1, top_idx, 1.0)  # (B, S, E) in {0, 1}
    gates = torch.zeros_like(probs).scatter(-1, top_idx, top_vals)
    # per sequence: sum_e (choices of e / (S k / E)) * mean_s p_e, averaged over sequences
    aux = ((choice.sum(dim=1) * (E / (S * k))) * probs.mean(dim=1)).sum(dim=-1).mean()
    lo = cfg.expert_offset
    return gates[..., lo : lo + cfg.experts_here], aux


def _share(cfg: ModelConfig, p: Params, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The held experts' part of the layer: every held expert over every
    token, each output times the token's gate for it (rounded to the model
    dtype), summed in fp32 by the down projection, rounded once."""
    with record_function("lm.moe.route"):
        gates, aux = _share_gates(cfg, p["router"], x)
    with record_function("lm.moe.experts"):
        B, S, _ = x.shape
        held = gates.shape[-1]
        h = F.silu(torch.einsum("bsd,edf->bsef", x, p["w_gate"])) * torch.einsum("bsd,edf->bsef", x, p["w_up"])
        y = torch.einsum("bsef,efd->bsd", h * gates.to(x.dtype)[..., None], p["w_down"])
        _count(held * B * S, B * S)
    return y, aux


def apply_moe(cfg: ModelConfig, p: Params, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (y, aux loss fp32).  Tokens past an expert's
    capacity in their group are dropped from that expert; DeepSeek-V2's
    expert layer (an expert share, ``cfg.experts_held``) is :func:`_share`.

    On DTensors each batch shard routes and dispatches its own tokens
    (routing is per sequence group, so this is the same function), the
    expert products shard the experts over ``model`` (the slots' batch
    stays over the data axes), and each shard combines its own tokens from
    every expert's outputs; the aux loss is the mean of the shards'.
    Spans: ``lm.moe.route`` (here the routing and the slot writes),
    ``lm.moe.experts`` (the products and the combine), ``lm.moe.shared``."""
    if cfg.experts_held:
        y, aux = _share(cfg, p, x)
    else:
        B = x.shape[0]
        tok = (spmd.BATCH, None, None, None)
        with record_function("lm.moe.route"):
            slots, rows, gates, aux = spmd.local(
                lambda x_, r_: _dispatch(cfg, x_, r_),
                [(None, spmd.BATCH, None), tok, tok, spmd.PARTIAL_AVG],
                [(spmd.BATCH, None, None), (None, None)],
                x, p["router"], grad_sums=[None, "batch"],
            )
        with record_function("lm.moe.experts"):
            ye = _experts(p, slots)
            y = spmd.local(
                lambda ye_, rows_, gates_: _combine(ye_, rows_, gates_, x.dtype),
                (spmd.BATCH, None, None), [(None, spmd.BATCH, None), tok, tok],
                ye, rows, gates, batch=B,
            )
            _count(slots.shape[0] * slots.shape[1], x.shape[0] * x.shape[1])
    if cfg.num_shared_experts > 0:
        with record_function("lm.moe.shared"):
            y = y + apply_mlp(p["shared"], x, "silu")
    return y, aux
