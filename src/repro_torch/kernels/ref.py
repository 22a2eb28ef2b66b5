"""Plain PyTorch versions of the kernels: the CPU path, and the ground
truth each Hopper kernel is held against on the card."""
from __future__ import annotations

import functools
import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

# swa_attention_ref's rows per pass: bounds its (B, H, chunk, S) scores
REF_Q_CHUNK = 1024


def vaoi_distance_ref(
    v: torch.Tensor, h: torch.Tensor, age: torch.Tensor, q: torch.Tensor, mu: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused Eq. (5) + Eq. (7): distances M_i and updated ages.

    v, h: (N, F) float; age: (N,) float32; q: (N,) float32 in {0,1}.
    Returns (m (N,), new_age (N,)), both fp32.
    """
    diff = v.float() - h.float()
    m = torch.sqrt(torch.sum(diff * diff, dim=-1))
    inc = torch.where(m >= mu, age + 1.0, age)
    return m, inc * (1.0 - q)


def fedavg_reduce_ref(msgs: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Weighted aggregation: msgs (K, P), weights (K,) -> (P,) in fp32."""
    return torch.einsum("kp,k->p", msgs.float(), weights.float())


def fedavg_reduce_leaves_ref(groups: Sequence[Tuple[Sequence[torch.Tensor], torch.Tensor]]) -> torch.Tensor:
    """The leaf-table reduce: groups of (stacked (K_g, *shape_j) leaves,
    (K_g,) weights) -> (P,) fp32.  Per group, each leaf's weighted sum over
    its K_g rows fills the leaf's columns; then the groups are added in
    their order, as two reduces and an add."""
    total = None
    for leaves, w in groups:
        part = torch.empty(sum(math.prod(leaf.shape[1:]) for leaf in leaves), dtype=torch.float32,
                           device=w.device)
        off = 0
        for leaf in leaves:
            cols = math.prod(leaf.shape[1:])
            part[off : off + cols] = fedavg_reduce_ref(leaf.reshape(leaf.shape[0], cols), w)
            off += cols
        total = part if total is None else total + part
    return total


def swa_attention_ref(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window: int = 0, causal: bool = True
) -> torch.Tensor:
    """Sliding-window attention oracle.  q: (B, H, S, D); k, v: (B, Hkv, S, D)
    with Hkv dividing H; query head h reads KV head h // (H / Hkv), the
    grouping of the models' GQA.  window=0 => full.  Returns (B, H, S, D) in
    q's dtype.

    fp32 scores over √D, -inf outside the causal/window band, softmax, then
    PV.  Keys at or past S do not exist, so nothing is padded.  The rows go
    REF_Q_CHUNK at a time, which does not change the result."""
    B, H, S, D = q.shape
    g = H // k.shape[1]
    kf = k.float().repeat_interleave(g, dim=1)
    vf = v.float().repeat_interleave(g, dim=1)
    jk = torch.arange(S, device=q.device)[None, :]
    out = torch.empty(B, H, S, D, dtype=q.dtype, device=q.device)
    for i0 in range(0, S, REF_Q_CHUNK):
        qf = q[:, :, i0 : i0 + REF_Q_CHUNK].float()
        scores = torch.einsum("bhqd,bhkd->bhqk", qf, kf) / math.sqrt(D)
        iq = torch.arange(i0, i0 + qf.shape[2], device=q.device)[:, None]
        mask = torch.ones(qf.shape[2], S, dtype=torch.bool, device=q.device)
        if causal:
            mask &= jk <= iq
        if window > 0:
            mask &= jk > iq - window
        attn = torch.softmax(scores.masked_fill(~mask, float("-inf")), dim=-1)
        out[:, :, i0 : i0 + qf.shape[2]] = torch.einsum("bhqk,bhkd->bhqd", attn, vf).to(q.dtype)
    return out


@functools.cache
def _sqrt_in(hd: int, dtype: torch.dtype) -> float:
    """√hd in fp32, rounded to ``dtype``, as the reference's
    ``jnp.sqrt(hd).astype(q.dtype)`` (11.3125 in bf16 for hd = 128)."""
    return torch.tensor(math.sqrt(hd), dtype=torch.float32).to(dtype).item()


def gqa_scores(q: torch.Tensor, k: torch.Tensor, scale: Optional[float] = None) -> torch.Tensor:
    """q (B,Sq,nh,hd), k (B,Sk,nkv,hd) -> scores (B,nh,Sq,Sk) in q's dtype,
    with GQA grouping: query head h reads KV head h // (nh / nkv).  The
    products over √hd rounded to q's dtype, or times ``scale`` where given."""
    B, Sq, nh, hd = q.shape
    nkv = k.shape[2]
    g = nh // nkv
    qg = q.reshape(B, Sq, nkv, g, hd)
    s = torch.einsum("bqkgh,bskh->bkgqs", qg, k)
    s = s / _sqrt_in(hd, q.dtype) if scale is None else s * scale
    return s.reshape(B, nh, Sq, k.shape[1])


def gqa_out(attn: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """attn (B,nh,Sq,Sk), v (B,Sk,nkv,hd) -> (B,Sq,nh*hd)."""
    B, nh, Sq, Sk = attn.shape
    nkv, hd = v.shape[2], v.shape[3]
    g = nh // nkv
    a = attn.reshape(B, nkv, g, Sq, Sk)
    o = torch.einsum("bkgqs,bskh->bqkgh", a, v)
    return o.reshape(B, Sq, nh * hd)


# q-chunked attention above this sequence length: the (S, S) score matrix is
# never materialised; each chunk holds only (B, nh, Q_CHUNK, S).
CHUNK_THRESHOLD = 1024
Q_CHUNK = 512


def masked_softmax_attn(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, q_offset: int, causal: bool, window: int,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """The models' plain attention core.  q, k: (B,Cq / Sk,nh / nkv,hd); v:
    (B,Sk,nkv,hv).  Rows are absolute position q_offset + arange(Cq);
    ``scale`` as :func:`gqa_scores`.  The scores in q's dtype, then fp32,
    masked, softmax, rounded to q's dtype, times v.  Returns (B, Cq, nh*hv)."""
    scores = gqa_scores(q, k, scale).float()
    Cq, Sk = scores.shape[-2], scores.shape[-1]
    if causal:
        iq = q_offset + torch.arange(Cq, device=q.device)[:, None]
        jk = torch.arange(Sk, device=q.device)[None, :]
        mask = jk <= iq
        if window > 0:
            mask &= jk > iq - window
        scores = scores.masked_fill(~mask, -1e30)
    attn = torch.softmax(scores, dim=-1).to(q.dtype)
    return gqa_out(attn, v)


def masked_softmax_chunks(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool, window: int, scale: Optional[float] = None
) -> torch.Tensor:
    """:func:`masked_softmax_attn` over all of q's rows: over
    ``CHUNK_THRESHOLD`` tokens one ``Q_CHUNK`` of queries at a time, so the
    (S, S) scores are never materialised."""
    S = q.shape[1]
    if S > CHUNK_THRESHOLD and S % Q_CHUNK == 0:
        return torch.cat(
            [masked_softmax_attn(q[:, i : i + Q_CHUNK], k, v, i, causal, window, scale) for i in range(0, S, Q_CHUNK)],
            dim=1,
        )
    return masked_softmax_attn(q, k, v, 0, causal, window, scale)


def mla_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """Causal attention of multi-head latent attention's heads (DeepSeek-V2):
    q, k (B, S, H, Dqk), v (B, S, H, Dv), one key head a query head ->
    (B, S, H*Dv) in q's dtype, by :func:`masked_softmax_chunks`, the released
    ``modeling_deepseek.py``'s order.  The plain version of
    ``kernels/mla_attention.py``, and the CPU's path."""
    return masked_softmax_chunks(q, k, v, True, 0, scale)


def ssd_scan_ref(
    x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mamba2 SSD: the exact sequential recurrence, in fp32, from a zero state.

    x (B, S, nh, hp); dt (B, S, nh) post-softplus; A (nh,) negative;
    Bm, Cm (B, S, ds).  Per step t: S_t = S_{t-1}·exp(dt_t·A) + dt_t·x_tᵀB_t
    and y_t = S_t·C_t.  Returns (y (B, S, nh, hp), final state (B, nh, hp, ds)).
    """
    b, s, nh, hp = x.shape
    ds = Bm.shape[-1]
    xf, dtf, Af, Bf, Cf = x.float(), dt.float(), A.float(), Bm.float(), Cm.float()
    state = torch.zeros(b, nh, hp, ds, dtype=torch.float32, device=x.device)
    y = torch.empty(b, s, nh, hp, dtype=torch.float32, device=x.device)
    for t in range(s):
        decay = torch.exp(dtf[:, t] * Af[None, :])  # (B, nh)
        upd = torch.einsum("bh,bhp,bn->bhpn", dtf[:, t], xf[:, t], Bf[:, t])
        state = state * decay[..., None, None] + upd
        y[:, t] = torch.einsum("bhpn,bn->bhp", state, Cf[:, t])
    return y, state


# --- conv_lanes: a 3x3 convolution, stride 1, padding 1, per lane ---------
# One client's forward and its two gradients, each the call autograd makes
# for ``F.conv2d``; the ``conv_lanes*_ref`` forms map them over a leading lane
# dim with ``torch.vmap``, which runs them as the grouped convolution
# (groups = lanes) that vmap makes of a per-client model.

_CONV = ([1, 1], [1, 1], [1, 1], False, [0, 0], 1)  # stride, padding, dilation, transposed, output padding, groups


def conv3x3_ref(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None) -> torch.Tensor:
    """x (B, Cin, H, W), w (Cout, Cin, 3, 3), b (Cout,) or None -> (B, Cout, H, W)."""
    return F.conv2d(x, w, b, padding=1)


def conv3x3_input_grad_ref(g: torch.Tensor, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """dL/dx of :func:`conv3x3_ref` from g = dL/dy (x gives the shape)."""
    return torch.ops.aten.convolution_backward(g, x, w, [w.shape[0]], *_CONV, [True, False, False])[0]


def conv3x3_weight_grad_ref(g: torch.Tensor, x: torch.Tensor, w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dL/dw, dL/db) of :func:`conv3x3_ref` from g = dL/dy."""
    _, gw, gb = torch.ops.aten.convolution_backward(g, x, w, [w.shape[0]], *_CONV, [False, True, True])
    return gw, gb


def conv_lanes_ref(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None) -> torch.Tensor:
    """x (L, B, Cin, H, W), w (L, Cout, Cin, 3, 3), b (L, Cout) or None -> (L, B, Cout, H, W)."""
    return torch.vmap(conv3x3_ref, in_dims=(0, 0, None if b is None else 0))(x, w, b)


def conv_lanes_input_grad_ref(g: torch.Tensor, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """g (L, B, Cout, H, W), x (L, B, Cin, H, W), w (L, Cout, Cin, 3, 3) -> dL/dx (L, B, Cin, H, W)."""
    return torch.vmap(conv3x3_input_grad_ref)(g, x, w)


def conv_lanes_weight_grad_ref(g: torch.Tensor, x: torch.Tensor, w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The same -> (dL/dw (L, Cout, Cin, 3, 3), dL/db (L, Cout))."""
    return torch.vmap(conv3x3_weight_grad_ref)(g, x, w)
