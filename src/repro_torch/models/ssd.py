"""Mamba2 block via SSD (state-space duality, arXiv:2405.21060).

The port of ``repro.models.ssd``.  The sequence is processed in chunks:
intra-chunk work is dense products, and the inter-chunk state carry (a
``lax.associative_scan`` in the reference) is a loop over chunks.
``ssd_forward(use_kernel=True)`` sends the scan to ``kernels.ops.ssd_scan``
(the Hopper kernel on CUDA tensors).  Decode is the O(1) recurrent update.
Weights keep the reference's layout: dense weights (in, out), ``x @ W``.

On DTensors (the launch layer's sharded steps) the block takes a path of
its own, :func:`_ssd_forward_sharded` / :func:`_ssd_decode_sharded`: the
in_proj's output mixes five segments (z, x, B, C, dt) whose boundaries do
not fall on the ``model`` shards of its columns, so the weight is split
into its segments first; z, x and dt (and the scan) shard by SSM heads
over ``model``, B and C stay whole on every model rank, and the gated
norm's mean over the heads is reduced across them.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models import spmd
from repro_torch.models.common import Params, dense_init


def init_ssd(generator: torch.Generator, cfg: ModelConfig, dtype: torch.dtype) -> Params:
    """One block's weights, drawn from ``generator`` on its device."""
    d, di, ds, nh = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    conv_ch = di + 2 * ds
    dev = generator.device
    conv_w = torch.randn(cfg.ssm_conv_width, conv_ch, generator=generator, device=dev, dtype=torch.float32)
    # in_proj emits [z (di), x (di), B (ds), C (ds), dt (nh)]
    return {
        "in_proj": dense_init(generator, d, 2 * di + 2 * ds + nh, dtype),
        "conv_w": (conv_w * 0.2).to(dtype),
        "conv_b": torch.zeros(conv_ch, dtype=dtype, device=dev),
        "A_log": torch.log(torch.linspace(1.0, 16.0, nh, dtype=torch.float32, device=dev)),
        "dt_bias": torch.zeros(nh, dtype=torch.float32, device=dev),
        "D": torch.ones(nh, dtype=torch.float32, device=dev),
        "norm_scale": torch.ones(di, dtype=dtype, device=dev),
        "out_proj": dense_init(generator, di, d, dtype),
    }


def _split_proj(cfg: ModelConfig, zxbcdt: torch.Tensor):
    di, ds = cfg.d_inner, cfg.ssm_state
    return zxbcdt[..., :di], zxbcdt[..., di : 2 * di + 2 * ds], zxbcdt[..., 2 * di + 2 * ds :]


def _gated_norm(p: Params, y: torch.Tensor, z: torch.Tensor, eps: float) -> torch.Tensor:
    y = y * F.silu(z.float()).to(y.dtype)
    yf = y.float()
    var = torch.mean(yf * yf, dim=-1, keepdim=True)
    return (yf * torch.rsqrt(var + eps) * p["norm_scale"].float()).to(y.dtype)


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """a: (..., L).  S[..., i, j] = sum_{j<m<=i} a[..., m] on and below the
    diagonal, -inf above it."""
    L = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones(L, L, dtype=torch.bool, device=a.device))
    return diff.masked_fill(~mask, float("-inf"))


def ssd_chunked(
    x: torch.Tensor,  # (B, S, nh, hp)
    dt: torch.Tensor,  # (B, S, nh) post-softplus
    A: torch.Tensor,  # (nh,) negative
    Bm: torch.Tensor,  # (B, S, ds)
    Cm: torch.Tensor,  # (B, S, ds)
    chunk: int,
    init_state: Optional[torch.Tensor] = None,  # (B, nh, hp, ds)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain chunked SSD.  Returns (y (B,S,nh,hp), final_state (B,nh,hp,ds)), fp32."""
    B_, S, nh, hp = x.shape
    ds = Bm.shape[-1]
    pad = (-S) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
    Sp = S + pad
    nc, L = Sp // chunk, chunk

    xd = (x * dt[..., None]).float()  # (B,Sp,nh,hp)
    a = (dt * A[None, None, :]).float()  # (B,Sp,nh) negative increments

    xc = xd.reshape(B_, nc, L, nh, hp)
    ac = a.reshape(B_, nc, L, nh).permute(0, 3, 1, 2)  # (B,nh,nc,L)
    Bc = Bm.reshape(B_, nc, L, ds).float()
    Cc = Cm.reshape(B_, nc, L, ds).float()
    a_cum = torch.cumsum(ac, dim=-1)  # (B,nh,nc,L)

    # 1) intra-chunk (diagonal blocks): quadratic within the chunk
    Lmat = torch.exp(_segsum(ac))  # (B,nh,nc,L,L)
    y_diag = torch.einsum("bcln,bcsn,bhcls,bcshp->bclhp", Cc, Bc, Lmat, xc)

    # 2) chunk summaries: each chunk's contribution to the state at its end
    decay_states = torch.exp(a_cum[..., -1:] - a_cum)  # (B,nh,nc,L)
    states = torch.einsum("bcln,bhcl,bclhp->bchpn", Bc, decay_states, xc)  # (B,nc,nh,hp,ds)

    # 3) inter-chunk recurrence S_c = S_{c-1}·exp(sum a_c) + states_c, as a loop
    dec = torch.exp(a_cum[..., -1]).permute(0, 2, 1)  # (B,nc,nh)
    if init_state is None:
        state = torch.zeros(B_, nh, hp, ds, dtype=torch.float32, device=x.device)
    else:
        state = init_state.float()
    prev = []
    for c in range(nc):
        prev.append(state)  # the state entering chunk c
        state = state * dec[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)  # (B,nc,nh,hp,ds)

    y_off = torch.einsum("bcln,bchpn,bhcl->bclhp", Cc, prev_states, torch.exp(a_cum))
    y = (y_diag + y_off).reshape(B_, Sp, nh, hp)[:, :S]
    return y, state


def ssd_forward(cfg: ModelConfig, p: Params, x: torch.Tensor, use_kernel: bool = False) -> torch.Tensor:
    """Full-sequence mamba2 block. x: (B, S, d) -> (B, S, d).

    ``use_kernel=True`` routes the scan through ``kernels.ops.ssd_scan`` (the
    Hopper kernel on CUDA tensors, the exact recurrence on CPU ones) instead
    of the plain chunked form.  x, B and C go to the kernel as strided views
    of the conv output, uncopied."""
    if spmd.is_dtensor(x):
        return _ssd_forward_sharded(cfg, p, x)
    B, S, d = x.shape
    di, ds, nh, hp = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    with record_function("lm.in_proj"):
        zxbcdt = x @ p["in_proj"]
    z, xBC, dt = _split_proj(cfg, zxbcdt)
    with record_function("lm.conv"):  # causal depthwise conv, width w
        w = cfg.ssm_conv_width
        xBC_pad = F.pad(xBC, (0, 0, w - 1, 0))
        conv = sum(xBC_pad[:, i : i + S, :] * p["conv_w"][i][None, None, :] for i in range(w))
        xBC = F.silu(conv + p["conv_b"])
        xs = xBC[..., :di].reshape(B, S, nh, hp)
        Bm, Cm = xBC[..., di : di + ds], xBC[..., di + ds :]
        dt = F.softplus(dt.float() + p["dt_bias"])  # (B,S,nh)
        A = -torch.exp(p["A_log"])  # (nh,)
    with record_function("lm.scan"):
        if use_kernel:
            y, _ = kops.ssd_scan(xs, dt, A, Bm, Cm, chunk=cfg.ssm_chunk)
        else:
            y, _ = ssd_chunked(xs, dt, A, Bm, Cm, cfg.ssm_chunk)
    with record_function("lm.out_proj"):
        y = y + xs.float() * p["D"][None, None, :, None]
        y = y.reshape(B, S, di).to(x.dtype)
        y = _gated_norm(p, y, z, cfg.norm_eps)
        return y @ p["out_proj"]


# ---------------------------------------------------------------------------
# Decode (recurrent O(1) step)
# ---------------------------------------------------------------------------


def init_ssd_cache(cfg: ModelConfig, batch: int, dtype: torch.dtype, device: torch.device) -> Dict[str, torch.Tensor]:
    di, ds = cfg.d_inner, cfg.ssm_state
    return {
        "conv": torch.zeros(batch, cfg.ssm_conv_width - 1, di + 2 * ds, dtype=dtype, device=device),
        "ssm": torch.zeros(batch, cfg.ssm_heads, cfg.ssm_head_dim, ds, dtype=torch.float32, device=device),
    }


def ssd_decode(
    cfg: ModelConfig, p: Params, x: torch.Tensor, cache: Dict[str, torch.Tensor]
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B, 1, d) -> (y (B,1,d), new cache)."""
    if spmd.is_dtensor(x):
        return _ssd_decode_sharded(cfg, p, x, cache)
    B = x.shape[0]
    di, ds, nh, hp = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    zxbcdt = x[:, 0] @ p["in_proj"]
    z, xBC, dt = _split_proj(cfg, zxbcdt)
    hist = torch.cat([cache["conv"], xBC[:, None, :]], dim=1)  # (B, w, ch)
    conv = torch.einsum("bwc,wc->bc", hist, p["conv_w"]) + p["conv_b"]
    xBC_t = F.silu(conv)
    xt = xBC_t[:, :di].reshape(B, nh, hp)
    Bt, Ct = xBC_t[:, di : di + ds], xBC_t[:, di + ds :]
    dt_t = F.softplus(dt.float() + p["dt_bias"])  # (B,nh)
    A = -torch.exp(p["A_log"])
    decay = torch.exp(dt_t * A[None, :])  # (B,nh)
    upd = torch.einsum("bh,bhp,bn->bhpn", dt_t, xt.float(), Bt.float())
    h_new = cache["ssm"] * decay[..., None, None] + upd
    y = torch.einsum("bhpn,bn->bhp", h_new, Ct.float())
    y = y + xt.float() * p["D"][None, :, None]
    y = y.reshape(B, di).to(x.dtype)
    y = _gated_norm(p, y, z, cfg.norm_eps)
    out = (y @ p["out_proj"])[:, None, :]
    return out, {"conv": hist[:, 1:], "ssm": h_new}


# ---------------------------------------------------------------------------
# The sharded path (DTensor inputs)
# ---------------------------------------------------------------------------


def _heads_axis(cfg: ModelConfig, mesh):
    return "model" if cfg.ssm_heads % spmd.model_size(mesh) == 0 else None


def _segments(cfg: ModelConfig, p: Params, x: torch.Tensor):
    """x (..., d) through the in_proj's five segments: (z, x, B, C, dt), the
    heads' segments (z, x, dt) over ``model``, B and C whole; and the conv
    weights and biases of x, B and C, laid out the same way."""
    mesh = x.device_mesh
    di, ds = cfg.d_inner, cfg.ssm_state
    heads = _heads_axis(cfg, mesh)
    whole = spmd.placements(mesh, (None, None))
    w = p["in_proj"].redistribute(mesh, whole)
    cw = p["conv_w"].redistribute(mesh, whole)
    cb = p["conv_b"].redistribute(mesh, spmd.placements(mesh, (None,)))
    by_heads = spmd.placements(mesh, (None, heads))
    cuts = ((0, di), (di, 2 * di), (2 * di, 2 * di + ds), (2 * di + ds, 2 * di + 2 * ds), (2 * di + 2 * ds, w.shape[1]))
    wz, wx, wB, wC, wdt = (w[:, a:b] for a, b in cuts)
    wz, wx, wdt = (t.redistribute(mesh, by_heads) for t in (wz, wx, wdt))
    proj = [x @ t for t in (wz, wx, wB, wC, wdt)]
    conv = [
        (cw[:, :di].redistribute(mesh, by_heads), cb[:di].redistribute(mesh, spmd.placements(mesh, (heads,)))),
        (cw[:, di : di + ds], cb[di : di + ds]),
        (cw[:, di + ds :], cb[di + ds :]),
    ]
    return proj, conv


def _sharded_gated_norm(p: Params, y: torch.Tensor, z: torch.Tensor, eps: float) -> torch.Tensor:
    """``_gated_norm`` with the heads over ``model``: its mean over d_inner
    reduced across the shards explicitly."""
    y = y * F.silu(z.float()).to(y.dtype)
    yf = y.float()
    var = spmd.to_batch_layout(torch.sum(yf * yf, dim=-1, keepdim=True)) / yf.shape[-1]
    return (yf * torch.rsqrt(var + eps) * p["norm_scale"].float()).to(y.dtype)


def _conv_silu(seq: torch.Tensor, w: torch.Tensor, b: torch.Tensor, S: int) -> torch.Tensor:
    """The causal depthwise conv over (B, S + w - 1, ch) padded input."""
    return F.silu(sum(seq[:, i : i + S, :] * w[i][None, None, :] for i in range(w.shape[0])) + b)


def _ssd_forward_sharded(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    (z, xin, Bin, Cin, dt), conv = _segments(cfg, p, x)
    heads = _heads_axis(cfg, x.device_mesh)
    hp, wdt = cfg.ssm_head_dim, cfg.ssm_conv_width
    dtype = x.dtype

    def core(xin, Bin, Cin, dt, cwx, cbx, cwB, cbB, cwC, cbC, dt_bias, A_log, D):
        B, S = xin.shape[:2]
        xs, Bm, Cm = (
            _conv_silu(F.pad(t, (0, 0, wdt - 1, 0)), cw, cb, S)
            for t, cw, cb in ((xin, cwx, cbx), (Bin, cwB, cbB), (Cin, cwC, cbC))
        )
        xs = xs.reshape(B, S, -1, hp)
        dt = F.softplus(dt.float() + dt_bias)
        y, _ = ssd_chunked(xs, dt, -torch.exp(A_log), Bm, Cm, cfg.ssm_chunk)
        y = y + xs.float() * D[None, None, :, None]
        return y.reshape(B, S, -1).to(dtype)

    act_h, act_w = (spmd.BATCH, None, heads), (spmd.BATCH, None, None)
    w_h, w_w, v_h, v_w = (None, heads), (None, None), (heads,), (None,)
    (cwx, cbx), (cwB, cbB), (cwC, cbC) = conv
    with record_function("lm.scan"):
        y = spmd.local(
            core, act_h,
            [act_h, act_w, act_w, act_h, w_h, v_h, w_w, v_w, w_w, v_w, v_h, v_h, v_h],
            xin, Bin, Cin, dt, cwx, cbx, cwB, cbB, cwC, cbC, p["dt_bias"], p["A_log"], p["D"],
            grad_sums=[None, "model", "model", None, "batch", "batch", "batch+model", "batch+model", "batch+model",
                       "batch+model", "batch", "batch", "batch"],
        )
    with record_function("lm.out_proj"):
        return _sharded_gated_norm(p, y, z, cfg.norm_eps) @ p["out_proj"]


def _ssd_decode_sharded(cfg: ModelConfig, p: Params, x: torch.Tensor, cache: Dict[str, torch.Tensor]):
    mesh = x.device_mesh
    di, ds, hp = cfg.d_inner, cfg.ssm_state, cfg.ssm_head_dim
    heads = _heads_axis(cfg, mesh)
    (z, xin, Bin, Cin, dt), conv = _segments(cfg, p, x[:, 0])
    hist = cache["conv"].redistribute(mesh, spmd.placements(mesh, (spmd.BATCH, None, None), x.shape[0]))
    hx, hB, hC = hist[..., :di], hist[..., di : di + ds], hist[..., di + ds :]
    dtype = x.dtype

    def core(xin, Bin, Cin, dt, hx, hB, hC, cwx, cbx, cwB, cbB, cwC, cbC, state, dt_bias, A_log, D):
        B = xin.shape[0]
        hists = [torch.cat([h, t[:, None, :]], dim=1) for h, t in ((hx, xin), (hB, Bin), (hC, Cin))]
        xt, Bt, Ct = (
            F.silu(torch.einsum("bwc,wc->bc", h, cw) + cb) for h, cw, cb in zip(hists, (cwx, cwB, cwC), (cbx, cbB, cbC))
        )
        xt = xt.reshape(B, -1, hp)
        dt_t = F.softplus(dt.float() + dt_bias)
        decay = torch.exp(dt_t * -torch.exp(A_log)[None, :])
        upd = torch.einsum("bh,bhp,bn->bhpn", dt_t, xt.float(), Bt.float())
        h_new = state * decay[..., None, None] + upd
        y = torch.einsum("bhpn,bn->bhp", h_new, Ct.float()) + xt.float() * D[None, :, None]
        return y.reshape(B, -1).to(dtype), hists[0][:, 1:], hists[1][:, 1:], hists[2][:, 1:], h_new

    b_h, b_w = (spmd.BATCH, heads), (spmd.BATCH, None)
    c_h, c_w = (spmd.BATCH, None, heads), (spmd.BATCH, None, None)
    w_h, w_w, v_h, v_w = (None, heads), (None, None), (heads,), (None,)
    st = (spmd.BATCH, heads, None, None)
    (cwx, cbx), (cwB, cbB), (cwC, cbC) = conv
    y, nx, nB, nC, h_new = spmd.local(
        core, [b_h, c_h, c_w, c_w, st],
        [b_h, b_w, b_w, b_h, c_h, c_w, c_w, w_h, v_h, w_w, v_w, w_w, v_w, st, v_h, v_h, v_h],
        xin, Bin, Cin, dt, hx, hB, hC, cwx, cbx, cwB, cbB, cwC, cbC, cache["ssm"], p["dt_bias"], p["A_log"], p["D"],
    )
    out = (_sharded_gated_norm(p, y, z, cfg.norm_eps) @ p["out_proj"])[:, None, :]
    new_conv = torch.cat([spmd.replicate(t) for t in (nx, nB, nC)], dim=-1)
    return out, {
        "conv": new_conv.redistribute(mesh, cache["conv"].placements),
        "ssm": h_new.redistribute(mesh, cache["ssm"].placements),
    }
