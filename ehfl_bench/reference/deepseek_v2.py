"""DeepSeek-V2 (-Lite) in plain PyTorch and fp32, for the reference: the
released ``modeling_deepseek.py`` (hf:deepseek-ai/DeepSeek-V2-Lite;
arXiv:2405.04434), written out from its equations with no kernel, cache or
batching, on one chip's share of each layer.

Per layer: RMSNorm, multi-head latent attention, residual; RMSNorm, MLP or
expert layer, residual.  Then the final RMSNorm and the untied head.

- Attention (no q-LoRA): q = x W_q, per head ``qk_nope_head_dim`` +
  ``qk_rope_head_dim``; the compressed kv = x W_kva, of which the first
  ``kv_lora_rank`` dims go through ``kv_a_layernorm`` (RMSNorm) and W_kvb to
  each head's k nope and v; the last ``qk_rope_head_dim`` dims are one
  rope key per token, shared by the heads.  The rope parts are rotated in
  the released layout (each interleaved pair (x[2i], x[2i+1]) read as
  [evens, odds] before ``rotate_half``), with YaRN's inverse frequencies
  and its cos/sin factor mscale(f, mscale) / mscale(f, mscale_all_dim).
  Scores q.k times (nope + rope)^-1/2 * mscale(f, mscale_all_dim)^2, a
  causal mask, softmax, times v, then W_o.
- Layer i < ``first_k_dense_replace``: a gated-silu MLP of
  ``intermediate_size``.
- The other layers: the router's fp32 softmax over all ``n_routed_experts``,
  top-k (``num_experts_per_tok``) with the gates as they are (not
  renormalised where ``norm_topk_prob`` is false), times
  ``routed_scaling_factor``; every chosen expert computes its tokens, none
  dropped; plus the shared experts, one gated-silu MLP of
  ``moe_intermediate_size * n_shared_experts``.  The balance term per
  sequence (``seq_aux``): the mean over sequences of
  Σ_e (choices of e / (S k / E)) · mean_s p_e, summed over the layers.

The share: this chip holds experts ``[expert_offset, expert_offset +
experts_held)`` of each layer; the router keeps its published width, the
tokens routed to held experts are computed, and what the absent experts
would add is left out (as the program does).  The vocabulary is the
slice the configuration states.

Departures from the released code: the balance term is added to the loss
value (the released code adds only its gradient, through
``AddAuxiliaryLoss``; the gradient is the same); the top-k takes the lower
index first on a tie (a stable descending sort; ``torch.topk`` leaves
ties unordered).

``rounding`` is the control's lower precision: every operand of a matrix
product, forward and backward, rounded to fp8 e4m3's 3 mantissa bits
(the fp32 exponent kept), with fp32 accumulation.  Imports nothing of the
program; set ``torch.backends.cuda.matmul.allow_tf32 = False`` (done here)
so that fp32 stays fp32 on the card.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def round_e4m3_mantissa(x: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to 3 mantissa bits (ties to even), kept as fp32."""
    i = x.contiguous().view(torch.int32)
    r = (i + 0x7FFFF + ((i >> 20) & 1)) & ~0xFFFFF
    return r.view(torch.float32)


class _Operand(torch.autograd.Function):
    """Forward: the operand rounded; backward: the incoming gradient rounded
    too, since it is the operand of the backward's products."""

    @staticmethod
    def forward(ctx, x):
        return round_e4m3_mantissa(x)

    @staticmethod
    def backward(ctx, g):
        return round_e4m3_mantissa(g)


class _Output(torch.autograd.Function):
    """Forward: unchanged; backward: the gradient reaching a product's
    output rounded, as it enters that product's backward."""

    @staticmethod
    def forward(ctx, x):
        return x

    @staticmethod
    def backward(ctx, g):
        return round_e4m3_mantissa(g)


def yarn_get_mscale(scale: float, mscale: float) -> float:
    return 0.1 * mscale * math.log(scale) + 1.0 if scale > 1 else 1.0


def yarn_inv_freq(dim: int, base: float, rs: Dict) -> torch.Tensor:
    """``DeepseekV2YarnRotaryEmbedding``'s inverse frequencies."""
    freq_extra = 1.0 / (base ** (torch.arange(0, dim, 2, dtype=torch.float32) / dim))
    freq_inter = 1.0 / (rs["factor"] * base ** (torch.arange(0, dim, 2, dtype=torch.float32) / dim))
    max_pos = rs["original_max_position_embeddings"]

    def corr(rot):
        return (dim * math.log(max_pos / (rot * 2 * math.pi))) / (2 * math.log(base))

    low, high = max(math.floor(corr(rs["beta_fast"])), 0), min(math.ceil(corr(rs["beta_slow"])), dim - 1)
    if low == high:
        high += 0.001
    ramp = torch.clamp((torch.arange(dim // 2, dtype=torch.float32) - low) / (high - low), 0, 1)
    mask = 1.0 - ramp
    return freq_inter * (1 - mask) + freq_extra * mask


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    x1, x2 = x[..., : x.shape[-1] // 2], x[..., x.shape[-1] // 2 :]
    return torch.cat((-x2, x1), dim=-1)


def apply_rotary(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (b, h, s, d): the released ``apply_rotary_pos_emb`` for one tensor."""
    b, h, s, d = x.shape
    x = x.view(b, h, s, d // 2, 2).transpose(4, 3).reshape(b, h, s, d)
    return x * cos + rotate_half(x) * sin


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return w * (x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps))


class DeepSeekV2:
    """``model`` is the configuration's ``model`` section (the released
    config.json's names, as run).  Parameters are a flat dict under the
    program's leaf names (``layers.{i}.attn.wq`` ...), dense weights (in,
    out), expert stacks (held, in, out)."""

    def __init__(self, model: Dict, rounding: bool = False):
        self.m = model
        self.rounding = rounding
        self.scale = (model["qk_nope_head_dim"] + model["qk_rope_head_dim"]) ** -0.5
        rs = model.get("rope_scaling")
        self.rope_scale = 1.0
        if rs:
            self.inv_freq = yarn_inv_freq(model["qk_rope_head_dim"], model["rope_theta"], rs)
            if rs.get("mscale_all_dim"):
                self.scale *= yarn_get_mscale(rs["factor"], rs["mscale_all_dim"]) ** 2
            self.rope_scale = (yarn_get_mscale(rs["factor"], rs.get("mscale", 1))
                               / yarn_get_mscale(rs["factor"], rs.get("mscale_all_dim", 0)))
        else:
            dim = model["qk_rope_head_dim"]
            self.inv_freq = 1.0 / (model["rope_theta"] ** (torch.arange(0, dim, 2, dtype=torch.float32) / dim))

    # -- products (rounded operands under ``rounding``) ------------------
    def _mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if not self.rounding:
            return a @ b
        return _Output.apply(_Operand.apply(a) @ _Operand.apply(b))

    def _mlp(self, p: Params, prefix: str, x: torch.Tensor) -> torch.Tensor:
        h = F.silu(self._mm(x, p[prefix + "w_gate"])) * self._mm(x, p[prefix + "w_up"])
        return self._mm(h, p[prefix + "w_down"])

    # -- the layers ---------------------------------------------------------
    def _attention(self, p: Params, pre: str, x: torch.Tensor) -> torch.Tensor:
        m = self.m
        b, s, _ = x.shape
        nh, nope, rope, vd, r = (m["num_attention_heads"], m["qk_nope_head_dim"], m["qk_rope_head_dim"],
                                 m["v_head_dim"], m["kv_lora_rank"])
        q = self._mm(x, p[pre + "wq"]).view(b, s, nh, nope + rope).transpose(1, 2)
        q_nope, q_pe = q[..., :nope], q[..., nope:]
        ckv = self._mm(x, p[pre + "wkv_a"])
        c, k_pe = ckv[..., :r], ckv[..., r:].view(b, s, 1, rope).transpose(1, 2)
        kv = self._mm(rms_norm(c, p[pre + "kv_norm.scale"], m["rms_norm_eps"]), p[pre + "wkv_b"])
        kv = kv.view(b, s, nh, nope + vd).transpose(1, 2)
        k_nope, v = kv[..., :nope], kv[..., nope:]
        t = torch.arange(s, dtype=torch.float32, device=x.device)
        freqs = torch.outer(t, self.inv_freq.to(x.device))
        emb = torch.cat((freqs, freqs), dim=-1)
        cos, sin = emb.cos() * self.rope_scale, emb.sin() * self.rope_scale
        q_pe, k_pe = apply_rotary(q_pe, cos, sin), apply_rotary(k_pe, cos, sin)
        qs = torch.cat([q_nope, q_pe], dim=-1)
        ks = torch.cat([k_nope, k_pe.expand(b, nh, s, rope)], dim=-1)
        scores = self._mm(qs, ks.transpose(2, 3)) * self.scale
        causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
        attn = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)
        o = self._mm(attn, v).transpose(1, 2).reshape(b, s, nh * vd)
        return self._mm(o, p[pre + "wo"])

    def _experts(self, p: Params, pre: str, x: torch.Tensor):
        """The held experts' part and the shared experts' output of x (b, s,
        d), and the layer's balance term."""
        m = self.m
        b, s, d = x.shape
        E, k = m["n_routed_experts"], m["num_experts_per_tok"]
        scores = torch.softmax(x.reshape(-1, d) @ p[pre + "router"], dim=-1)  # (T, E), the router unrounded
        topk_w, topk_idx = torch.sort(scores, dim=-1, descending=True, stable=True)
        topk_w, topk_idx = topk_w[:, :k], topk_idx[:, :k]
        if m["norm_topk_prob"]:
            topk_w = topk_w / topk_w.sum(dim=-1, keepdim=True)
        topk_w = topk_w * m["routed_scaling_factor"]
        flat = x.reshape(-1, d)
        y = torch.zeros_like(flat)
        lo = m["expert_offset"]
        for e in range(m["experts_held"]):
            tok, slot = torch.nonzero(topk_idx == lo + e, as_tuple=True)
            xe = flat[tok]  # an expert no token chose still computes its (0, d) rows: its gradient is zero
            h = F.silu(self._mm(xe, p[pre + "w_gate"][e])) * self._mm(xe, p[pre + "w_up"][e])
            y = y.index_add(0, tok, self._mm(h, p[pre + "w_down"][e]) * topk_w[tok, slot, None])
        y = y.view(b, s, d) + self._mlp(p, pre + "shared.", x)
        if m["seq_aux"]:
            ce = torch.zeros(b, E, device=x.device).scatter_add(
                1, topk_idx.reshape(b, -1), torch.ones(b, s * k, device=x.device)) / (s * k / E)
            aux = (ce * scores.view(b, s, E).mean(dim=1)).sum(dim=1).mean()
        else:
            raise NotImplementedError("the reference follows DeepSeek-V2's per-sequence balance term only")
        return y, aux

    def hidden(self, p: Params, tokens: torch.Tensor):
        """Final-norm hidden states (b, s, d) and the summed balance term."""
        m = self.m
        eps = m["rms_norm_eps"]
        x = p["embed"][tokens.long()]
        aux = torch.zeros((), device=x.device)
        for i in range(m["num_hidden_layers"]):
            pre = f"layers.{i}."
            x = x + self._attention(p, pre + "attn.", rms_norm(x, p[pre + "norm1.scale"], eps))
            h = rms_norm(x, p[pre + "norm2.scale"], eps)
            if i < m["first_k_dense_replace"]:
                x = x + self._mlp(p, pre + "mlp.", h)
            else:
                f, a = self._experts(p, pre + "moe.", h)
                x, aux = x + f, aux + a
        return rms_norm(x, p["final_norm.scale"], eps), aux

    def logits(self, p: Params, tokens: torch.Tensor):
        x, aux = self.hidden(p, tokens)
        return self._mm(x, p["lm_head"].T), aux

    def loss(self, p: Params, x: torch.Tensor, y: torch.Tensor = None) -> torch.Tensor:
        """Next-token CE of the sequences x (b, s) (token ids, any dtype),
        mean over b (s - 1) positions, plus ``aux_loss_alpha`` times the
        balance term; ``y`` is not read (the loss is self-supervised)."""
        logits, aux = self.logits(p, x)
        toks = x.long()
        ce = F.cross_entropy(logits[:, :-1].reshape(-1, logits.shape[-1]), toks[:, 1:].reshape(-1))
        return ce + self.m["aux_loss_alpha"] * aux

    def feature(self, p: Params, x: torch.Tensor) -> torch.Tensor:
        """The softmax of the logits averaged over sequences and positions (V,)."""
        return torch.softmax(self.logits(p, x)[0], dim=-1).mean(dim=(0, 1))

    def probe(self, p: Params, tokens: torch.Tensor, block: int = 2) -> torch.Tensor:
        """(n, b, s) -> (n, V): :meth:`feature` of each client's sequences,
        ``block`` sequences a forward."""
        n, b = tokens.shape[:2]
        flat = tokens.reshape(n * b, -1)
        sums = torch.cat([torch.softmax(self.logits(p, flat[i : i + block])[0], dim=-1).sum(dim=1)
                          for i in range(0, n * b, block)])
        return sums.reshape(n, b, -1).sum(dim=1) / (b * flat.shape[1])
