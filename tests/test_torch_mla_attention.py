"""MLA's causal core (``kernels/mla_attention.py``) on the CPU.

- The CPU route is the parent's plain path bit for bit: ``mla_forward``'s
  output, the gradients of a 2-lane ``vmap`` of ``grad_and_value`` through
  the LM backend, and its ``inference_mode`` feature under ``vmap``, each
  against the same run with the core sent to ``parent_core``, the plain
  path before the kernel existed, written out here.
- The route, held in ``kernels.ops.mla_attention`` alone: CUDA bf16 inputs
  take the kernel, the CPU and fp32 take ``kernels.ref.mla_attention_ref``.
- The counters of ``ops.KERNELS["mla_attention"]``.
- The ``autograd.Function`` and its ``vmap`` rules, with the two launches
  replaced by fp32 CPU versions of the kernel's own formulas (the forward's
  log-sum-exp; the backward's D = rowsum(dO o), dS = P (dP - D) scale):
  one call a direction for all lanes, and gradients that match autograd
  through the plain version to 1e-5 of the largest element (fp32 sums in
  another order).  The kernel itself runs on the card only
  (``tests/test_torch_mla_attention_gpu.py``).
"""
from __future__ import annotations

import dataclasses
import math
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch
from torch.func import grad_and_value, vmap

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.fl.backend import lm_backend  # noqa: E402
from repro_torch.kernels import mla_attention as kmla  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import attention, decoder  # noqa: E402

TINY = dataclasses.replace(
    reduced(get_config("deepseek-v2-lite")), num_layers=2, d_model=64, num_heads=2, num_kv_heads=2, head_dim=16,
    kv_lora_rank=16, q_head_dim_nope=8, q_head_dim_rope=8, v_head_dim=8, d_ff=32, dense_d_ff=96, vocab_size=256,
    num_experts=8, experts_held=4, expert_offset=0, experts_per_token=2, num_shared_experts=1)
LANES, BATCH, S = 2, 2, 24
RTOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def parent_core(q, k, v, scale):
    """The core as the parent ran it, on every device (its
    ``models.attention._masked_softmax_chunks(q, k, v, True, 0, scale)``,
    written out): query chunks of 512 over 1024 tokens, the scores in q's
    dtype times ``scale``, then fp32, masked above the diagonal with -1e30,
    softmax, rounded to q's dtype, times v."""
    S = q.shape[1]
    if S > 1024 and S % 512 == 0:
        return torch.cat([parent_rows(q[:, i : i + 512], k, v, i, scale) for i in range(0, S, 512)], dim=1)
    return parent_rows(q, k, v, 0, scale)


def parent_rows(q, k, v, q_offset, scale):
    B, Cq, nh, hd = q.shape
    Sk = k.shape[1]
    s = (torch.einsum("bqkgh,bskh->bkgqs", q.reshape(B, Cq, nh, 1, hd), k) * scale).reshape(B, nh, Cq, Sk).float()
    iq = q_offset + torch.arange(Cq)[:, None]
    jk = torch.arange(Sk)[None, :]
    attn = torch.softmax(s.masked_fill(~(jk <= iq), -1e30), dim=-1).to(q.dtype)
    o = torch.einsum("bkgqs,bskh->bqkgh", attn.reshape(B, nh, 1, Cq, Sk), v)
    return o.reshape(B, Cq, nh * v.shape[3])


def lane_params(cfg):
    lanes = [decoder.flat_params(decoder.init_params(cfg, seed, "cpu")) for seed in range(LANES)]
    return {k: torch.stack([p[k] for p in lanes]) for k in lanes[0]}


def run_path(path, cfg, dtype):
    cfg = dataclasses.replace(cfg, dtype=dtype)
    g = torch.Generator().manual_seed(7)
    if path in ("layer", "layer_chunked"):
        seq = 1536 if path == "layer_chunked" else S  # 1536: three query chunks of 512
        small = dataclasses.replace(cfg, num_heads=1) if path == "layer_chunked" else cfg
        p = attention.init_mla(torch.Generator().manual_seed(3), small, dtype)
        x = torch.randn(BATCH, seq, small.d_model, generator=g).to(dtype)
        return [attention.mla_forward(small, p, x, torch.arange(seq))]
    backend = lm_backend(cfg)
    p = lane_params(cfg)
    toks = torch.randint(0, cfg.vocab_size, (LANES, BATCH, S), generator=g).float()
    if path == "grad":
        loss, grads = vmap(backend.grad_loss)(p, toks, toks)
        return [loss, *grads.values()]
    with torch.inference_mode():
        return [vmap(backend.feature)(p, toks)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("path", ["layer", "layer_chunked", "grad", "feature"])
def test_cpu_route_is_the_parent_path_bit_for_bit(path, dtype, monkeypatch):
    got = run_path(path, TINY, dtype)
    monkeypatch.setattr(ref, "mla_attention_ref", parent_core)
    want = run_path(path, TINY, dtype)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("device, dtype, kernel", [
    ("cuda", torch.bfloat16, True), ("cuda", torch.float32, False), ("cpu", torch.bfloat16, False),
    ("cpu", torch.float32, False),
])
def test_route_choice(device, dtype, kernel, monkeypatch):
    """``ops.mla_attention`` alone picks the route, from what q shows; on the
    CPU ``mla_forward`` reaches the plain version through it and never the
    kernel."""
    q = SimpleNamespace(device=torch.device(device), dtype=dtype)
    assert kmla.takes_kernel(q) is kernel
    calls = []
    monkeypatch.setattr(ref, "mla_attention_ref", lambda *a: calls.append("ref") or parent_core(*a))
    monkeypatch.setattr(ops, "_mla_attention", lambda *a: calls.append("kernel"))
    if device == "cpu":
        p = attention.init_mla(torch.Generator().manual_seed(0), TINY, dtype)
        attention.mla_forward(TINY, p, torch.randn(1, 8, TINY.d_model).to(dtype), torch.arange(8))
        assert calls == ["ref"]
    else:
        monkeypatch.setattr(ref, "mla_attention_ref", lambda *a: calls.append("ref"))
        ops.mla_attention(q, q, q, 0.1)
        assert calls == ["kernel" if kernel else "ref"]


def test_counters_in_ops_kernels():
    fn = ops.KERNELS["mla_attention"]
    assert fn is kmla.mla_attention and "mla_attention" not in ops.ROUTES
    for name in ("launches", "launches_forward", "launches_backward"):
        setattr(fn, name, 3)
    assert ops.launch_counts()["mla_attention"] == 3
    ops.reset_launch_counts()
    assert (fn.launches, fn.launches_forward, fn.launches_backward) == (0, 0, 0)


def test_kernel_refuses_cpu_tensors():
    q = torch.zeros(1, 4, 2, kmla.DK, dtype=torch.bfloat16)
    v = torch.zeros(1, 4, 2, kmla.DV, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA device"):
        kmla.forward(q, q, v, 0.1)
    with pytest.raises(TypeError, match="bf16"):
        kmla.forward(q.float(), q.float(), v.float(), 0.1)
    with pytest.raises(ValueError, match="v"):
        kmla.forward(q, q, q, 0.1)


# --- the Function and its vmap rules, the launches replaced ------------------


def cpu_forward(q, k, v, scale):
    """The forward launch's result in fp32 on the CPU: o, and lse as a
    (B, H, S) view of a buffer padded to the kernel's tile."""
    s = torch.einsum("bihd,bjhd->bhij", q.float(), k.float()) * scale
    n = q.shape[1]
    s = s.masked_fill(torch.ones(n, n, dtype=torch.bool).triu(1), float("-inf"))
    lse = torch.logsumexp(s, dim=-1)
    o = torch.einsum("bhij,bjhd->bihd", torch.exp(s - lse[..., None]), v.float())
    buf = torch.zeros(*lse.shape[:2], -(-n // kmla.TILE) * kmla.TILE)
    buf[..., :n] = lse
    return o.to(q.dtype), buf[..., :n]


def cpu_backward(do, q, k, v, o, lse, scale):
    """The backward launch's formulas in fp32: P from q, k and lse, then
    D = rowsum(dO o), dP = dO V^T, dS = P (dP - D) scale, dq = dS K,
    dk = dS^T Q, dv = P^T dO."""
    q, k, v, o, do = (t.float() for t in (q, k, v, o, do))
    n = q.shape[1]
    s = torch.einsum("bihd,bjhd->bhij", q, k) * scale
    p = torch.exp(s - lse[..., None]).masked_fill(torch.ones(n, n, dtype=torch.bool).triu(1), 0.0)
    d = torch.einsum("bihd,bihd->bhi", do, o)
    dp = torch.einsum("bihd,bjhd->bhij", do, v)
    ds = p * (dp - d[..., None]) * scale
    return (torch.einsum("bhij,bjhd->bihd", ds, k), torch.einsum("bhij,bihd->bjhd", ds, q),
            torch.einsum("bhij,bihd->bjhd", p, do))


@pytest.fixture
def counted_launches(monkeypatch):
    calls = []

    def fwd(q, k, v, scale):
        calls.append(("forward", q.shape[0]))
        return cpu_forward(q, k, v, scale)

    def bwd(do, q, k, v, o, lse, scale):
        calls.append(("backward", q.shape[0]))
        assert lse.shape == (q.shape[0], q.shape[2], q.shape[1])
        return cpu_backward(do, q, k, v, o, lse, scale)

    monkeypatch.setattr(kmla, "forward", fwd)
    monkeypatch.setattr(kmla, "backward", bwd)
    return calls


def core_inputs(seq=S, heads=3, seed=0):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(LANES, BATCH, seq, heads, kmla.DK, generator=g)
    k = torch.randn(LANES, BATCH, seq, heads, kmla.DK, generator=g)
    v = torch.randn(LANES, BATCH, seq, heads, kmla.DV, generator=g)
    proj = torch.randn(LANES, BATCH, seq, heads * kmla.DV, generator=g)
    return q, k, v, proj, 1 / math.sqrt(kmla.DK)


def close(got, want):
    return (got - want).abs().max().item() <= RTOL * want.abs().max().item()


@pytest.mark.parametrize("seq", [S, 131])  # 131: past one tile of 128, ragged
def test_function_gradients_one_call_a_direction_under_vmap(seq, counted_launches):
    q, k, v, proj, scale = core_inputs(seq)

    def score(q_, k_, v_, pr):
        return (kmla.mla_attention(q_, k_, v_, scale) * pr).sum()

    (gq, gk, gv), val = vmap(grad_and_value(score, argnums=(0, 1, 2)))(q, k, v, proj)
    assert counted_launches == [("forward", LANES * BATCH), ("backward", LANES * BATCH)]
    for j in range(LANES):
        leaves = [t[j].clone().requires_grad_() for t in (q, k, v)]
        want = (ref.mla_attention_ref(*leaves, scale) * proj[j]).sum()
        wq, wk, wv = torch.autograd.grad(want, leaves)
        assert close(val[j], want.detach())
        assert close(gq[j], wq) and close(gk[j], wk) and close(gv[j], wv)


def test_function_feature_one_forward_under_vmap_and_inference_mode(counted_launches):
    q, k, v, _, scale = core_inputs()
    with torch.inference_mode():
        out = vmap(lambda *a: kmla.mla_attention(*a, scale))(q, k, v)
    assert counted_launches == [("forward", LANES * BATCH)]
    want = torch.stack([ref.mla_attention_ref(q[j], k[j], v[j], scale) for j in range(LANES)])
    assert out.shape == want.shape and close(out, want)


def test_function_without_vmap(counted_launches):
    q, k, v, proj, scale = core_inputs()
    leaves = [t[0].clone().requires_grad_() for t in (q, k, v)]
    (kmla.mla_attention(*leaves, scale) * proj[0]).sum().backward()
    assert counted_launches == [("forward", BATCH), ("backward", BATCH)]
    refs = [t[0].clone().requires_grad_() for t in (q, k, v)]
    (ref.mla_attention_ref(*refs, scale) * proj[0]).sum().backward()
    assert all(close(a.grad, b.grad) for a, b in zip(leaves, refs))


def test_fold_and_padded_lse():
    t = torch.randn(3, 2, 5, 4, 8)
    folded = kmla._fold(t.movedim(0, 2), 2, 3)
    assert torch.equal(folded, t.flatten(0, 1)) and torch.equal(kmla._unfold(folded, 3), t)
    assert torch.equal(kmla._fold(t[0], None, 3), t[0].expand(3, *t[0].shape).flatten(0, 1))
    lse = torch.randn(2, 3, 130)
    padded = kmla._padded_lse(lse, 130)
    assert torch.equal(padded, lse) and padded.stride(1) == 256
    assert kmla._padded_lse(padded, 130) is padded
