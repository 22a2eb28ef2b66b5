"""The ``mla_attention`` kernel on the card (``csrc/mla_attention.cu``) against
the fp32 reference of the same function, at the LM cell's shapes: 16 heads,
q and k 192 wide, v 128, S 2048, B 4 (a 2-lane x 2-sequence ``.grad`` or
``.feature`` call folded into the batch) and B 16 (the probe), and at ragged
lengths (1000, 129) that end inside a tile.  No JAX: run with
``--noconftest``.

    python -m pytest --noconftest -q -m cuda tests/test_torch_mla_attention_gpu.py

o, dq, dk and dv are each held element by element to
``kernels.mla_attention.reference_and_limits``: the bf16 roundings the
kernel adds (P before P V and P^T dO, dS before dS K and dS^T Q, the
outputs, D from the bf16 o), each at 2^-8 (twice bf16's 2^-9).  The plain
bf16 path, which rounds the scores to bf16 before its softmax, reads above
the limit on o: the limits tell the kernel's arithmetic from it.  Also: one
launch a direction under a 2-lane ``vmap``, bit for bit the lanes' own
launches.
"""
from __future__ import annotations

import math
import sys
from pathlib import Path

import pytest
import torch
from torch.func import grad, vmap

ROOT = Path(__file__).resolve().parent.parent
for path in (str(ROOT), str(ROOT / "src")):
    if path not in sys.path:
        sys.path.insert(0, path)

pytestmark = pytest.mark.cuda

HEADS = 16
# DeepSeek-V2-Lite's softmax scale: 1/sqrt(192) times YaRN's mscale(40, 0.707)^2
SCALE = 192**-0.5 * (0.1 * 0.707 * math.log(40) + 1) ** 2


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False


def _inputs(b, s, seed=0, lanes=None):
    """bf16 q, k (b, s, 16, 192) and v (b, s, 16, 128) as the model makes them
    (v a strided view of the (.., 256) kv projection), and dO."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    lead = (b,) if lanes is None else (lanes, b)

    def draw(*shape):
        return torch.randn(*lead, *shape, generator=g, device="cuda").to(torch.bfloat16)

    kv = draw(s, HEADS, 256)
    return draw(s, HEADS, 192), draw(s, HEADS, 192), kv[..., 128:], draw(s, HEADS, 128)


@pytest.mark.parametrize("b, s", [(4, 2048), (16, 2048), (4, 1000), (3, 129)])
def test_kernel_against_the_fp32_reference(b, s):
    _needs_card()
    from repro_torch.kernels import mla_attention as kmla
    from repro_torch.kernels import ref

    q, k, v, do = _inputs(b, s)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    o = kmla.mla_attention(*leaves, SCALE)
    o.backward(do.flatten(2))
    got = {"o": o.detach().unflatten(2, (HEADS, 128)), "dq": leaves[0].grad, "dk": leaves[1].grad,
           "dv": leaves[2].grad}
    want, lim = kmla.reference_and_limits(q, k, v, do, SCALE)
    ratios = {n: ((got[n].float() - want[n]).abs() / lim[n]).max().item() for n in want}
    gaps = {n: ((got[n].float() - want[n]).abs().max() / want[n].abs().max()).item() for n in want}
    plain = ref.mla_attention_ref(q, k, v, SCALE).unflatten(2, (HEADS, 128))
    plain_ratio = ((plain.float() - want["o"]).abs() / lim["o"]).max().item()
    print(f"B {b} S {s}: ratio to limit {ratios}; gap over the largest value {gaps}; plain bf16 o {plain_ratio}")
    assert all(torch.isfinite(t).all() for t in got.values())
    assert max(ratios.values()) <= 1.0, ratios
    if s == 2048:
        assert plain_ratio > 1.0, plain_ratio


def test_one_launch_a_direction_under_vmap():
    _needs_card()
    from repro_torch.kernels import mla_attention as kmla
    from repro_torch.kernels import ops

    q, k, v, do = _inputs(2, 256, seed=1, lanes=2)

    def score(q_, k_, v_, g_):
        return (kmla.mla_attention(q_, k_, v_, SCALE).float() * g_.flatten(2).float()).sum()

    ops.reset_launch_counts()
    grads = vmap(grad(score, argnums=(0, 1, 2)))(q, k, v, do)
    fn = ops.KERNELS["mla_attention"]
    assert (fn.launches_forward, fn.launches_backward) == (1, 1)
    for j in range(2):  # the folded launch computes each lane as the lane's own launch does
        own = grad(score, argnums=(0, 1, 2))(q[j], k[j], v[j], do[j])
        assert all(torch.equal(a[j], b) for a, b in zip(grads, own))
    ops.reset_launch_counts()
    with torch.inference_mode():
        out = vmap(lambda *a: kmla.mla_attention(*a, SCALE))(q, k, v)
    assert (fn.launches_forward, fn.launches_backward) == (1, 0)
    assert torch.equal(out[1], kmla.mla_attention(q[1], k[1], v[1], SCALE))
