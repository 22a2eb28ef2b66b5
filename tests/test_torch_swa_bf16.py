"""The arithmetic of ``swa_attention``'s bf16 tensor-core route, on the CPU.

The CUDA kernel runs only on the card (``tests/test_torch_swa_gpu.py``).  Here
a plain-PyTorch emulation of its arithmetic (128-row query tiles; 128-key
tiles from the first live key; the online softmax in log2 units with fp32
scores, m and l; P rounded to bf16 before P V; l summing the fp32 P) is held
to ``kernels.swa_attention.bf16_limit`` against the port's plain version
``kernels.ref.swa_attention_ref`` over S across the 128 boundaries, windows
below, at and past a tile, causal or not, GQA groups 1 / 2 / 12 and head
dims 32 / 64 / 128, and at causal shapes against the JAX Pallas kernel in
interpret mode.  Inputs are seeded numpy normals rounded to bf16.  Three
mutants of the emulation (a window 64 short, a dropped key tile, a missing
rescale of the accumulator) must exceed the limit, so the limit tells a
right kernel from a wrong one.  The bf16 route's input checks (what TMA
cannot load) are exercised on CPU tensors.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.swa_attention import swa_attention as jswa_attention  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels.swa_attention import bf16_limit, check_inputs  # noqa: E402

TILE = 128  # the kernel's query and key tile
PALLAS_S = (129, 255, 257, 300)  # past a tile: the Pallas kernel pads S (interpret-mode compiles are slow)


@pytest.fixture(autouse=True)
def one_thread():
    """The emulation is hundreds of small ops: one intra-op thread each, so
    that parallel test workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def emulate(q, k, v, window=0, causal=True, drop_tile=None, rescale=True):
    """The bf16 route's arithmetic in plain PyTorch: q (B, H, S, D), k, v
    (B, Hkv, S, D) bf16 -> (B, H, S, D) bf16.  ``drop_tile`` skips that key
    tile of every query tile (when it has one); ``rescale=False`` leaves the
    accumulator unscaled when the running max moves: both are mutants."""
    b, h, s, d = q.shape
    g = h // k.shape[1]
    sl2 = math.log2(math.e) / math.sqrt(d)
    qf = q.float()
    kf, vf = (t.float().repeat_interleave(g, dim=1) for t in (k, v))
    out = torch.empty_like(q)
    for q0 in range(0, s, TILE):
        rows = torch.arange(q0, q0 + TILE)[:, None]
        qt = torch.zeros(b, h, TILE, d)
        qt[:, :, : min(TILE, s - q0)] = qf[:, :, q0 : q0 + TILE]
        k_lo = max(0, q0 - window + 1) if window > 0 else 0
        k_hi = min(s - 1, q0 + TILE - 1) if causal else s - 1
        m = torch.full((b, h, TILE), -1e30)
        l = torch.zeros(b, h, TILE)
        acc = torch.zeros(b, h, TILE, d)
        for t, j0 in enumerate(range(k_lo, k_hi + 1, TILE)):
            if t == drop_tile:
                continue
            kt, vt = torch.zeros(b, h, TILE, d), torch.zeros(b, h, TILE, d)  # rows past S: TMA's zeros
            kt[:, :, : min(TILE, s - j0)] = kf[:, :, j0 : j0 + TILE]
            vt[:, :, : min(TILE, s - j0)] = vf[:, :, j0 : j0 + TILE]
            keys = torch.arange(j0, j0 + TILE)[None, :]
            live = keys < s
            if causal:
                live = live & (keys <= rows)
            if window > 0:
                live = live & (keys > rows - window)
            sc = (qt @ kt.transpose(-1, -2)).masked_fill(~live, -math.inf)
            m_new = torch.maximum(m, sc.amax(-1) * sl2)
            alpha = torch.exp2(m - m_new)
            p = torch.exp2(sc * sl2 - m_new[..., None])
            l = l * alpha + p.sum(-1)
            acc = (acc * alpha[..., None] if rescale else acc) + p.bfloat16().float() @ vt
            m = m_new
        o = acc / l.clamp_min(1e-30)[..., None]
        out[:, :, q0 : q0 + TILE] = o[:, :, : min(TILE, s - q0)].to(q.dtype)
    return out


def inputs(b, h, hkv, s, d, seed):
    rng = np.random.default_rng(seed)
    return [
        torch.from_numpy(rng.standard_normal((b, n, s, d), dtype=np.float32)).bfloat16() for n in (h, hkv, hkv)
    ]


def limit_ratio(got, want, q, k, v, window, causal):
    """max over elements of |got - want| / bf16_limit."""
    limit = bf16_limit(q, k, v, window=window, causal=causal, want=want)
    return ((got.float() - want.float()).abs() / limit).max().item()


@pytest.mark.parametrize("s", [1, 37, 127, 128, 129, 255, 257, 300])
@pytest.mark.parametrize("window", [0, 5, 127, 128, 129, 1000])
@pytest.mark.parametrize("causal", [True, False])
def test_emulation_within_bf16_limit(s, window, causal):
    """Every GQA group and head dim at this (S, window, causal): within
    bf16_limit of the plain version (and 0.05, test_kernels.py's bf16
    tolerance); at causal shapes past one tile also of the Pallas kernel
    (interpret mode, group 2 with K/V repeated to the query heads, as it
    takes no GQA; D 64)."""
    for g in (1, 2, 12):
        for d in (32, 64, 128):
            hkv = 2 if g == 2 else 1
            q, k, v = inputs(1, g * hkv, hkv, s, d, seed=s * 1000 + window + g + d)
            got = emulate(q, k, v, window=window, causal=causal)
            want = ref.swa_attention_ref(q, k, v, window=window, causal=causal)
            assert (got.float() - want.float()).abs().max().item() <= 0.05
            ratio = limit_ratio(got, want, q, k, v, window, causal)
            assert ratio <= 1.0, (g, d, ratio)
            if causal and g == 2 and d == 64 and s in PALLAS_S:  # one interpret-mode compile per case
                jq, jk, jv = (jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) for t in (q, k, v))
                pallas = jswa_attention(jq, jnp.repeat(jk, g, 1), jnp.repeat(jv, g, 1), window=window,
                                        interpret=True)
                pallas = torch.from_numpy(np.array(pallas.astype(jnp.float32)))
                assert limit_ratio(got, pallas, q, k, v, window, causal) <= 1.0, (g, d)


@pytest.mark.parametrize(
    "mutant,s,window,causal",
    [
        ("window-64", 300, 200, True),  # rows past 136 lose their 64 oldest keys
        ("window-64", 300, 200, False),
        ("dropped tile", 300, 0, True),  # query tiles 1 and 2 lose keys 0-127
        ("dropped tile", 257, 129, True),  # the window's first tile
        ("no rescale", 300, 0, True),  # the running max moves between key tiles
        ("no rescale", 300, 1000, False),
    ],
)
def test_mutants_exceed_bf16_limit(mutant, s, window, causal):
    q, k, v = inputs(1, 4, 2, s, 64, seed=7)
    want = ref.swa_attention_ref(q, k, v, window=window, causal=causal)
    right = emulate(q, k, v, window=window, causal=causal)
    assert limit_ratio(right, want, q, k, v, window, causal) <= 1.0
    wrong = {
        "window-64": lambda: emulate(q, k, v, window=window - 64, causal=causal),
        "dropped tile": lambda: emulate(q, k, v, window=window, causal=causal, drop_tile=0),
        "no rescale": lambda: emulate(q, k, v, window=window, causal=causal, rescale=False),
    }[mutant]()
    assert limit_ratio(wrong, want, q, k, v, window, causal) > 1.0


def test_bf16_limit_is_the_rounding_bound():
    """bf16_limit = 2**-8 * (plain version on |v|, fp32) + 2**-7 |ref| + 1e-6."""
    q, k, v = inputs(2, 4, 2, 50, 32, seed=3)
    want = ref.swa_attention_ref(q, k, v, window=20)
    spread = ref.swa_attention_ref(q.float(), k.float(), v.float().abs(), window=20)
    expect = 2.0**-8 * spread + 2.0**-7 * want.float().abs() + 1e-6
    assert torch.equal(bf16_limit(q, k, v, window=20), expect)
    assert torch.equal(bf16_limit(q, k, v, window=20, want=want), expect)
    assert bool((spread >= want.float().abs() - 0.01).all())  # sum p|v| >= |sum p v|, up to bf16 rounding


def strided(dtype, d=32, pad=0, offset=0):
    """q, k, v as (B, H, S, D) views of (B, S, H, D + pad) buffers, the first
    element ``offset`` elements into the storage."""
    buf = torch.zeros(offset + 2 * 40 * 4 * (d + pad), dtype=dtype)[offset:].view(2, 40, 4, d + pad)
    q = buf[..., :d].transpose(1, 2)
    return q, q[:, :2], q[:, :2]


@pytest.mark.parametrize(
    "make,match",
    [
        (lambda dt: tuple(t[..., ::2] for t in strided(dt, d=64)), "contiguous last dim"),
        (lambda dt: strided(dt, pad=4), "multiples of 16 bytes"),  # head stride 36 elements: 72 bytes
        (lambda dt: strided(dt, offset=1), "multiple of 16 bytes"),  # base 2 bytes in
    ],
    ids=["last-dim-stride-2", "head-stride-72-bytes", "base-misaligned"],
)
def test_bf16_route_refuses_what_tma_cannot_load(make, match):
    with pytest.raises(ValueError, match=match):
        check_inputs(*make(torch.bfloat16), window=0)
    check_inputs(*make(torch.float32), window=0)  # the fp32 route reads any strides


def test_bf16_route_takes_the_models_layouts():
    """(B, H, S, D) views of (B, S, H, D) projections, contiguous tensors, and
    a size-1 dim with any stride."""
    check_inputs(*strided(torch.bfloat16), window=0)
    q, k, v = inputs(1, 4, 2, 33, 128, seed=0)
    check_inputs(q, k, v, window=8)
    check_inputs(q[:, :1], k[:, :1], v[:, :1], window=8)
