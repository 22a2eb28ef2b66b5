"""The arithmetic of ``ssd_scan``'s bf16 tensor-core route, on the CPU.

The CUDA kernel runs only on the card (``tests/test_torch_ssd_gpu.py``).  Here
a plain-PyTorch emulation of its arithmetic (64-row tiles as the route's
chunks, rows past S zero as TMA fills them; G = C·Bᵀ in fp32; P = G ∘
exp(a_i − a_j) ∘ dt_j rounded to bf16 before P·X; the fp32 state's bf16 copy
in C·Sᵀ; X∘w rounded to bf16 before the state update) is held to
``kernels.ssd_scan.ssd_bf16_limit`` against the port's plain version
``kernels.ref.ssd_scan_ref`` and against the plain chunked form
``models.ssd.ssd_chunked`` at chunks 64, 256 and 300, over S across the
tile edges (1, 63, 64, 65, 300), hp 32 / 64, ds 16 / 128 and decay 1 and
0.01 (where the state carries across many tiles); at two small shapes also
against the JAX Pallas kernel in interpret mode and the JAX oracle.  Inputs
are seeded numpy values rounded to bf16.  Three mutants of the emulation (the
state not carried, the state's decay across a tile edge dropped, a strict
lower mask) must exceed the limit, so the limit tells a right kernel from a
wrong one.  The bf16 route's input checks (what TMA cannot load) are
exercised on CPU tensors.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.ssd_scan import ssd_scan as jssd_scan  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels.ssd_scan import check_inputs, ssd_bf16_limit  # noqa: E402
from repro_torch.models.ssd import ssd_chunked  # noqa: E402

TILE = 64  # the route's tile and chunk


@pytest.fixture(autouse=True)
def one_thread():
    """Many small ops per test: one intra-op thread each, so that parallel
    test workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def bf16(t):
    return t.bfloat16().float()


def emulate(x, dt, A, Bm, Cm, carry=True, decay_across=True, strict=False):
    """The bf16 route's arithmetic in plain PyTorch: x (B, S, nh, hp), Bm, Cm
    (B, S, ds) bf16; dt (B, S, nh), A (nh,) fp32 -> (y, final state), fp32.
    ``carry=False`` restarts the state at every tile, ``decay_across=False``
    adds a tile's update to the state without decaying the old state, and
    ``strict`` masks j < i for j <= i: all three are mutants."""
    b, s, nh, hp = x.shape
    ds = Bm.shape[-1]
    state = torch.zeros(b, nh, hp, ds)
    y = torch.empty(b, s, nh, hp)
    i_idx = torch.arange(TILE)[:, None]
    j_idx = torch.arange(TILE)[None, :]
    mask = (j_idx < i_idx) if strict else (j_idx <= i_idx)
    for s0 in range(0, s, TILE):
        rows = min(TILE, s - s0)
        xt, dtt = torch.zeros(b, TILE, nh, hp), torch.zeros(b, TILE, nh)
        Bt, Ct = torch.zeros(b, TILE, ds), torch.zeros(b, TILE, ds)
        xt[:, :rows], dtt[:, :rows] = x[:, s0 : s0 + rows].float(), dt[:, s0 : s0 + rows]
        Bt[:, :rows], Ct[:, :rows] = Bm[:, s0 : s0 + rows].float(), Cm[:, s0 : s0 + rows].float()
        if not carry:
            state = torch.zeros_like(state)
        acum = torch.cumsum(dtt * A, dim=1)  # (b, 64, nh)
        total = acum[:, -1]  # (b, nh)
        g = torch.einsum("bin,bjn->bij", Ct, Bt)
        decay = torch.exp(acum[:, :, None, :] - acum[:, None, :, :])  # (b, i, j, nh)
        p = torch.where(mask[None, :, :, None], g[..., None] * decay * dtt[:, None, :, :], 0.0)
        y_diag = torch.einsum("bijh,bjhp->bihp", bf16(p), xt)
        y_off = torch.exp(acum)[..., None] * torch.einsum("bin,bhpn->bihp", Ct, bf16(state))
        y[:, s0 : s0 + rows] = (y_diag + y_off)[:, :rows]
        xw = bf16(xt * (dtt * torch.exp(total[:, None, :] - acum))[..., None])
        update = torch.einsum("bjhp,bjn->bhpn", xw, Bt)
        state = (state * torch.exp(total)[..., None, None] if decay_across else state) + update
    return y, state


def inputs(b, s, nh, hp, ds, seed, decay=1.0, silu=False):
    """Seeded numpy inputs in ``ssd_forward``'s value ranges, x, B and C
    rounded to bf16: signed normals, or silu'd ones as the model's conv
    output gives; ``decay`` < 1 scales A down so the state carries."""
    rng = np.random.default_rng(seed)
    xbc = torch.from_numpy(rng.standard_normal((b, s, nh * hp + 2 * ds), dtype=np.float32))
    xbc = torch.nn.functional.silu(xbc) if silu else xbc * 0.5
    xbc = xbc.bfloat16()
    x = xbc[..., : nh * hp].reshape(b, s, nh, hp)
    Bm, Cm = xbc[..., nh * hp : nh * hp + ds], xbc[..., nh * hp + ds :]
    dt = torch.nn.functional.softplus(torch.from_numpy(rng.standard_normal((b, s, nh), dtype=np.float32)))
    A = -torch.exp(torch.from_numpy(rng.standard_normal(nh, dtype=np.float32) * 0.3)) * decay
    return x, dt, A, Bm, Cm


def limit_ratios(got, want, args):
    """max over elements of |got - want| / ssd_bf16_limit, for y and state."""
    lim = ssd_bf16_limit(*args, *want)
    return [((g - w).abs() / l).max().item() for g, w, l in zip(got, want, lim)]


@pytest.mark.parametrize("s", [1, 63, 64, 65, 300])
@pytest.mark.parametrize("hp,ds", [(32, 16), (32, 128), (64, 16), (64, 128)])
@pytest.mark.parametrize("decay", [1.0, 0.01])
def test_emulation_within_bf16_limit(s, hp, ds, decay):
    """Within ssd_bf16_limit of the recurrence and of the plain chunked form
    at chunks 64, 256 and 300 (the same function for every chunk)."""
    args = inputs(2, s, 2, hp, ds, seed=s * 7 + hp + ds, decay=decay)
    got = emulate(*args)
    assert all(bool(torch.isfinite(t).all()) for t in got)
    want = ref.ssd_scan_ref(*args)
    assert max(limit_ratios(got, want, args)) <= 1.0
    for chunk in (64, 256, 300):
        chunked = ssd_chunked(*args, chunk)
        assert max(limit_ratios(got, chunked, args)) <= 1.0, chunk


@pytest.mark.parametrize(
    "b,s,nh,hp,ds,chunk,silu", [(1, 130, 2, 64, 128, 64, True), (2, 70, 2, 32, 16, 32, False)]
)
def test_emulation_within_bf16_limit_of_pallas_and_jax_oracle(b, s, nh, hp, ds, chunk, silu):
    """The same inputs through the Pallas kernel (interpret mode) and the JAX
    oracle, which both read the bf16 x, B and C and sum in fp32."""
    args = inputs(b, s, nh, hp, ds, seed=11, decay=0.01, silu=silu)
    got = emulate(*args)
    jargs = [jnp.asarray(t.float().numpy()) for t in args]
    for i in (0, 3, 4):
        jargs[i] = jargs[i].astype(jnp.bfloat16)
    for jy, js in (jssd_scan(*jargs, chunk=chunk, interpret=True), jref.ssd_scan_ref(*jargs)):
        want = (torch.from_numpy(np.array(jy, np.float32)), torch.from_numpy(np.array(js, np.float32)))
        assert max(limit_ratios(got, want, args)) <= 1.0


@pytest.mark.parametrize(
    "mutant,decay",
    [("no carry", 1.0), ("no carry", 0.01), ("no decay across tiles", 0.01), ("strict mask", 1.0),
     ("strict mask", 0.01)],
)
def test_mutants_exceed_bf16_limit(mutant, decay):
    args = inputs(1, 300, 2, 64, 128, seed=5, decay=decay, silu=True)
    want = ref.ssd_scan_ref(*args)
    assert max(limit_ratios(emulate(*args), want, args)) <= 1.0
    kw = {"no carry": {"carry": False}, "no decay across tiles": {"decay_across": False},
          "strict mask": {"strict": True}}[mutant]
    assert max(limit_ratios(emulate(*args, **kw), want, args)) > 1.0


def test_bf16_limit_is_the_rounding_bound():
    """ssd_bf16_limit = (2**-7 ȳ, 2**-8 S̄) from the recurrence on |x|, |B|,
    |C|, plus 1e-4 max(1, max |ref|); the magnitude sums bound the outputs."""
    args = inputs(2, 50, 2, 32, 16, seed=3)
    want = ref.ssd_scan_ref(*args)
    x, dt, A, Bm, Cm = args
    y_abs, s_abs = ref.ssd_scan_ref(x.float().abs(), dt, A, Bm.float().abs(), Cm.float().abs())
    y_lim, s_lim = ssd_bf16_limit(*args, *want)
    assert torch.equal(y_lim, 2.0**-7 * y_abs + 1e-4 * max(1.0, want[0].abs().max().item()))
    assert torch.equal(s_lim, 2.0**-8 * s_abs + 1e-4 * max(1.0, want[1].abs().max().item()))
    assert bool((y_abs >= want[0].abs() - 1e-5).all()) and bool((s_abs >= want[1].abs() - 1e-5).all())


def model_views(dtype, nh=2, hp=32, ds=16, pad=0, offset=0):
    """x, B and C as ssd_forward passes them: slices of one (B, S, nh·hp +
    2·ds + pad) buffer whose first element is ``offset`` elements in."""
    width = nh * hp + 2 * ds + pad
    buf = torch.zeros(offset + 2 * 40 * width, dtype=dtype)[offset:].view(2, 40, width)
    x = buf[..., : nh * hp].view(2, 40, nh, hp)
    dt = torch.rand(2, 40, nh)
    A = -torch.ones(nh)
    return x, dt, A, buf[..., nh * hp : nh * hp + ds], buf[..., nh * hp + ds : nh * hp + 2 * ds]


@pytest.mark.parametrize(
    "make,match",
    [
        (lambda d: (lambda x, dt, A, B, C: (x, dt, A, B.as_strided(B.shape, (B.stride(0), B.stride(1), 2)), C))(
            *model_views(d, ds=16)), "contiguous last dim"),
        (lambda d: model_views(d, pad=4), "multiples of 16 bytes"),  # row of 100 elements: 200 bytes
        (lambda d: model_views(d, offset=1), "multiple of 16 bytes"),  # base 2 bytes in
    ],
    ids=["last-dim-stride-2", "row-stride-200-bytes", "base-misaligned"],
)
def test_bf16_route_refuses_what_tma_cannot_load(make, match):
    with pytest.raises(ValueError, match=match):
        check_inputs(*make(torch.bfloat16), chunk=64)
    check_inputs(*make(torch.float32), chunk=64)  # the fp32 route reads any strides


def test_bf16_route_takes_the_models_layouts():
    """Views of the conv output (as ssd_forward passes them) at the reduced
    and the mamba2-1.3b widths, contiguous tensors, and a size-1 batch."""
    check_inputs(*model_views(torch.bfloat16), chunk=64)
    check_inputs(*model_views(torch.bfloat16, nh=4, hp=64, ds=128), chunk=256)
    x, dt, A, Bm, Cm = inputs(1, 33, 2, 64, 128, seed=0)
    check_inputs(x.contiguous(), dt, A, Bm.contiguous(), Cm.contiguous(), chunk=8)
    check_inputs(x[:1], dt[:1], A, Bm[:1], Cm[:1], chunk=8)
