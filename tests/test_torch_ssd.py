"""The port's Mamba2 SSD block against the JAX package's, on the CPU.

Inputs are made with numpy from a seed and given to both packages.  On the
CPU the port's ``kernels.ops.ssd_scan`` runs its plain version, the exact
recurrence; it is held to the Pallas kernel in interpret mode and to the
JAX oracle over ``tests/test_kernels.py``'s shapes at that file's
tolerances (fp32 2e-5; bf16 0.15, where both sides round the same bf16
inputs but sum in another order).  ``ssd_chunked``, ``ssd_forward`` (plain
and kernel routes) and ``ssd_decode`` are held to the JAX ones in fp32 at
1e-4, as ``tests/test_models.py`` holds the JAX routes to each other.  The
Hopper kernel itself is tested in ``tests/test_torch_ssd_gpu.py``.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.ssd_scan import ssd_scan as jssd_scan  # noqa: E402
from repro.models import ssd as jssd  # noqa: E402
from repro_torch.checkpoint.convert import tensor_from_numpy  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import ssd  # noqa: E402

CPU = torch.device("cpu")
FP32_TOL = 1e-4


def scan_inputs(b, s, nh, hp, ds, seed=0):
    """numpy fp32 inputs in the JAX tests' value ranges."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, nh, hp), dtype=np.float32) * 0.5
    dt = np.log1p(np.exp(rng.standard_normal((b, s, nh), dtype=np.float32)))
    A = -np.exp(rng.standard_normal(nh, dtype=np.float32) * 0.3)
    Bm = rng.standard_normal((b, s, ds), dtype=np.float32) * 0.5
    Cm = rng.standard_normal((b, s, ds), dtype=np.float32) * 0.5
    return x, dt, A, Bm, Cm


def both(arrays, low_precision):
    """The same arrays for JAX and for torch; x, B and C (indices 0, 3, 4)
    rounded to bf16 on both sides when ``low_precision``."""
    jx, tx = [], []
    for i, a in enumerate(arrays):
        j, t = jnp.asarray(a), torch.from_numpy(a.copy())
        if low_precision and i in (0, 3, 4):
            j, t = j.astype(jnp.bfloat16), t.to(torch.bfloat16)
        jx.append(j)
        tx.append(t)
    return jx, tx


def assert_close(t, j, tol):
    np.testing.assert_allclose(t.detach().float().numpy(), np.asarray(j, np.float32), rtol=tol, atol=tol)


@pytest.mark.parametrize(
    "b,s,nh,hp,ds,chunk",
    [
        (1, 32, 2, 64, 16, 8),
        (2, 64, 4, 64, 128, 16),
        (1, 50, 2, 32, 16, 16),  # padded S
        (1, 128, 1, 64, 128, 64),
    ],
)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_scan_plain_matches_pallas_and_oracle(b, s, nh, hp, ds, chunk, dtype):
    jin, tin = both(scan_inputs(b, s, nh, hp, ds), dtype == "bfloat16")
    y, state = ops.ssd_scan(*tin, chunk=chunk)
    assert y.dtype == state.dtype == torch.float32
    assert y.shape == (b, s, nh, hp) and state.shape == (b, nh, hp, ds)
    tol = 2e-5 if dtype == "float32" else 0.15
    for jy, js in (jssd_scan(*jin, chunk=chunk, interpret=True), jref.ssd_scan_ref(*jin)):
        assert_close(y, jy, tol)
        assert_close(state, js, tol)


@pytest.mark.parametrize("b,s,nh,hp,ds,chunk", [(2, 48, 4, 32, 16, 16), (1, 50, 2, 32, 16, 16), (2, 64, 2, 64, 128, 32)])
@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_chunked_matches(b, s, nh, hp, ds, chunk, with_state):
    arrays = scan_inputs(b, s, nh, hp, ds, seed=1)
    jin, tin = both(arrays, False)
    init = None
    if with_state:
        init = np.random.default_rng(2).standard_normal((b, nh, hp, ds), dtype=np.float32) * 0.3
    jy, js = jax.jit(jssd.ssd_chunked, static_argnums=5)(*jin, chunk, None if init is None else jnp.asarray(init))
    y, state = ssd.ssd_chunked(*tin, chunk, init_state=None if init is None else torch.from_numpy(init))
    assert_close(y, jy, 2e-5)
    assert_close(state, js, 2e-5)


@pytest.fixture(scope="module")
def block():
    """reduced(mamba2-1.3b) with one block's weights from the JAX
    initialiser, carried across, plus an input and its JAX outputs."""
    jcfg, cfg = jreduced(jget_config("mamba2-1.3b")), reduced(get_config("mamba2-1.3b"))
    jp = ssd_params_with_nonzero_biases(jssd.init_ssd(jax.random.PRNGKey(3), jcfg, jnp.float32))
    p = {k: tensor_from_numpy(np.asarray(v), CPU) for k, v in jp.items()}
    x = np.random.default_rng(4).standard_normal((2, 70, jcfg.d_model), dtype=np.float32) * 0.5
    return jcfg, cfg, jp, p, x


def ssd_params_with_nonzero_biases(jp):
    """The initialiser zeroes conv_b and dt_bias and sets D and norm_scale to
    one; perturb them so that a wrong use of any of them shows."""
    rng = np.random.default_rng(5)
    out = dict(jp)
    for k in ("conv_b", "dt_bias", "D", "norm_scale"):
        out[k] = jp[k] + jnp.asarray(rng.standard_normal(jp[k].shape, dtype=np.float32) * 0.1, jp[k].dtype)
    return out


@pytest.mark.parametrize("use_kernel", [False, True])
def test_ssd_forward_matches(block, use_kernel):
    jcfg, cfg, jp, p, x = block
    want = jax.jit(lambda p_, x_: jssd.ssd_forward(jcfg, p_, x_, use_kernel=use_kernel))(jp, jnp.asarray(x))
    got = ssd.ssd_forward(cfg, p, torch.from_numpy(x), use_kernel=use_kernel)
    assert_close(got, want, FP32_TOL)
    # and the port's two routes agree with each other
    other = ssd.ssd_forward(cfg, p, torch.from_numpy(x), use_kernel=not use_kernel)
    torch.testing.assert_close(got, other, rtol=FP32_TOL, atol=FP32_TOL)


def test_ssd_decode_matches(block):
    jcfg, cfg, jp, p, x = block
    jc = jssd.init_ssd_cache(jcfg, 2, jnp.float32)
    c = ssd.init_ssd_cache(cfg, 2, torch.float32, CPU)
    for t in range(6):
        xt = x[:, t : t + 1]
        jy, jc = jssd.ssd_decode(jcfg, jp, jnp.asarray(xt), jc)
        y, c = ssd.ssd_decode(cfg, p, torch.from_numpy(xt), c)
        assert_close(y, jy, FP32_TOL)
        for k in ("conv", "ssm"):
            assert_close(c[k], jc[k], FP32_TOL)
    # the recurrence and the chunked forward agree over the same prefix
    full = ssd.ssd_forward(cfg, p, torch.from_numpy(x[:, :6]))
    torch.testing.assert_close(y[:, 0], full[:, -1], rtol=FP32_TOL, atol=FP32_TOL)
