"""The port's kernels against the JAX package's.

On the CPU the port's kernel entry points (``repro_torch.kernels.ops``) run
the plain versions; they are held to ``repro.kernels.ref`` and to the Pallas
kernels in interpret mode over ``tests/test_kernels.py``'s shape x dtype
sweeps and padding shapes, at its tolerances (fp32 1e-5; bf16 0.2 for
vaoi_distance and 0.05 for fedavg_reduce, where the two sides round the
bf16 inputs identically but sum in another order).  The Hopper kernels
themselves run only on a GPU (tests marked ``cuda``); here the wrappers are
checked to raise, never to fall back, on what they do not take.
"""
import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import vaoi_distance as kv  # noqa: E402
from repro_torch.kernels.fedavg_reduce import fedavg_reduce as fedavg_kernel  # noqa: E402
from repro_torch.kernels.vaoi_distance import vaoi_distance as vaoi_kernel  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def to_torch(x, dtype=None):
    """A JAX array as a torch tensor with the same bits (bf16 via a uint16 view)."""
    a = np.asarray(x)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.view(np.uint16).view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy()) if dtype is None else torch.from_numpy(a.copy()).to(dtype)


def vaoi_inputs(n, f, dtype, seed=0):
    ks = jax.random.split(jax.random.PRNGKey(seed), 4)
    v = jax.random.normal(ks[0], (n, f), dtype)
    h = jax.random.normal(ks[1], (n, f), dtype)
    age = jax.random.randint(ks[2], (n,), 0, 7).astype(jnp.float32)
    q = (jax.random.uniform(ks[3], (n,)) < 0.3).astype(jnp.float32)
    return v, h, age, q


def check_vaoi(n, f, jdtype, tol, mu=0.5, pallas=True, **pallas_kw):
    v, h, age, q = vaoi_inputs(n, f, jdtype)
    m, a = ops.vaoi_distance(to_torch(v), to_torch(h), to_torch(age), to_torch(q), mu)
    assert m.dtype == a.dtype == torch.float32 and m.shape == a.shape == (n,)
    wants = [jref.vaoi_distance_ref(v, h, age, q, mu)]
    if pallas:
        wants.append(jops.vaoi_distance(v, h, age, q, mu, **pallas_kw))
    for want_m, want_a in wants:
        np.testing.assert_allclose(m.numpy(), np.asarray(want_m), rtol=tol, atol=tol)
        np.testing.assert_allclose(a.numpy(), np.asarray(want_a), rtol=tol, atol=tol)


def check_fedavg(k, p, jdtype, tol, normalize=True, **pallas_kw):
    msgs = jax.random.normal(jax.random.PRNGKey(0), (k, p), jdtype)
    w = jax.random.uniform(jax.random.PRNGKey(1), (k,))
    if normalize:
        w = w / w.sum()
    out = ops.fedavg_reduce(to_torch(msgs), to_torch(w))
    assert out.dtype == torch.float32 and out.shape == (p,)
    for want in (jref.fedavg_reduce_ref(msgs, w), jops.fedavg_reduce(msgs, w, **pallas_kw)):
        np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("n,f", [(10, 10), (100, 10), (128, 512), (257, 300), (33, 1025)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vaoi_distance_sweep(n, f, dtype):
    check_vaoi(n, f, DTYPES[dtype][0], 1e-5 if dtype == "float32" else 0.2)


@pytest.mark.parametrize("n,f,bn,bf", [(100, 130, 32, 64), (10, 700, 8, 512), (33, 33, 32, 32), (5, 1025, 128, 512)])
def test_vaoi_distance_padding_shapes(n, f, bn, bf):
    check_vaoi(n, f, jnp.float32, 1e-5, mu=0.7, block_n=bn, block_f=bf)


# the cluster route's shapes: one row over 16 segments, odd F (rows off
# 16-byte alignment), a row just past 2^13; an LM's (8, 151,936) runs on the card
@pytest.mark.parametrize("n,f", [(1, 151_936), (3, 40_001), (2, 8193)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vaoi_distance_wide(n, f, dtype):
    check_vaoi(n, f, DTYPES[dtype][0], 1e-5 if dtype == "float32" else 0.2, pallas=False)


def test_vaoi_distance_wide_pallas():
    """A moderate wide shape through the Pallas kernel in interpret mode too
    (odd F, the last F block ragged)."""
    check_vaoi(3, 4099, jnp.float32, 1e-5, mu=0.7, block_n=8, block_f=1024)


@pytest.mark.parametrize("elt", [2, 4])
@pytest.mark.parametrize("sms", [1, 8, 132])
def test_vaoi_split_plan(elt, sms):
    """split_plan's segment counts: 1 for F <= 32 (the thread route's grid
    follows from N alone), else S of SEGMENTS, the most that keeps N·S
    within half the SMs and each segment MIN_VECS 16-byte vectors a thread.
    That the segments partition each row, with inner boundaries on 16-byte
    vectors, is held on the card: every S against the plain version on rows
    off alignment (tests/test_torch_vaoi_gpu.py)."""
    least = kv.CLUSTER_THREADS * kv.MIN_VECS
    counts = set()
    for n in (1, 2, 3, 4, 8, 16, 33, 66, 67, 100, 1024, 100_000):
        for f in (1, 10, 32, 33, 64, 255, 1025, 4096, 4097, 8193, 40_001, 102_400, 151_936):
            s = kv.split_plan(n, f, elt, sms)
            counts.add(s)
            assert s in kv.SEGMENTS
            if f <= kv.MAX_ROW_F:
                assert s == 1
                continue
            row_vecs = -(-f * elt // 16)
            assert s == 1 or (2 * n * s <= sms and -(-row_vecs // s) >= least)
            room = 2 * n * 2 * s <= sms and -(-row_vecs // (2 * s)) >= least
            assert s == kv.SEGMENTS[-1] or not room  # no more segments would fit
    assert counts == ({1} if sms < 8 else set(kv.SEGMENTS) if sms == 132 else {1, 2, 4})


def test_vaoi_plan_shapes():
    """The segments at the LM and bench shapes on an H100's 132 SMs."""
    assert kv.split_plan(100, 10, 4, 132) == 1  # the EHFL main path, the thread route
    assert kv.split_plan(8, 151_936, 4, 132) == 8  # phase 12's qwen1.5 features
    assert kv.split_plan(4, 102_400, 4, 132) == 16  # phase 13's deepseek-moe features
    assert kv.split_plan(1024, 4096, 4, 132) == 1  # the kernels bench
    assert kv.split_plan(16_384, 256, 4, 132) == 1


def test_vaoi_args_layout_matches_the_launcher():
    """The wrapper's parameter block covers the C side's VaoiArgs up to its
    last field."""
    src = (Path(kv.__file__).resolve().parent.parent / "csrc" / "vaoi_distance.cu").read_text()
    size = int(re.search(r"offsetof\(VaoiArgs, segments\) \+ sizeof\(int\) == (\d+)", src).group(1))
    assert kv._ARGS.size == size == 7 * 8 + 4 + 4 * 4


@pytest.mark.parametrize("k,p", [(1, 128), (10, 1000), (100, 4096), (7, 333), (64, 2048)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fedavg_reduce_sweep(k, p, dtype):
    check_fedavg(k, p, DTYPES[dtype][0], 1e-5 if dtype == "float32" else 0.05)


@pytest.mark.parametrize("k,p,bk,bp", [(5, 77, 4, 32), (13, 100, 8, 64), (3, 2049, 64, 2048), (65, 5, 64, 8)])
def test_fedavg_reduce_padding_shapes(k, p, bk, bp):
    check_fedavg(k, p, jnp.float32, 1e-5, normalize=False, block_k=bk, block_p=bp)


def test_fedavg_reduce_zero_weight_rows_propagate_nan():
    """0·Inf = NaN in the reference; the port must not skip zero-weight rows."""
    msgs = torch.ones(3, 4)
    msgs[1, 2] = float("inf")
    out = ops.fedavg_reduce(msgs, torch.tensor([0.5, 0.0, 0.5]))
    want = jref.fedavg_reduce_ref(jnp.asarray(msgs.numpy()), jnp.asarray([0.5, 0.0, 0.5]))
    np.testing.assert_array_equal(out.numpy(), np.asarray(want))
    assert torch.isnan(out[2])


def test_kernel_wrappers_raise_on_cpu_tensors():
    """The CUDA wrappers never fall back to the plain version."""
    v, h = torch.zeros(4, 3), torch.zeros(4, 3)
    age, q = torch.zeros(4), torch.zeros(4)
    before = (vaoi_kernel.launches, fedavg_kernel.launches)
    with pytest.raises(ValueError, match="CUDA"):
        vaoi_kernel(v, h, age, q, 0.5)
    with pytest.raises(ValueError, match="CUDA"):
        fedavg_kernel(torch.zeros(2, 5), torch.zeros(2))
    assert (vaoi_kernel.launches, fedavg_kernel.launches) == before


@pytest.mark.parametrize(
    "args, exc",
    [
        ((torch.zeros(4, 3), torch.zeros(4, 2), torch.zeros(4), torch.zeros(4)), ValueError),  # shape
        ((torch.zeros(4, 3, dtype=torch.float64),) * 2 + (torch.zeros(4), torch.zeros(4)), TypeError),
        ((torch.zeros(4, 3), torch.zeros(4, 3, dtype=torch.bfloat16), torch.zeros(4), torch.zeros(4)), TypeError),
        ((torch.zeros(4, 3), torch.zeros(4, 3), torch.zeros(5), torch.zeros(4)), ValueError),
        ((torch.zeros(4, 3), torch.zeros(4, 3), torch.zeros(4), torch.zeros(4, dtype=torch.int32)), ValueError),
        ((torch.zeros(3, 4).t(), torch.zeros(4, 3), torch.zeros(4), torch.zeros(4)), ValueError),  # layout
    ],
    ids=["shape", "dtype", "mixed_dtype", "age_len", "q_dtype", "noncontiguous"],
)
def test_vaoi_kernel_rejects_bad_input(args, exc):
    with pytest.raises(exc):
        vaoi_kernel(*args, 0.5)


@pytest.mark.parametrize(
    "args, exc",
    [
        ((torch.zeros(5), torch.zeros(5)), ValueError),  # 1-D msgs
        ((torch.zeros(2, 5, dtype=torch.float16), torch.zeros(2)), TypeError),
        ((torch.zeros(2, 5), torch.zeros(3)), ValueError),
        ((torch.zeros(2, 5), torch.zeros(2, dtype=torch.float64)), ValueError),
        ((torch.zeros(5, 2).t(), torch.zeros(2)), ValueError),  # layout
    ],
    ids=["ndim", "dtype", "weights_len", "weights_dtype", "noncontiguous"],
)
def test_fedavg_kernel_rejects_bad_input(args, exc):
    with pytest.raises(exc):
        fedavg_kernel(*args)


def test_ops_rejects_mixed_devices():
    meta = torch.zeros(4, device="meta")
    with pytest.raises(ValueError, match="devices"):
        ops.vaoi_distance(torch.zeros(4, 3), torch.zeros(4, 3), meta, torch.zeros(4), 0.5)
    with pytest.raises(ValueError, match="devices"):
        ops.fedavg_reduce(torch.zeros(4, 3), meta)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the Hopper kernels run only there")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n,f", [(100, 10), (257, 300), (33, 1025), (8, 151_936), (4, 102_400), (1024, 4096),
                                 (1, 151_936), (3, 40_001), (2, 8193), (100, 33)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vaoi_kernel_on_gpu(n, f, dtype, cuda_device):
    v, h, age, q = (to_torch(x).to(cuda_device) for x in vaoi_inputs(n, f, DTYPES[dtype][0]))
    before = vaoi_kernel.launches
    m, a = vaoi_kernel(v, h, age, q, 0.5)
    torch.cuda.synchronize()
    assert vaoi_kernel.launches == before + 1
    rm, ra = ref.vaoi_distance_ref(v, h, age, q, 0.5)
    tol = 1e-5 if dtype == "float32" else 0.2
    torch.testing.assert_close(m, rm, rtol=tol, atol=tol)
    torch.testing.assert_close(a, ra, rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("k,p", [(10, 1000), (100, 4096), (7, 333), (65, 5)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fedavg_kernel_on_gpu(k, p, dtype, cuda_device):
    g = torch.Generator().manual_seed(0)
    msgs = torch.randn(k, p, generator=g).to(DTYPES[dtype][1]).to(cuda_device)
    w = torch.rand(k, generator=g).to(cuda_device)
    before = fedavg_kernel.launches
    out = fedavg_kernel(msgs, w / w.sum())
    torch.cuda.synchronize()
    assert fedavg_kernel.launches == before + 1
    tol = 1e-5 if dtype == "float32" else 0.05
    torch.testing.assert_close(out, ref.fedavg_reduce_ref(msgs, w / w.sum()), rtol=tol, atol=tol)
