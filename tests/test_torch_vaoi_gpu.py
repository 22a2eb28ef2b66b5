"""The ``vaoi_distance`` Hopper kernel's wide route against its plain
version, on the card.

This file imports torch only, so the ``cuda`` tests run on a machine with a
GPU and no JAX: ``python -m pytest --noconftest -q tests/test_torch_vaoi_gpu.py``.
Without a GPU they skip.  The kernel and ``kernels.ref.vaoi_distance_ref``
read the same fp32 or bf16 values into fp32 and differ by the order of the
sum over F: m within ``tests/test_kernels.py``'s 1e-5 (fp32) and 0.2
(bf16).  mu lies between the rows' m (:func:`mu_between`), so rows take
both branches of Eq. 7 and the ages are compared exactly.  The cluster
route adds a row's partials in rank order, so two calls on the same inputs
give the same bits.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import vaoi_distance as kv  # noqa: E402

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
TOL = {"float32": 1e-5, "bfloat16": 0.2}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the Hopper kernels run only there")
    return torch.device("cuda")


def vaoi_inputs(n, f, dtype, dev, offsets=(0, 0), seed=0):
    """Seeded v, h (each ``offsets`` elements into its storage), age, q."""
    g = torch.Generator().manual_seed(seed)

    def at(off):
        x = torch.empty(n * f + off, dtype=dtype, device=dev)[off:].view(n, f)
        return x.copy_(torch.randn(n, f, generator=g).to(dtype))

    v, h = at(offsets[0]), at(offsets[1])
    age = torch.randint(0, 9, (n,), generator=g).float().to(dev)
    return v, h, age, (torch.rand(n, generator=g) < 0.4).float().to(dev)


def mu_between(m) -> float:
    """A threshold inside the widest gap between neighbouring m in the
    middle half of the rows, so that about half the rows reach it and the
    kernel's m and the plain version's fall on the same side of it; half
    the one m of a single row."""
    m = torch.sort(m.float().cpu()).values
    n = m.numel()
    if n == 1:
        return 0.5 * m[0].item()
    lo, hi = max(1, n // 4), max(2, -(-3 * n // 4))
    k = lo + int(torch.argmax(m[lo:hi] - m[lo - 1:hi - 1]))
    return 0.5 * (m[k - 1] + m[k]).item()


def split_mu(v, h):
    """mu_between the rows' m, checked to split them where there are two."""
    m = ref.vaoi_distance_ref(v, h, torch.zeros(len(v), device=v.device), torch.zeros(len(v), device=v.device),
                              0.0)[0]
    mu = mu_between(m)
    assert len(v) == 1 or ((m >= mu).any() and (m < mu).any())
    return mu


def check(got, v, h, age, q, dtype, mu):
    rm, ra = ref.vaoi_distance_ref(v, h, age, q, mu)
    torch.testing.assert_close(got[0], rm, rtol=TOL[dtype], atol=TOL[dtype])
    assert torch.equal(got[1], ra)


@pytest.mark.cuda
@pytest.mark.parametrize("n,f", [(8, 151_936), (4, 102_400), (1024, 4096), (1, 151_936), (3, 40_001),
                                 (20, 16_384), (8, 16_384), (2, 8193), (33, 1025), (100, 33), (100, 130)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vaoi_wide_on_gpu(n, f, dtype, cuda_device):
    """Every segment count split_plan gives on this card: one launch a
    call, the plain version's values, the same bits twice."""
    v, h, age, q = vaoi_inputs(n, f, DTYPES[dtype], cuda_device)
    mu = split_mu(v, h)
    before = kv.vaoi_distance.launches
    got = kv.vaoi_distance(v, h, age, q, mu)
    again = kv.vaoi_distance(v, h, age, q, mu)
    torch.cuda.synchronize()
    assert kv.vaoi_distance.launches == before + 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    check(got, v, h, age, q, dtype, mu)


@pytest.mark.cuda
@pytest.mark.parametrize("n,f", [(8, 151_936), (3, 40_001), (33, 1025), (100, 33)])
@pytest.mark.parametrize("offsets", [(1, 1), (1, 0), (0, 3)], ids=["both", "v", "h"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vaoi_misaligned_on_gpu(n, f, offsets, dtype, cuda_device):
    """v and h one or three elements into their storage: a scalar head and
    tail around the 16-byte body where both sit alike, scalar loads where
    they do not; two calls give the same bits."""
    v, h, age, q = vaoi_inputs(n, f, DTYPES[dtype], cuda_device, offsets)
    mu = split_mu(v, h)
    got = kv.vaoi_distance(v, h, age, q, mu)
    again = kv.vaoi_distance(v, h, age, q, mu)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    check(got, v, h, age, q, dtype, mu)


def launch(segments, v, h, age, q, mu, name="vaoi_distance_launch"):
    """The C launcher on ``segments``: (error, m, new_age)."""
    m, a = torch.empty_like(age), torch.empty_like(age)
    err = kv._launcher(name)(kv._ARGS.pack(
        v.data_ptr(), h.data_ptr(), age.data_ptr(), q.data_ptr(), m.data_ptr(), a.data_ptr(),
        torch.cuda.current_stream().cuda_stream, mu, *v.shape, v.dtype == torch.bfloat16, segments))
    return err, m, a


@pytest.mark.cuda
@pytest.mark.parametrize("offsets", [(1, 1), (1, 0)], ids=["both", "v"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vaoi_every_plan_on_gpu(offsets, dtype, cuda_device):
    """Every segment count the launcher takes computes the same function on
    rows off 16-byte alignment: S = 1 to 16 partition each row exactly once
    (a lost or doubled element would move m past the tolerance), where v and
    h sit alike (16-byte body) and where they do not (scalar loads)."""
    n, f = 8, 40_001
    v, h, age, q = vaoi_inputs(n, f, DTYPES[dtype], cuda_device, offsets)
    mu = split_mu(v, h)
    for segments in kv.SEGMENTS:
        err, m, a = launch(segments, v, h, age, q, mu)
        torch.cuda.synchronize()
        assert err == 0, segments
        check((m, a), v, h, age, q, dtype, mu)


@pytest.mark.cuda
@pytest.mark.parametrize("n,f,segments", [(3, 40_001, 3), (3, 40_001, 32), (3, 40_001, 0), (100, 10, 2)],
                         ids=["S3", "S32", "S0", "thread_S2"])
def test_vaoi_refuses_bad_plans_on_gpu(n, f, segments, cuda_device, monkeypatch):
    """A segment count the kernels do not take (not a cluster size of
    sm_90, or above 1 on the thread route) is an error from both launchers,
    and the wrapper raises on it without counting a launch: no fallback."""
    v, h, age, q = vaoi_inputs(n, f, torch.float32, cuda_device)
    for name in ("vaoi_distance_launch", "vaoi_empty_launch"):
        assert launch(segments, v, h, age, q, 0.7, name)[0] != 0
    monkeypatch.setattr(kv, "split_plan", lambda *args: segments)
    before = kv.vaoi_distance.launches
    with pytest.raises(RuntimeError, match="launch failed"):
        kv.vaoi_distance(v, h, age, q, 0.7)
    assert kv.vaoi_distance.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("n,f", [(100, 10), (16_384, 256), (8, 151_936), (4, 102_400)])
def test_vaoi_launch_floor_on_gpu(n, f, cuda_device):
    """The launch floor takes the same plan (the thread route, the cluster
    route at S = 1, 8 and 16) and launches without error."""
    v, h, age, q = vaoi_inputs(n, f, torch.float32, cuda_device)
    before = kv.launch_floor.launches
    kv.launch_floor(v, h, age, q, 0.7)
    torch.cuda.synchronize()
    assert kv.launch_floor.launches == before + 1
    segments = kv.split_plan(n, f, 4, kv.sm_count(v.get_device()))
    assert launch(segments, v, h, age, q, 0.7, "vaoi_empty_launch")[0] == 0
