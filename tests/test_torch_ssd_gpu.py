"""The ``ssd_scan`` Hopper kernel against its plain version, and what its
wrapper refuses.

This file imports torch only, so the ``cuda`` tests run on a machine with a
GPU and no JAX: ``python -m pytest --noconftest -q tests/test_torch_ssd_gpu.py``.
Without a GPU they skip; the wrapper's refusals are checked on the CPU.
fp32 inputs run the FMA route, which like ``kernels.ref.ssd_scan_ref`` (the
exact recurrence) reads the inputs as they are and sums in fp32, so the two
differ only by the order of their sums: 1e-4 absolute and relative.  bf16
inputs run the tensor-core route, which also rounds P, X∘w and the state's
copy to bf16: each element is held to ``ssd_bf16_limit``, derived from
those roundings, and a plain version without the state's decay across
chunks must fail that limit.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_bf16_limit  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_scan as ssd_kernel  # noqa: E402
from repro_torch.models.ssd import ssd_chunked  # noqa: E402

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
TOL = 1e-4


def ssd_inputs(b, s, nh, hp, ds, dtype=torch.float32, seed=0, strided=False, decay=1.0):
    """Seeded inputs in ``ssd_forward``'s value ranges.  ``strided`` makes
    x, B and C slices of one (B, S, nh·hp + 2·ds) tensor, as in the model;
    ``decay`` < 1 scales A down so that the state carries across chunks."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((b, s, nh, hp), dtype=np.float32) * 0.5)
    dt = torch.nn.functional.softplus(torch.from_numpy(rng.standard_normal((b, s, nh), dtype=np.float32)))
    A = -torch.exp(torch.from_numpy(rng.standard_normal(nh, dtype=np.float32) * 0.3)) * decay
    Bm = torch.from_numpy(rng.standard_normal((b, s, ds), dtype=np.float32) * 0.5)
    Cm = torch.from_numpy(rng.standard_normal((b, s, ds), dtype=np.float32) * 0.5)
    if strided:
        xbc = torch.cat([x.reshape(b, s, nh * hp), Bm, Cm], dim=-1).to(dtype)
        x = xbc[..., : nh * hp].reshape(b, s, nh, hp)
        Bm, Cm = xbc[..., nh * hp : nh * hp + ds], xbc[..., nh * hp + ds :]
        return x, dt, A, Bm, Cm
    return x.to(dtype), dt, A, Bm.to(dtype), Cm.to(dtype)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the Hopper kernels run only there")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize(
    "b,s,nh,hp,ds,chunk",
    [
        (2, 256, 4, 64, 128, 64),  # whole chunks
        (1, 300, 3, 64, 128, 256),  # ragged last chunk, S > chunk
        (2, 300, 2, 32, 16, 64),  # reduced widths, ragged
        (1, 50, 2, 32, 16, 256),  # S < chunk: L = S
        (2, 64, 2, 64, 128, 256),
        (1, 1, 2, 64, 16, 64),  # one row
        (1, 600, 2, 32, 16, 300),  # a chunk longer than the 256-thread scan
    ],
)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("strided", [False, True])
@pytest.mark.parametrize("decay", [1.0, 0.01])
def test_ssd_kernel_on_gpu(b, s, nh, hp, ds, chunk, dtype, strided, decay, cuda_device):
    inputs = [t.to(cuda_device) for t in ssd_inputs(b, s, nh, hp, ds, DTYPES[dtype], strided=strided, decay=decay)]
    route = "launches_tc" if dtype == "bfloat16" else "launches_fma"
    before = ssd_kernel.launches, getattr(ssd_kernel, route)
    y, state = ssd_kernel(*inputs, chunk=chunk)
    torch.cuda.synchronize()
    assert (ssd_kernel.launches, getattr(ssd_kernel, route)) == (before[0] + 1, before[1] + 1)
    ry, rstate = ref.ssd_scan_ref(*inputs)
    if dtype == "float32":
        torch.testing.assert_close(y, ry, rtol=TOL, atol=TOL)
        torch.testing.assert_close(state, rstate, rtol=TOL, atol=TOL)
    else:
        assert max(limit_ratios((y, state), (ry, rstate), inputs)) <= 1.0


def limit_ratios(got, want, inputs):
    """max over elements of |got - want| / ssd_bf16_limit, for y and state."""
    return [((g - w).abs() / lim).max().item() for g, w, lim in zip(got, want, ssd_bf16_limit(*inputs, *want))]


def no_decay_across_chunks(x, dt, A, Bm, Cm, chunk):
    """The plain chunked form with the state's decay across chunk edges
    dropped: S_c = S_{c-1} + (chunk c's update).  A wrong kernel."""
    b, s = x.shape[:2]
    state = torch.zeros(b, x.shape[2], x.shape[3], Bm.shape[-1], device=x.device)
    ys = []
    for c0 in range(0, s, chunk):
        part = [t[:, c0 : c0 + chunk] for t in (x, dt)] + [A] + [t[:, c0 : c0 + chunk] for t in (Bm, Cm)]
        ys.append(ssd_chunked(*part, chunk, init_state=state)[0])
        state = state + ssd_chunked(*part, chunk)[1]
    return torch.cat(ys, dim=1), state


@pytest.mark.cuda
def test_bf16_limit_catches_a_missing_decay_across_chunks(cuda_device):
    inputs = [t.to(cuda_device) for t in ssd_inputs(2, 600, 3, 64, 128, torch.bfloat16, strided=True, decay=0.01)]
    want = ref.ssd_scan_ref(*inputs)
    assert max(limit_ratios(ssd_kernel(*inputs, chunk=256), want, inputs)) <= 1.0
    assert max(limit_ratios(no_decay_across_chunks(*inputs, 256), want, inputs)) > 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_routes_by_dtype(dtype, cuda_device):
    """bf16 runs the tensor-core route, fp32 the FMA route; ops counts both."""
    inputs = [t.to(cuda_device) for t in ssd_inputs(1, 70, 2, 64, 128, DTYPES[dtype])]
    counts = lambda: (ssd_kernel.launches, ssd_kernel.launches_tc, ssd_kernel.launches_fma)  # noqa: E731
    before = counts()
    ops.ssd_scan(*inputs, chunk=64)
    tc = int(dtype == "bfloat16")
    assert counts() == (before[0] + 1, before[1] + tc, before[2] + 1 - tc)
    assert ops.route_launch_counts()["ssd_scan"] == {"launches_tc": counts()[1], "launches_fma": counts()[2]}


@pytest.mark.cuda
def test_ops_sends_cuda_tensors_to_the_kernel(cuda_device):
    inputs = [t.to(cuda_device) for t in ssd_inputs(1, 40, 2, 32, 16)]
    before = ssd_kernel.launches
    y, _ = ops.ssd_scan(*inputs, chunk=16)
    assert ssd_kernel.launches == before + 1
    torch.testing.assert_close(y, ref.ssd_scan_ref(*inputs)[0], rtol=TOL, atol=TOL)


def test_ssd_kernel_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA device"):
        ssd_kernel(*ssd_inputs(1, 8, 2, 32, 16), chunk=4)


@pytest.mark.parametrize(
    "change,exc",
    [
        (lambda x, dt, A, B, C: (x[..., 0], dt, A, B, C), ValueError),  # x not 4-D
        (lambda x, dt, A, B, C: (x, dt[:, :-1], A, B, C), ValueError),  # dt shape
        (lambda x, dt, A, B, C: (x, dt, A[:1], B, C), ValueError),  # A shape
        (lambda x, dt, A, B, C: (x, dt, A, B, C[..., :8]), ValueError),  # C shape
        (lambda x, dt, A, B, C: (x.half(), dt, A, B.half(), C.half()), TypeError),  # fp16
        (lambda x, dt, A, B, C: (x, dt, A, B.bfloat16(), C), TypeError),  # mixed x/B dtypes
        (lambda x, dt, A, B, C: (x, dt.double(), A, B, C), TypeError),  # dt not fp32
        (lambda x, dt, A, B, C: (x[..., :16], dt, A, B, C), ValueError),  # hp=16: no instance
        (lambda x, dt, A, B, C: (x, dt, A, B[..., :8], C[..., :8]), ValueError),  # ds=8: no instance
        (lambda x, dt, A, B, C: (x.requires_grad_(), dt, A, B, C), ValueError),  # grad
    ],
)
def test_ssd_kernel_rejects_bad_input(change, exc):
    with pytest.raises(exc):
        ssd_kernel(*change(*ssd_inputs(1, 8, 2, 32, 16)), chunk=4)


def test_ssd_kernel_rejects_bad_chunk():
    with pytest.raises(ValueError, match="chunk"):
        ssd_kernel(*ssd_inputs(1, 8, 2, 32, 16), chunk=0)


def test_ops_ssd_scan_rejects_mixed_devices():
    x, dt, A, Bm, Cm = ssd_inputs(1, 8, 2, 32, 16)
    with pytest.raises(ValueError, match="devices"):
        ops.ssd_scan(x, dt, A.to("meta"), Bm, Cm)


def test_ops_ssd_scan_on_cpu_is_the_plain_version():
    inputs = ssd_inputs(2, 20, 2, 32, 16)
    before = ssd_kernel.launches
    y, state = ops.ssd_scan(*inputs, chunk=8)
    assert ssd_kernel.launches == before
    ry, rstate = ref.ssd_scan_ref(*inputs)
    assert torch.equal(y, ry) and torch.equal(state, rstate)
