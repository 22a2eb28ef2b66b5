"""The ``ssd_scan`` Hopper kernel against its plain version, and what its
wrapper refuses.

This file imports torch only, so the ``cuda`` tests run on a machine with a
GPU and no JAX: ``python -m pytest --noconftest -q tests/test_torch_ssd_gpu.py``.
Without a GPU they skip; the wrapper's refusals are checked on the CPU.
The kernel and ``kernels.ref.ssd_scan_ref`` (the exact recurrence) read the
same fp32 or bf16 inputs and both accumulate in fp32, so they differ only by
the order of their sums: 1e-4 absolute and relative.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_scan as ssd_kernel  # noqa: E402

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
    before = ssd_kernel.launches
    y, state = ssd_kernel(*inputs, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd_kernel.launches == before + 1
    ry, rstate = ref.ssd_scan_ref(*inputs)
    torch.testing.assert_close(y, ry, rtol=TOL, atol=TOL)
    torch.testing.assert_close(state, rstate, rtol=TOL, atol=TOL)


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
