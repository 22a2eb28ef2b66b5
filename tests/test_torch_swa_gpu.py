"""The ``swa_attention`` Hopper kernel against its plain version, and what
its wrapper refuses.

This file imports torch only, so the ``cuda`` tests run on a machine with a
GPU and no JAX: ``python -m pytest --noconftest -q tests/test_torch_swa_gpu.py``.
Without a GPU they skip; the wrapper's refusals are checked on the CPU.
The kernel and ``kernels.ref.swa_attention_ref`` read the same fp32 or bf16
inputs and keep scores, m, l and sums in fp32, so they differ by summation
order (fp32: 2e-5).  The bf16 route (tensor cores) also rounds each
probability to bf16 before P V: it is held to ``tests/test_kernels.py``'s
0.05 and, element by element, to ``bf16_limit`` (that rounding's bound plus
a bf16 step of the output).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.swa_attention import bf16_limit  # noqa: E402
from repro_torch.kernels.swa_attention import swa_attention as swa_kernel  # noqa: E402

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
TOL = {"float32": 2e-5, "bfloat16": 0.05}


def swa_inputs(b, h, hkv, s, d, dtype=torch.float32, seed=0, strided=False):
    """Seeded standard-normal q (b, h, s, d) and k, v (b, hkv, s, d).
    ``strided`` makes them (B, H, S, D) views of (B, S, H, D) tensors, as
    the model passes its projections."""
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal((b, s, n, d), dtype=np.float32)).to(dtype) for n in (h, hkv, hkv))
    if strided:
        return q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    return q.transpose(1, 2).contiguous(), k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the Hopper kernels run only there")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize(
    "b,h,hkv,s,d",
    [
        (1, 2, 2, 128, 64),  # whole tiles
        (2, 4, 2, 200, 64),  # ragged last tile, GQA
        (1, 6, 2, 37, 32),  # S < 64: one partial tile
        (1, 3, 1, 1, 128),  # one row
        (2, 8, 2, 300, 128),  # StarCoder2's group of 12 cut to 4
        (1, 4, 4, 65, 32),  # one row past a tile
    ],
)
@pytest.mark.parametrize("window", [0, 5, 64, 100, 1000])  # < 64, a tile, > 64, > S
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("strided", [False, True])
def test_swa_kernel_on_gpu(b, h, hkv, s, d, window, causal, dtype, strided, cuda_device):
    q, k, v = (t.to(cuda_device) for t in swa_inputs(b, h, hkv, s, d, DTYPES[dtype], strided=strided))
    before = swa_kernel.launches
    o = swa_kernel(q, k, v, window=window, causal=causal)
    torch.cuda.synchronize()
    assert swa_kernel.launches == before + 1
    assert o.shape == q.shape and o.dtype == q.dtype
    want = ref.swa_attention_ref(q, k, v, window=window, causal=causal)
    torch.testing.assert_close(o.float(), want.float(), rtol=TOL[dtype], atol=TOL[dtype])
    if dtype == "bfloat16":
        assert_within_bf16_limit(o, want, q, k, v, window, causal)


def assert_within_bf16_limit(o, want, q, k, v, window, causal):
    diff = (o.float() - want.float()).abs()
    limit = bf16_limit(q, k, v, window=window, causal=causal, want=want)
    ratio = (diff / limit).max().item()
    assert ratio <= 1.0, f"bf16 route off the plain version by {ratio:.3f} of bf16_limit"


@pytest.mark.cuda
@pytest.mark.parametrize("s", [127, 128, 129, 255, 257])  # around the 128-row query and key tiles
@pytest.mark.parametrize("window", [127, 128, 129])
@pytest.mark.parametrize("h,hkv,d", [(12, 1, 128), (24, 2, 64), (2, 2, 32)])  # GQA group 12, 12, 1
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("strided", [False, True])
def test_swa_kernel_bf16_tile_edges(s, window, h, hkv, d, causal, strided, cuda_device):
    q, k, v = (t.to(cuda_device) for t in swa_inputs(1, h, hkv, s, d, torch.bfloat16, seed=s + window, strided=strided))
    before = swa_kernel.launches_tc
    o = swa_kernel(q, k, v, window=window, causal=causal)
    torch.cuda.synchronize()
    assert swa_kernel.launches_tc == before + 1
    want = ref.swa_attention_ref(q, k, v, window=window, causal=causal)
    torch.testing.assert_close(o.float(), want.float(), rtol=0.05, atol=0.05)
    assert_within_bf16_limit(o, want, q, k, v, window, causal)


@pytest.mark.cuda
def test_swa_kernel_routes_by_dtype(cuda_device):
    """bf16 inputs launch the tensor-core instance, fp32 inputs the FMA one."""
    counts = lambda: (swa_kernel.launches, swa_kernel.launches_tc, swa_kernel.launches_fma)  # noqa: E731
    q, k, v = (t.to(cuda_device) for t in swa_inputs(1, 4, 2, 200, 64, torch.bfloat16, strided=True))
    n, tc, fma = counts()
    swa_kernel(q, k, v, window=64)
    assert counts() == (n + 1, tc + 1, fma)
    swa_kernel(q.float(), k.float(), v.float(), window=64)
    assert counts() == (n + 2, tc + 1, fma + 1)


@pytest.mark.cuda
def test_ops_sends_cuda_tensors_to_the_kernel(cuda_device):
    q, k, v = (t.to(cuda_device) for t in swa_inputs(1, 4, 2, 90, 64))
    before = swa_kernel.launches
    o = ops.swa_attention(q, k, v, window=16)
    assert swa_kernel.launches == before + 1
    torch.testing.assert_close(o, ref.swa_attention_ref(q, k, v, window=16), rtol=2e-5, atol=2e-5)


def test_swa_kernel_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA device"):
        swa_kernel(*swa_inputs(1, 2, 1, 8, 32))


@pytest.mark.parametrize(
    "change,exc",
    [
        (lambda q, k, v: (q[0], k, v), ValueError),  # q not 4-D
        (lambda q, k, v: (q, k[:, :, :4], v[:, :, :4]), ValueError),  # k/v length differs from q's
        (lambda q, k, v: (q, k, v[..., :16]), ValueError),  # k and v differ
        (lambda q, k, v: (q[:, :3], k[:, :2], v[:, :2]), ValueError),  # 2 KV heads do not divide 3
        (lambda q, k, v: (q.half(), k.half(), v.half()), TypeError),  # fp16
        (lambda q, k, v: (q, k.bfloat16(), v), TypeError),  # mixed dtypes
        (lambda q, k, v: (q.double(), k.double(), v.double()), TypeError),  # fp64
        (lambda q, k, v: (q[..., :16], k[..., :16], v[..., :16]), ValueError),  # D=16: no instance
        (lambda q, k, v: (torch.cat([q, q[..., :16]], -1),) * 3, ValueError),  # D=48: no instance
        (lambda q, k, v: (q.requires_grad_(), k, v), ValueError),  # grad
    ],
)
def test_swa_kernel_rejects_bad_input(change, exc):
    with pytest.raises(exc):
        swa_kernel(*change(*swa_inputs(1, 4, 2, 8, 32)))


def test_swa_kernel_rejects_bad_window():
    with pytest.raises(ValueError, match="window"):
        swa_kernel(*swa_inputs(1, 2, 1, 8, 32), window=-1)


def test_ops_swa_attention_rejects_mixed_devices():
    q, k, v = swa_inputs(1, 2, 1, 8, 32)
    with pytest.raises(ValueError, match="devices"):
        ops.swa_attention(q, k.to("meta"), v)


def test_ops_swa_attention_on_cpu_is_the_plain_version():
    q, k, v = swa_inputs(2, 4, 2, 20, 32, strided=True)
    before = swa_kernel.launches
    o = ops.swa_attention(q, k, v, window=6)
    assert swa_kernel.launches == before
    assert torch.equal(o, ref.swa_attention_ref(q, k, v, window=6))
