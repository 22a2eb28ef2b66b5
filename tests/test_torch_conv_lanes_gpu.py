"""The ``conv_lanes`` Hopper kernel against its plain version, on the card.

This file imports torch only, so the ``cuda`` tests run on a machine with a
GPU and no JAX: ``python -m pytest --noconftest -q tests/test_torch_conv_lanes_gpu.py``.
Without a GPU they skip.  Each direction is held to its plain version (the
grouped convolution that vmap makes of ``F.conv2d``) run in float64, within
1e-5 of the largest output: on an H100 the kernel's strict fp32 sums read
at most 1.6e-6 of it at the paper's shapes, cuDNN's own fp32 grouped call up
to 2.1e-5 (the weight gradient's 15,360-term sums at conv1), and cuDNN in
TF32 2e-4 to 9e-4, so a kernel on the tensor cores' TF32 path would fail.
"""
import pytest

torch = pytest.importorskip("torch")

from torch.func import vmap  # noqa: E402

from repro_torch.configs.cifar_cnn import CONFIG, CNNConfig  # noqa: E402
from repro_torch.fl.backend import cnn_backend  # noqa: E402
from repro_torch.kernels import conv_lanes as kconv  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.models import cnn  # noqa: E402

B = 15  # images a lane and SGD step at the paper's settings (300 samples, kappa 20)
# (cin, cout, spatial) of the paper CNN's six convolutions
PAPER = [(3, 32, 32), (32, 32, 32), (32, 64, 16), (64, 64, 16), (64, 128, 8), (128, 128, 8)]
# ragged shapes: channels that are no multiple of 4 or of a tile, odd widths, one image, 2x2 images,
# more output channels than one tile
RAGGED = [(3, 5, 3, 4, 8), (2, 3, 4, 8, 16), (3, 7, 8, 8, 4), (2, 1, 2, 2, 2), (5, 3, 6, 10, 12),
          (2, 2, 160, 136, 8), (4, 3, 33, 65, 6)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the Hopper kernels run only there")
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False  # the plain version in strict fp32
    yield torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = tf32


def inputs(lanes, batch, cin, cout, size, dev, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(lanes, batch, size, size, cin, generator=g).to(dev).permute(0, 1, 4, 2, 3)  # NHWC memory
    w = (torch.randn(lanes, cout, cin, 3, 3, generator=g) / (3 * cin**0.5)).to(dev)
    b = torch.randn(lanes, cout, generator=g).to(dev)
    dy = torch.randn(lanes, batch, cout, size, size, generator=g).to(dev)  # NCHW memory: the wrapper copies
    return x, w, b, dy


def close(got, exact):
    """Within 1e-5 of the largest value of the float64 result."""
    err = (got.double() - exact).abs().max().item()
    assert err <= 1e-5 * exact.abs().max().item(), (err, exact.abs().max().item())


def check_directions(lanes, batch, cin, cout, size, dev):
    x, w, b, dy = inputs(lanes, batch, cin, cout, size, dev)
    before = {d: getattr(kconv.conv_lanes, f"launches_{d}") for d in kconv.DIRECTIONS}
    y = kconv.forward(x, w, b)
    dx = kconv.input_grad(dy, w)
    dw, db = kconv.weight_grad(dy, x)
    torch.cuda.synchronize()
    assert {d: getattr(kconv.conv_lanes, f"launches_{d}") - before[d] for d in kconv.DIRECTIONS} == dict.fromkeys(
        kconv.DIRECTIONS, 1)
    x64, w64, b64, dy64 = x.double(), w.double(), b.double(), dy.double()
    close(y, ref.conv_lanes_ref(x64, w64, b64))
    close(dx, ref.conv_lanes_input_grad_ref(dy64, x64, w64))
    rw, rb = ref.conv_lanes_weight_grad_ref(dy64, x64, w64)
    close(dw, rw)
    close(db, rb)
    # the split weight gradient adds its partials in rank order: the same bits again
    dw2, db2 = kconv.weight_grad(dy, x)
    assert torch.equal(dw, dw2) and torch.equal(db, db2)


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [100, 10, 1])
@pytest.mark.parametrize("layer", range(len(PAPER)))
def test_conv_lanes_at_paper_shapes(layer, lanes, cuda_device):
    check_directions(lanes, B, *PAPER[layer], cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", RAGGED, ids=[f"L{s[0]}-B{s[1]}-{s[2]}to{s[3]}-{s[4]}px" for s in RAGGED])
def test_conv_lanes_at_ragged_shapes(shape, cuda_device):
    check_directions(*shape, cuda_device)


@pytest.mark.cuda
def test_conv_lanes_takes_unbatched_bias_and_shared_input(cuda_device):
    """A lane stride of 0: one input for every lane; and no bias."""
    x, w, _, _ = inputs(4, 3, 8, 16, 8, cuda_device)
    shared = x[:1].expand_as(x)
    close(kconv.forward(shared, w, None), ref.conv_lanes_ref(shared.double(), w.double(), None))


def near(got, want):
    """Per lane, each gradient leaf's gap over its norm: the median over the
    lanes within 1e-4 and every lane within 1e-2.  One SGD step through the
    kernel and through cuDNN in fp32 differ by rounding carried through the
    network (about 1e-6); now and then a rounding-sized difference flips a
    ReLU or max-pool choice in one lane and moves that lane further; TF32
    moves every lane by about 1e-3."""
    diff = torch.linalg.vector_norm((got - want).flatten(1), dim=1)
    norm = torch.linalg.vector_norm(want.flatten(1), dim=1)
    gap = torch.where(norm > 0, diff / norm, diff)  # a leaf with no gradient in a lane must read 0 there too
    return bool(gap.median() <= 1e-4 and gap.max() <= 1e-2), gap.tolist()


def paper_world(lanes, dev, seed=1):
    g = torch.Generator().manual_seed(seed)
    p = cnn.init_params(CONFIG, g, torch.device("cpu"))
    p = {k: (v + 0.01 * torch.randn((lanes,) + v.shape, generator=g)).to(dev) for k, v in p.items()}
    x = torch.rand(lanes, B, 32, 32, 3, generator=g).to(dev)
    y = torch.randint(0, 10, (lanes, B), generator=g).to(dev)
    return p, x, y


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [10, 2])
def test_vmapped_cnn_runs_the_lane_kernel(lanes, cuda_device):
    """vmap(grad_loss) and vmap(feature) at paper width on the card: 6
    forward, 5 input-grad and 6 weight-grad launches a grad_loss call, 6
    forward a feature call, and the results of the vmapped per-client
    functions (the grouped cuDNN convolution) within fp32 rounding."""
    p, x, y = paper_world(lanes, cuda_device)
    backend = cnn_backend(CONFIG)
    before = {d: getattr(kconv.conv_lanes, f"launches_{d}") for d in kconv.DIRECTIONS}
    loss, grads = vmap(backend.grad_loss)(p, x, y)
    feat = vmap(backend.feature)(p, x)
    torch.cuda.synchronize()
    moved = {d: getattr(kconv.conv_lanes, f"launches_{d}") - before[d] for d in kconv.DIRECTIONS}
    assert moved == {"forward": 12, "input_grad": 5, "weight_grad": 6}
    loss0, grads0 = vmap(lambda p, x, y: cnn.client_grad_loss(CONFIG, p, x, y))(p, x, y)
    feat0 = vmap(lambda p, x: cnn.feature_vector(CONFIG, p, x))(p, x)
    torch.testing.assert_close(loss, loss0, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(feat, feat0, rtol=1e-5, atol=1e-6)
    for k in grads:
        ok, gaps = near(grads[k], grads0[k])
        assert ok, (k, gaps)


@pytest.mark.cuda
def test_shared_model_stays_on_cudnn(cuda_device):
    """The probe's one shared model, and a vmap over images with shared
    weights, launch no lane kernel."""
    p = cnn.init_params(CONFIG, torch.Generator().manual_seed(0), cuda_device)
    x = torch.rand(4, 5, 32, 32, 3, device=cuda_device)
    before = kconv.conv_lanes.launches
    cnn.feature_vectors(CONFIG, p, x)
    vmap(cnn_backend(CONFIG).feature, in_dims=(None, 0))(p, x)
    torch.cuda.synchronize()
    assert kconv.conv_lanes.launches == before


@pytest.mark.cuda
def test_tiny_config_runs_on_the_lane_kernel(cuda_device):
    """The reduced widths the tests and drivers use take the kernel too."""
    cfg = CNNConfig(name="tiny", image_size=8, conv_channels=(2, 2, 2, 2, 2, 2), fc_dims=(4, 4))
    g = torch.Generator().manual_seed(2)
    p = cnn.init_params(cfg, g, torch.device("cpu"))
    p = {k: (v + 0.1 * torch.randn((3,) + v.shape, generator=g)).to(cuda_device) for k, v in p.items()}
    x = torch.rand(3, 4, 8, 8, 3, generator=g).to(cuda_device)
    y = torch.randint(0, 10, (3, 4), generator=g).to(cuda_device)
    before = kconv.conv_lanes.launches
    loss, grads = vmap(cnn_backend(cfg).grad_loss)(p, x, y)
    torch.cuda.synchronize()
    assert kconv.conv_lanes.launches - before == 17
    loss0, grads0 = vmap(lambda p, x, y: cnn.client_grad_loss(cfg, p, x, y))(p, x, y)
    torch.testing.assert_close(loss, loss0, rtol=1e-5, atol=1e-6)
    for k in grads:
        ok, gaps = near(grads[k], grads0[k])
        assert ok, (k, gaps)
