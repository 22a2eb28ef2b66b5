"""The lane convolution on the CPU: its plain versions against per-lane
loops, the CNN's vmap rules against the grouped convolution vmap makes of
``F.conv2d`` (bit for bit), which convolutions reach the lane kernel, and
the kernel wrapper's refusals.  The kernel itself runs on the card:
``tests/test_torch_conv_lanes_gpu.py``.
"""
import pytest

torch = pytest.importorskip("torch")

import torch.nn.functional as F  # noqa: E402
from torch.func import grad_and_value, vmap  # noqa: E402

from repro_torch.configs.cifar_cnn import CONFIG, CNNConfig  # noqa: E402
from repro_torch.fl.backend import cnn_backend  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.kernels import conv_lanes as kconv  # noqa: E402
from repro_torch.models import cnn  # noqa: E402
from repro_torch.models.common import softmax_cross_entropy  # noqa: E402

TINY = CNNConfig(name="tiny", image_size=16, conv_channels=(4, 4, 8, 8, 8, 8), fc_dims=(32, 16))
WIDTHS = {"paper": CONFIG, "tiny": TINY}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Parallel test workers each spinning OpenMP threads slow one another down."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def layers(cfg):
    """(cin, cout, spatial) of each convolution of ``cfg``."""
    out, cin, size = [], cfg.in_channels, cfg.image_size
    for i, cout in enumerate(cfg.conv_channels):
        out.append((cin, cout, size))
        cin = cout
        size //= 2 if i % 2 == 1 else 1
    return out


LAYER_CASES = [(w, i) for w in sorted(WIDTHS) for i in range(len(WIDTHS[w].conv_channels))]


def lane_inputs(lanes, batch, cin, cout, size, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(lanes, batch, cin, size, size, generator=g)
    w = torch.randn(lanes, cout, cin, 3, 3, generator=g) / (3 * cin**0.5)
    b = torch.randn(lanes, cout, generator=g)
    dy = torch.randn(lanes, batch, cout, size, size, generator=g)
    return x, w, b, dy


@pytest.mark.parametrize("lanes", [1, 3])
@pytest.mark.parametrize("width,layer", LAYER_CASES)
def test_plain_lanes_match_a_per_lane_loop(width, layer, lanes):
    """The plain versions (the grouped convolution) against F.conv2d,
    conv2d_input and conv2d_weight lane by lane; fp32 sums in another order."""
    cin, cout, size = layers(WIDTHS[width])[layer]
    x, w, b, dy = lane_inputs(lanes, 2, cin, cout, size)
    y = ops.conv_lanes(x, w, b)
    dx = ops.conv_lanes_input_grad(dy, x, w)
    dw, db = ops.conv_lanes_weight_grad(dy, x, w)
    for k in range(lanes):
        torch.testing.assert_close(y[k], F.conv2d(x[k], w[k], b[k], padding=1), rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(dx[k], torch.nn.grad.conv2d_input(x[k].shape, w[k], dy[k], padding=1),
                                   rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(dw[k], torch.nn.grad.conv2d_weight(x[k], w[k].shape, dy[k], padding=1),
                                   rtol=1e-5, atol=1e-4)
        torch.testing.assert_close(db[k], dy[k].sum(dim=(0, 2, 3)), rtol=1e-5, atol=1e-5)


def world(cfg, lanes=2, batch=3, seed=0):
    g = torch.Generator().manual_seed(seed)
    p = cnn.init_params(cfg, g, torch.device("cpu"))
    p = {k: v + 0.01 * torch.randn((lanes,) + v.shape, generator=g) for k, v in p.items()}
    x = torch.rand(lanes, batch, cfg.image_size, cfg.image_size, cfg.in_channels, generator=g)
    y = torch.randint(0, cfg.num_classes, (lanes, batch), generator=g)
    return p, x, y


def parent_forward(cfg, p, images):
    """The CNN's forward as it was before the lane rules, written out here
    so that the bit-for-bit tests hold the model's code to it."""
    x = images.permute(0, 3, 1, 2)
    for i in range(len(cfg.conv_channels)):
        x = F.relu(F.conv2d(x, p[f"conv{i}_w"], p[f"conv{i}_b"], padding=1))
        if i % 2 == 1:
            x = F.max_pool2d(x, 2)
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
    n_fc = len(cfg.fc_dims) + 1
    for i in range(n_fc):
        x = x @ p[f"fc{i}_w"] + p[f"fc{i}_b"]
        if i < n_fc - 1:
            x = F.relu(x)
    return x


def parent_feature(cfg):
    return lambda p, x: torch.softmax(parent_forward(cfg, p, x).float(), dim=-1).mean(dim=0)


def parent_grad_loss(cfg):
    """The CNN backend's grad_loss as it was before the lane rules."""
    gv = grad_and_value(lambda p, x, y: softmax_cross_entropy(parent_forward(cfg, p, x), y))

    def grad_loss(p, x, y):
        grads, loss = gv(p, x, y)
        return loss, grads

    return grad_loss


@pytest.mark.parametrize("width", sorted(WIDTHS))
def test_vmapped_grad_loss_and_feature_keep_their_bits(width):
    """On the CPU the rules run the vmap of the per-client functions: the
    simulator's vmap(grad_loss) and vmap(feature) equal, bit for bit, the
    grouped convolution's results from before the rules."""
    cfg = WIDTHS[width]
    p, x, y = world(cfg)
    backend = cnn_backend(cfg)
    loss, grads = vmap(backend.grad_loss)(p, x, y)
    loss0, grads0 = vmap(parent_grad_loss(cfg))(p, x, y)
    assert torch.equal(loss, loss0)
    assert grads.keys() == grads0.keys()
    for k in grads:
        assert torch.equal(grads[k], grads0[k]), k
    assert torch.equal(vmap(backend.feature)(p, x), vmap(parent_feature(cfg))(p, x))


def test_per_client_calls_keep_their_bits():
    """Outside vmap the functions are the per-client ones."""
    p, x, y = world(TINY)
    q = {k: v[0] for k, v in p.items()}
    loss, grads = cnn_backend(TINY).grad_loss(q, x[0], y[0])
    loss0, grads0 = parent_grad_loss(TINY)(q, x[0], y[0])
    assert torch.equal(loss, loss0) and all(torch.equal(grads[k], grads0[k]) for k in grads)
    assert torch.equal(cnn_backend(TINY).feature(q, x[0]), parent_feature(TINY)(q, x[0]))


@pytest.mark.parametrize("width", sorted(WIDTHS))
def test_shared_model_calls_keep_their_bits(width):
    """The probe's and the eval's shared model run the architecture as
    before, bit for bit."""
    cfg = WIDTHS[width]
    p, x, _ = world(cfg, lanes=1)
    q = {k: v[0] for k, v in p.items()}
    images = x.reshape((-1,) + x.shape[2:])
    assert torch.equal(cnn.forward(cfg, q, images), parent_forward(cfg, q, images))
    feats = torch.softmax(parent_forward(cfg, q, images).float(), dim=-1).reshape(x.shape[0], x.shape[1], -1)
    assert torch.equal(cnn.feature_vectors(cfg, q, x), feats.mean(dim=1))


@pytest.mark.parametrize("width", sorted(WIDTHS))
def test_lane_path_matches_the_vmapped_client(width):
    """The lanes' own forward and backward (the card's path, here with the
    plain convolutions) against vmap(grad_and_value) of one client: fp32
    sums in other orders (the dense layers as batched products)."""
    cfg = WIDTHS[width]
    p, x, y = world(cfg, lanes=3)
    losses, grads = cnn.lane_grad_loss(cfg, p, x, y)
    loss0, grads0 = vmap(parent_grad_loss(cfg))(p, x, y)
    torch.testing.assert_close(losses, loss0, rtol=1e-5, atol=1e-6)
    for k in grads0:
        torch.testing.assert_close(grads[k], grads0[k], rtol=1e-4, atol=1e-6 * grads0[k].abs().max().item())
    feat0 = vmap(parent_feature(cfg))(p, x)
    torch.testing.assert_close(cnn.lane_feature(cfg, p, x), feat0, rtol=1e-5, atol=1e-7)


def test_lane_path_skips_the_first_input_gradient(monkeypatch):
    """A SGD step of the lanes asks for each convolution's forward and
    weight gradient once, and for the input gradient of all but conv0,
    whose input (the images) needs none."""
    calls = []
    for name in ("conv_lanes", "conv_lanes_input_grad", "conv_lanes_weight_grad"):
        real = getattr(ops, name)

        def spy(*args, real=real, name=name):
            calls.append((name, args[-2].shape[2] if name == "conv_lanes" else args[-1].shape[2]))  # the layer's Cin
            return real(*args)

        monkeypatch.setattr(ops, name, spy)
    p, x, y = world(TINY)
    cnn.lane_grad_loss(TINY, p, x, y)
    cins = [cin for cin, _, _ in layers(TINY)]
    assert [c for n, c in calls if n == "conv_lanes"] == cins
    assert sorted(c for n, c in calls if n == "conv_lanes_weight_grad") == sorted(cins)
    assert sorted(c for n, c in calls if n == "conv_lanes_input_grad") == sorted(cins[1:])
    calls.clear()
    cnn.lane_feature(TINY, p, x)
    assert [n for n, _ in calls] == ["conv_lanes"] * len(cins)


def test_shared_weights_never_reach_the_lane_path(monkeypatch):
    """One shared model (the probe, the eval, a vmap over images alone)
    stays on F.conv2d: no lane convolution is asked for."""
    def refuse(*a):
        raise AssertionError("a lane convolution was asked for shared weights")

    for name in ("conv_lanes", "conv_lanes_input_grad", "conv_lanes_weight_grad"):
        monkeypatch.setattr(ops, name, refuse)
    p, x, y = world(TINY)
    shared = {k: v[0] for k, v in p.items()}
    backend = cnn_backend(TINY)
    cnn.feature_vectors(TINY, shared, x)
    cnn.predictions(TINY, shared, x[0])
    got = vmap(backend.feature, in_dims=(None, 0))(shared, x)
    torch.testing.assert_close(got, vmap(lambda im: cnn.feature_vector(TINY, shared, im))(x), rtol=0, atol=0)
    loss, grads = vmap(backend.grad_loss, in_dims=(None, 0, 0))(shared, x, y)
    loss0, _ = vmap(parent_grad_loss(TINY), in_dims=(None, 0, 0))(shared, x, y)
    assert torch.equal(loss, loss0)


def test_lane_conv_runs_the_plain_versions_on_the_cpu():
    """_LaneConv's forward and backward against autograd through the plain
    lane convolution."""
    x, w, b, dy = lane_inputs(2, 3, 4, 8, 8)
    xs, ws, bs = (t.clone().requires_grad_() for t in (x, w, b))
    (cnn._LaneConv.apply(xs, ws, bs) * dy).sum().backward()
    xr, wr, br = (t.clone().requires_grad_() for t in (x, w, b))
    (ref.conv_lanes_ref(xr, wr, br) * dy).sum().backward()
    for got, want in ((xs.grad, xr.grad), (ws.grad, wr.grad), (bs.grad, br.grad)):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_kernel_wrappers_raise_on_cpu_tensors():
    """No fallback: the kernel entry points take CUDA tensors only."""
    x, w, b, dy = lane_inputs(2, 2, 4, 8, 8)
    before = kconv.conv_lanes.launches
    with pytest.raises(ValueError, match="CUDA"):
        kconv.forward(x, w, b)
    with pytest.raises(ValueError, match="CUDA"):
        kconv.input_grad(dy, w)
    with pytest.raises(ValueError, match="CUDA"):
        kconv.weight_grad(dy, x)
    assert kconv.conv_lanes.launches == before


def test_kernel_wrapper_raises_when_no_library_is_built(monkeypatch, tmp_path):
    """A tensor that passes the device gate, with no library built and no
    nvcc, raises: nothing falls back to the plain version."""
    x, w, b, _ = lane_inputs(2, 2, 4, 8, 8)

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(build, "launch_stream", lambda what, index: 0)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "nvcc_path", no_nvcc)
    monkeypatch.setattr(kconv, "sm_count", lambda index: 132)
    build.library.cache_clear()
    kconv._launcher.cache_clear()
    before = kconv.conv_lanes.launches
    with pytest.raises(RuntimeError, match="nvcc"):
        kconv.forward(x, w, b)
    assert kconv.conv_lanes.launches == before
    build.library.cache_clear()
    kconv._launcher.cache_clear()


@pytest.mark.parametrize("call", [
    lambda x, w, b, dy: kconv.forward(x, w, b, stride=2),
    lambda x, w, b, dy: kconv.forward(x, w, b, padding=0),
    lambda x, w, b, dy: kconv.forward(x, torch.zeros(2, 8, 4, 5, 5), b),
    lambda x, w, b, dy: kconv.input_grad(dy, w, padding=2),
    lambda x, w, b, dy: kconv.weight_grad(dy, x, stride=2),
    lambda x, w, b, dy: kconv.weight_grad(dy, x, kernel_size=(1, 1)),
], ids=["stride", "padding", "kernel5", "input_grad_padding", "weight_grad_stride", "weight_grad_kernel1"])
def test_kernel_wrappers_refuse_other_convolutions(call):
    x, w, b, dy = lane_inputs(2, 2, 4, 8, 8)
    with pytest.raises(ValueError, match="3x3 kernels, stride 1, padding 1"):
        call(x, w, b, dy)


def test_kernel_wrappers_refuse_other_dtypes_and_shapes():
    x, w, b, dy = lane_inputs(2, 2, 4, 8, 8)
    with pytest.raises(TypeError):
        kconv.forward(x.double(), w, b)
    with pytest.raises(ValueError, match="not"):
        kconv.forward(x, w[:1], b)
    with pytest.raises(ValueError, match="differ"):
        kconv.weight_grad(dy, x[:, :1])


@pytest.mark.parametrize("lanes", [100, 10, 1])
@pytest.mark.parametrize("direction", kconv.DIRECTIONS)
def test_plan_fits_every_layer_of_the_paper_and_tiny_models(direction, lanes):
    """Every layer's tiles fit in shared memory, cover the image, and the
    weight gradient's split leaves each block at least 2 pixel tiles."""
    for cfg in WIDTHS.values():
        for cin, cout, size in layers(cfg):
            p = kconv.plan(direction, lanes, 15, size, size, cin, cout, 132)
            assert p["smem"] <= kconv.MAX_SMEM
            assert p["imgs"] * p["rows"] * size <= (256 if p["bn"] == 32 and direction != "weight_grad" else 128)
            assert p["rows"] == size or p["imgs"] == 1
            if direction == "weight_grad":
                ktiles = -(-15 // p["imgs"]) * -(-size // p["rows"])
                assert p["split"] in (1, 2, 4, 8) and ktiles >= 2 * p["split"]
            else:
                n = cout if direction == "forward" else cin
                assert p["bn"] >= min(n, 128) and p["ck"] in (4, 8, 16)


def test_plan_splits_the_weight_gradient_where_lanes_are_few():
    """conv1 at 100 lanes gives 100 blocks, at 1 lane 1: both split to 8;
    conv5 at 100 lanes gives 1,600 blocks and needs no split."""
    assert kconv.plan("weight_grad", 100, 15, 32, 32, 32, 32, 132)["split"] == 8
    assert kconv.plan("weight_grad", 1, 15, 32, 32, 32, 32, 132)["split"] == 8
    assert kconv.plan("weight_grad", 100, 15, 8, 8, 128, 128, 132)["split"] == 1


def test_ops_registers_the_lane_kernel_and_its_directions():
    """conv_lanes is one of ``ops.KERNELS``, its directions are no routes,
    and ``reset_launch_counts`` clears every direction's counter."""
    assert "conv_lanes" in ops.launch_counts() and "conv_lanes" not in ops.ROUTES
    for d in kconv.DIRECTIONS:
        setattr(kconv.conv_lanes, f"launches_{d}", getattr(kconv.conv_lanes, f"launches_{d}") + 1)
    kconv.conv_lanes.launches += 3
    ops.reset_launch_counts()
    assert ops.launch_counts()["conv_lanes"] == 0
    assert all(getattr(kconv.conv_lanes, f"launches_{d}") == 0 for d in kconv.DIRECTIONS)
    assert ops.route_launch_counts() == {k: {r: 0 for r in rs} for k, rs in ops.ROUTES.items()}
