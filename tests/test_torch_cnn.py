"""The port's CNN client against ``repro.models.cnn`` with the weights
carried across (``checkpoint.convert``): logits, loss, grads, the VAoI
feature, predictions and macro-F1, at ``TINY_CNN`` and at paper width.

fp32 throughout, rtol 1e-4 / atol 1e-5: the two frameworks run the same
convolutions (NHWC/HWIO "SAME" against NCHW/OIHW padding=1) and sum in
different orders, which moves the last few bits of each value.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.cifar_cnn import CONFIG, CNNConfig  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro_torch.checkpoint import npz as tnpz  # noqa: E402
from repro_torch.checkpoint.convert import params_from_reference, params_to_reference  # noqa: E402
from repro_torch.configs import CONFIG as T_CONFIG  # noqa: E402
from repro_torch.configs import CNNConfig as TCNNConfig  # noqa: E402
from repro_torch.models import cnn as tcnn  # noqa: E402

RTOL, ATOL = 1e-4, 1e-5
TINY = dict(name="tiny", image_size=16, conv_channels=(4, 4, 8, 8, 8, 8), fc_dims=(32, 16))
WIDTHS = {"tiny": (CNNConfig(**TINY), TCNNConfig(**TINY), 6), "paper": (CONFIG, T_CONFIG, 3)}


@pytest.fixture(scope="module", params=sorted(WIDTHS))
def pair(request):
    jcfg, tcfg, batch = WIDTHS[request.param]
    jp = jcnn.init_params(jcfg, jax.random.PRNGKey(0))
    np_params = {k: np.asarray(v) for k, v in jp.items()}
    rng = np.random.default_rng(0)
    x = rng.normal(size=(batch, jcfg.image_size, jcfg.image_size, 3)).astype(np.float32)
    y = rng.integers(0, jcfg.num_classes, size=batch).astype(np.int32)
    tp = params_from_reference(np_params, "cpu")
    return jcfg, tcfg, jp, tp, x, y


def close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_paper_config_matches_reference():
    assert T_CONFIG.__dict__ == CONFIG.__dict__
    n = sum(v.numel() for v in tcnn.init_params(T_CONFIG, torch.Generator().manual_seed(0), "cpu").values())
    assert n == 845_738


def test_logits_and_predictions(pair):
    jcfg, tcfg, jp, tp, x, y = pair
    close(tcnn.forward(tcfg, tp, torch.from_numpy(x)), jcnn.forward(jcfg, jp, x))
    np.testing.assert_array_equal(
        tcnn.predictions(tcfg, tp, torch.from_numpy(x)).numpy(), np.asarray(jcnn.predictions(jcfg, jp, x))
    )


def test_loss_and_grads(pair):
    jcfg, tcfg, jp, tp, x, y = pair
    jloss, jgrads = jax.value_and_grad(lambda p: jcnn.loss_fn(jcfg, p, x, y))(jp)
    tgrads, tloss = torch.func.grad_and_value(
        lambda p: tcnn.loss_fn(tcfg, p, torch.from_numpy(x), torch.from_numpy(y))
    )(tp)
    close(tloss, jloss)
    got = params_to_reference(tgrads)
    for k, g in jgrads.items():
        np.testing.assert_allclose(got[k], np.asarray(g), rtol=RTOL, atol=ATOL, err_msg=k)


def test_feature_vector(pair):
    jcfg, tcfg, jp, tp, x, y = pair
    close(tcnn.feature_vector(tcfg, tp, torch.from_numpy(x)), jcnn.feature_vector(jcfg, jp, x))
    # the probe: one shared model over N clients' batches in one forward
    xs = np.stack([x, x[::-1]])
    want = jax.vmap(lambda b: jcnn.feature_vector(jcfg, jp, b))(xs)
    close(tcnn.feature_vectors(tcfg, tp, torch.from_numpy(xs.copy())), want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_macro_f1(seed):
    rng = np.random.default_rng(seed)
    preds = rng.integers(0, 10, size=200)
    labels = rng.integers(0, 4, size=200)  # absent classes score 0 on both sides
    got = tcnn.macro_f1(torch.from_numpy(preds), torch.from_numpy(labels), 10)
    want = jcnn.macro_f1(preds, labels, 10)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_macro_f1_over_an_lm_vocab():
    """An LM client's classes are its vocab: many classes, few predictions,
    most classes absent from both (counted at once, not class by class)."""
    rng = np.random.default_rng(3)
    preds, labels = rng.integers(0, 300, size=64), rng.integers(0, 300, size=64)
    labels[::3] = preds[::3]
    got = tcnn.macro_f1(torch.from_numpy(preds), torch.from_numpy(labels), 300)
    np.testing.assert_allclose(got.numpy(), np.asarray(jcnn.macro_f1(preds, labels, 300)), rtol=1e-6)


def test_params_round_trip_and_npz_interchange(pair, tmp_path):
    """convert and the npz format carry the reference's params both ways."""
    from repro.checkpoint.npz import load_pytree as jload
    from repro.checkpoint.npz import save_pytree as jsave

    jcfg, tcfg, jp, tp, x, y = pair
    back = params_to_reference(tp)
    for k, v in jp.items():
        np.testing.assert_array_equal(back[k], np.asarray(v))
    jsave(jp, tmp_path / "ref.npz")
    loaded = params_from_reference({k: v.numpy() for k, v in tnpz.load_arrays(tmp_path / "ref.npz").items()}, "cpu")
    for k, v in tp.items():
        torch.testing.assert_close(loaded[k], v, rtol=0, atol=0)
    tree = {"params": {k: v.to(torch.bfloat16) for k, v in tp.items()}, "step": torch.tensor(3)}
    tnpz.save_pytree(tree, tmp_path / "port.npz")
    same = tnpz.load_pytree(tree, tmp_path / "port.npz")
    for k, v in tree["params"].items():
        assert same["params"][k].dtype == torch.bfloat16
        torch.testing.assert_close(same["params"][k], v, rtol=0, atol=0)
    # a bf16 file the port writes in the reference's layout loads in the reference
    ref_layout = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in back.items()}
    tnpz.save_pytree({"params": ref_layout}, tmp_path / "port_ref.npz")
    jtree = jload({"params": {k: v.astype(jax.numpy.bfloat16) for k, v in jp.items()}}, tmp_path / "port_ref.npz")
    for k, v in ref_layout.items():
        np.testing.assert_array_equal(np.asarray(jtree["params"][k], np.float32), v.float().numpy())
