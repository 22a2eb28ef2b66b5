"""The port's Alg. 1 against the JAX package on ``tiny_world``.

Both sides start from the reference's initial model and consume the same
random draws: the reference's key chain (``epoch_body``'s
``split(key, 4)``, the Alg. 2 tie-break, the Bernoulli slot chain and the
per-client SGD permutations) is replayed into ``ReplayDraws``.

Tolerances: integer dynamics, selections and VAoI ages must agree exactly
(ages are integer-valued floats and their comparisons M >= mu did not land
within rounding of mu on this world).  Params, avg_m and f1 agree to fp32
rounding: the two frameworks sum convolutions in different orders (NHWC
per-client convs against a vmapped NCHW grouped conv), so after 8 epochs
of SGD the params differ by at most 9e-8 absolute (measured on this world);
5e-6 absolute leaves room for other CPUs' vector widths.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.cifar_cnn import CNNConfig  # noqa: E402
from repro.core import EHFLConfig, init_carry, make_epoch_fn, run_simulation  # noqa: E402
from repro.data import make_federated_dataset  # noqa: E402
from repro.fl import cnn_backend  # noqa: E402
from repro_torch.checkpoint.convert import (  # noqa: E402
    carry_from_reference,
    params_from_reference,
    params_to_reference,
)
from repro_torch.configs import CNNConfig as TCNNConfig  # noqa: E402
from repro_torch.core import EHFLConfig as TEHFLConfig  # noqa: E402
from repro_torch.core import ReplayDraws  # noqa: E402
from repro_torch.core import simulator as tsim  # noqa: E402
from repro_torch.fl import cnn_backend as t_cnn_backend  # noqa: E402

CPU = torch.device("cpu")
TINY = dict(name="tiny", image_size=16, conv_channels=(4, 4, 8, 8, 8, 8), fc_dims=(32, 16))
CFG = dict(
    num_clients=8, epochs=8, slots_per_epoch=12, kappa=8, p_bc=0.8,
    k=3, mu=0.1, e_max=13, eval_every=4, probe_size=10, policy="vaoi",
)
PARAM_ATOL, FLOAT_RTOL = 5e-6, 1e-4
F1_ATOL = 1e-6  # 100 test images: equal predictions give bit-equal f1


def replay_reference_draws(cfg: EHFLConfig, key, n_samples: int) -> ReplayDraws:
    """The draws ``repro.core.simulator.epoch_body`` consumes, epoch by epoch."""
    N, S = cfg.num_clients, cfg.slots_per_epoch
    m = cfg.kappa * max(1, n_samples // cfg.kappa)

    @jax.jit
    def one(key):
        k_sel, k_scan, k_train, k_next = jax.random.split(key, 4)
        if cfg.policy == "vaoi_soft":
            noise = jax.random.gumbel(k_sel, (N,))
        else:
            noise = jax.random.uniform(k_sel, (N,), minval=0.0, maxval=1e-3)

        def slot(hk, _):
            k1, k2 = jax.random.split(hk)
            return k2, jax.random.bernoulli(k1, cfg.p_bc, (N,))

        _, bits = jax.lax.scan(slot, k_scan, None, length=S)
        perms = jax.vmap(lambda k: jax.random.permutation(k, n_samples)[:m])(
            jax.random.split(k_train, N)
        )
        return noise, bits, perms, k_next

    noise, bits, perms = [], [], []
    for _ in range(cfg.epochs):
        a, b, c, key = one(key)
        noise.append(np.asarray(a))
        bits.append(np.asarray(b))
        perms.append(np.asarray(c))
    return ReplayDraws(np.stack(noise), np.stack(bits), np.stack(perms))


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def world():
    data = make_federated_dataset(
        jax.random.PRNGKey(0), num_clients=8, samples_per_client=40, alpha=0.5,
        test_size=100, image_size=16,
    )
    cfg = EHFLConfig(**CFG)
    backend = cnn_backend(CNNConfig(**TINY))
    carry0 = init_carry(cfg, backend)
    draws = replay_reference_draws(cfg, carry0.key, 40)
    np_data = {k: np.asarray(v) for k, v in data.items()}
    return cfg, backend, data, np_data, carry0, draws


@pytest.fixture(scope="module")
def port_run(world):
    _, _, _, np_data, carry0, draws = world
    params = params_from_reference(np_tree(carry0.global_params), CPU)
    out = tsim.run_simulation(
        TEHFLConfig(**CFG), t_cnn_backend(TCNNConfig(**TINY)), np_data,
        draws=draws, params=params, device="cpu",
    )
    return out


@pytest.fixture(scope="module", params=[False, True], ids=["ref_plain", "ref_kernel"])
def ref_run(request, world):
    cfg, backend, data, *_ = world
    return run_simulation(cfg, backend, data, use_kernel=request.param)


def test_port_integer_dynamics_match_reference_exactly(port_run, ref_run):
    pc, rc = port_run["carry"], ref_run["carry"]
    np.testing.assert_array_equal(pc.battery.numpy(), np.asarray(rc.battery))
    np.testing.assert_array_equal(pc.pending.numpy(), np.asarray(rc.pending))
    np.testing.assert_array_equal(pc.counter.numpy(), np.asarray(rc.counter))
    np.testing.assert_array_equal(pc.age.numpy(), np.asarray(rc.age))
    pm, rm = port_run["metrics"], ref_run["metrics"]
    for k in ("n_started", "n_uploaded", "energy", "avg_age"):
        np.testing.assert_array_equal(pm[k].numpy(), np.asarray(rm[k]), err_msg=k)
    assert pm["n_started"].sum() > 0  # the comparison exercised training


def test_port_floats_match_reference(port_run, ref_run):
    pm, rm = port_run["metrics"], ref_run["metrics"]
    np.testing.assert_allclose(pm["avg_m"].numpy(), np.asarray(rm["avg_m"]), rtol=FLOAT_RTOL, atol=1e-6)
    np.testing.assert_allclose(pm["f1"].numpy(), np.asarray(rm["f1"]), atol=F1_ATOL)
    np.testing.assert_array_equal(pm["f1_epochs"].numpy(), np.asarray(rm["f1_epochs"]))
    got = params_to_reference(port_run["global_params"])
    want = np_tree(ref_run["global_params"])
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=FLOAT_RTOL, atol=PARAM_ATOL, err_msg=k)
    np.testing.assert_allclose(
        port_run["carry"].h.numpy(), np.asarray(ref_run["carry"].h), rtol=FLOAT_RTOL, atol=1e-6
    )


def test_port_dense_matches_compact(world, port_run):
    """``compact=False`` trains all N clients; the default trains the k-slab.
    Same dynamics exactly, same model to fp32 rounding."""
    _, _, _, np_data, carry0, draws = world
    dense = tsim.run_simulation(
        TEHFLConfig(**CFG, compact=False), t_cnn_backend(TCNNConfig(**TINY)), np_data,
        draws=draws, params=params_from_reference(np_tree(carry0.global_params), CPU), device="cpu",
    )
    for k in ("n_started", "n_uploaded", "energy", "avg_age", "selected"):
        np.testing.assert_array_equal(dense["metrics"][k].numpy(), port_run["metrics"][k].numpy(), err_msg=k)
    for f in ("battery", "pending", "counter", "age"):
        np.testing.assert_array_equal(getattr(dense["carry"], f).numpy(), getattr(port_run["carry"], f).numpy())
    for k, v in port_run["global_params"].items():
        np.testing.assert_allclose(dense["global_params"][k].numpy(), v.numpy(), rtol=1e-5, atol=1e-6)


def test_first_divergent_epoch(world):
    """Start each port epoch from the reference's own carry and name the
    first epoch whose outcome differs."""
    cfg, backend, data, np_data, carry0, draws = world
    epoch_fn = jax.jit(make_epoch_fn(cfg, backend, data))
    tcfg = TEHFLConfig(**CFG)
    t_epoch = tsim.make_epoch_fn(tcfg, t_cnn_backend(TCNNConfig(**TINY)), tsim.to_device_data(np_data, CPU))
    fields = ("global_params", "msg_params", "h", "age", "battery", "pending", "counter", "retries", "backoff")
    carry = carry0
    for t in range(cfg.epochs):
        port_in = carry_from_reference({f: np_tree(getattr(carry, f)) for f in fields}, CPU)
        port_out, _ = t_epoch(port_in, t, draws.epoch(t, tcfg, 40, CPU))
        carry, _ = epoch_fn(carry, jnp.int32(t))
        try:
            for f in ("battery", "pending", "counter", "age"):
                np.testing.assert_array_equal(getattr(port_out, f).numpy(), np.asarray(getattr(carry, f)), err_msg=f)
            np.testing.assert_allclose(port_out.h.numpy(), np.asarray(carry.h), rtol=FLOAT_RTOL, atol=1e-6)
            want = np_tree(carry.global_params)
            got = params_to_reference(port_out.global_params)
            for k in want:
                np.testing.assert_allclose(got[k], want[k], rtol=FLOAT_RTOL, atol=PARAM_ATOL, err_msg=k)
            want_msg = np_tree(carry.msg_params)
            got_msg = params_to_reference(port_out.msg_params, stacked=True)
            for k in want_msg:
                np.testing.assert_allclose(got_msg[k], want_msg[k], rtol=FLOAT_RTOL, atol=PARAM_ATOL, err_msg=k)
        except AssertionError as e:
            pytest.fail(f"port and reference part at epoch {t}: {e}")
