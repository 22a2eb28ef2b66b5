"""The port's scheduler core against ``repro.core``: given the same noise and
harvest bits, Alg. 2 selection, all five policies' selection / want /
opportunity rules and the slot-level energy loop match EXACTLY (battery,
start slots, pending, uploads, counters and energy are integers or masks);
Eq. 5 / Eq. 7 match to fp32 rounding (1e-6)."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import energy as jenergy  # noqa: E402
from repro.core import harvest as jharvest  # noqa: E402
from repro.core import policies as jpol  # noqa: E402
from repro.core import vaoi as jvaoi  # noqa: E402
from repro_torch.core import energy as tenergy  # noqa: E402
from repro_torch.core import harvest as tharvest  # noqa: E402
from repro_torch.core import policies as tpol  # noqa: E402
from repro_torch.core import vaoi as tvaoi  # noqa: E402

N, S, KAPPA, E_MAX, K = 24, 14, 5, 9, 6


def t(x, dtype=None):
    return torch.as_tensor(np.array(x), dtype=dtype)


def selection_noise(policy, key):
    if policy == "vaoi_soft":
        return jax.random.gumbel(key, (N,))
    return jax.random.uniform(key, (N,), minval=0.0, maxval=1e-3)


def harvest_bits(key, p_bc):
    """The bernoulli process's per-slot chain, replayed."""
    bits = []
    for _ in range(S):
        k1, key = jax.random.split(key)
        bits.append(np.asarray(jax.random.bernoulli(k1, p_bc, (N,))))
    return np.stack(bits)


@pytest.mark.parametrize("seed", range(4))
def test_select_topk_exact(seed):
    key = jax.random.PRNGKey(seed)
    ka, kn = jax.random.split(key)
    # integer ages with many ties (and an all-zero cold start at seed 0)
    age = jnp.zeros((N,)) if seed == 0 else jax.random.randint(ka, (N,), 0, 3).astype(jnp.float32)
    want = jvaoi.select_topk(age, K, kn)
    got = tvaoi.select_topk(t(age), K, t(selection_noise("vaoi", kn)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # equal scores: lax.top_k's lower-index-first tie-break
    assert tvaoi.select_topk(torch.ones(N), K, torch.zeros(N)).nonzero().flatten().tolist() == list(range(K))


@pytest.mark.parametrize("seed", range(3))
def test_select_gumbel_exact(seed):
    ka, kg = jax.random.split(jax.random.PRNGKey(seed))
    age = jax.random.randint(ka, (N,), 0, 5).astype(jnp.float32)
    want = jvaoi.select_gumbel(age, K, kg)
    got = tvaoi.select_gumbel(t(age), K, t(selection_noise("vaoi_soft", kg)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_vaoi_math_matches():
    ks = jax.random.split(jax.random.PRNGKey(7), 5)
    v, h = jax.random.uniform(ks[0], (N, 10)), jax.random.uniform(ks[1], (N, 10))
    age = jax.random.randint(ks[2], (N,), 0, 6).astype(jnp.float32)
    sel, new_age, m = jvaoi.client_select(age, v, h, K, 0.9, ks[3])
    tsel, tnew_age, tm = tvaoi.client_select(t(age), t(v), t(h), K, 0.9, t(selection_noise("vaoi", ks[3])))
    np.testing.assert_array_equal(tsel.numpy(), np.asarray(sel))
    np.testing.assert_allclose(tm.numpy(), np.asarray(m), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(tnew_age.numpy(), np.asarray(new_age))


@pytest.mark.parametrize("policy", ["vaoi", "vaoi_soft", "fedavg", "fedbacys", "fedbacys_odd"])
@pytest.mark.parametrize("seed", range(2))
def test_policy_epoch_matches_exactly(policy, seed):
    """Selection, the want / opportunity rules and the S-slot loop, for one
    epoch from a random mid-run state."""
    ks = jax.random.split(jax.random.PRNGKey(100 + seed), 6)
    p_bc = 0.6
    age = jax.random.randint(ks[0], (N,), 0, 4).astype(jnp.float32)
    battery = jax.random.randint(ks[1], (N,), 0, E_MAX + 1)
    pending = jax.random.uniform(ks[2], (N,)) < 0.3
    counter = jax.random.randint(ks[3], (N,), 0, 4)
    epoch = 3 + seed
    jspec = jpol.make_policy(policy, num_clients=N, k=K)
    tspec = tpol.make_policy(policy, num_clients=N, k=K)
    assert tspec == tpol.PolicySpec(**jspec.__dict__)

    sel = jpol.epoch_selection(jspec, age, epoch, K, ks[4])
    tsel = tpol.epoch_selection(tspec, t(age), epoch, K, t(selection_noise(policy, ks[4])))
    np.testing.assert_array_equal(tsel.numpy(), np.asarray(sel))

    jst = jenergy.init_slot_state(N, ks[5], battery=battery, S=S)._replace(pending=pending, counter=counter)
    jout = jenergy.scan_epoch(
        jst, S=S, kappa=KAPPA, e_max=E_MAX, process=jharvest.bernoulli(p_bc),
        want_fn=jpol.make_want_fn(jspec, sel, S, KAPPA),
        count_opportunity_fn=jpol.make_opportunity_fn(jspec, sel, S, KAPPA),
    )
    process = tharvest.bernoulli(p_bc)
    tst = tenergy.init_slot_state(N, torch.device("cpu"), battery=t(battery, torch.int32), S=S)._replace(
        pending=t(pending), counter=t(counter, torch.int32),
        harvest=process.init(torch.from_numpy(harvest_bits(ks[5], p_bc)), N),
    )
    tout = tenergy.scan_epoch(
        tst, S=S, kappa=KAPPA, e_max=E_MAX, process=process,
        want_fn=tpol.make_want_fn(tspec, tsel, S, KAPPA),
        count_opportunity_fn=tpol.make_opportunity_fn(tspec, tsel, S, KAPPA),
    )
    for f in ("battery", "started", "start_slot", "pending", "uploaded", "counter", "energy_used"):
        got = getattr(tout, f)
        if f in ("battery", "start_slot", "counter", "energy_used"):
            assert got.dtype == torch.int32, f
        np.testing.assert_array_equal(got.numpy(), np.asarray(getattr(jout, f)), err_msg=f)


def test_tx_allowed_gate_matches():
    ks = jax.random.split(jax.random.PRNGKey(9), 3)
    battery = jax.random.randint(ks[0], (N,), 0, E_MAX + 1)
    allowed = jax.random.uniform(ks[1], (N,)) < 0.5
    pending = jnp.ones((N,), bool)
    sel = jnp.ones((N,), bool)
    jst = jenergy.init_slot_state(N, ks[2], battery=battery, S=S)._replace(pending=pending)
    jout = jenergy.scan_epoch(jst, S=S, kappa=KAPPA, e_max=E_MAX, process=jharvest.bernoulli(0.3),
                              want_fn=lambda s, st: sel, tx_allowed=allowed)
    process = tharvest.bernoulli(0.3)
    tst = tenergy.init_slot_state(N, torch.device("cpu"), battery=t(battery, torch.int32), S=S)._replace(
        pending=t(pending), harvest=process.init(torch.from_numpy(harvest_bits(ks[2], 0.3)), N)
    )
    tout = tenergy.scan_epoch(tst, S=S, kappa=KAPPA, e_max=E_MAX, process=process,
                              want_fn=lambda s, st: t(sel), tx_allowed=t(allowed))
    for f in ("battery", "pending", "uploaded", "energy_used", "started"):
        np.testing.assert_array_equal(getattr(tout, f).numpy(), np.asarray(getattr(jout, f)), err_msg=f)
    assert not tout.uploaded[~t(allowed)].any()


def test_unported_scenarios_raise():
    """Every scenario of the reference is ported; only an unknown name raises."""
    assert tharvest.SCENARIOS == jharvest.SCENARIOS
    for name in tharvest.SCENARIOS:
        assert tharvest.make_process(name, p_bc=0.1).name == name
    with pytest.raises(ValueError, match="known"):
        tharvest.make_process("solar", p_bc=0.1)
