"""The fleet's parts, one gloo spawn of 4 ranks for the module, against the
global forms and the JAX package (``tests/_torch_fleet_worker.py`` runs the
rank side).  Shard counts 1, 2 and 4 run over groups of the first 1, 2 and
4 ranks; the inputs come from numpy with a seed (the selection noise from
the JAX package's keys).

* Alg. 2 over a client-sharded fleet (``policies.epoch_selection_sharded``,
  the distributed top-k): every policy at k in {1, 3, N_loc, N_loc + 1, N}
  on random, all-equal and all-zero ages, plus exact score ties (equal ages
  and equal noise): the rows gathered in rank order equal the port's solo
  selection and the JAX package's ``vaoi.select_topk`` / ``select_gumbel`` /
  ``policies.epoch_selection``, exactly.
* Every harvest, stream and channel scenario on each shard's rows and its
  window of the global draws (``draws.shard_draws``) against the scenario
  over all N: charges, carried state, view indices and delivered masks
  exactly.  ALOHA's contention counts are all-reduced, and its case has a
  collision that spans shards, which a shard alone would miss.
* FedAvg: each shard's leaf-table reduce (its slab and its old-carrier
  rows; its dense rows) plus the all-reduces against the JAX package's
  ``_compact_mean`` and ``_masked_mean`` / ``_masked_mean_kernel`` (plain
  and Pallas interpret mode) over all rows, within 1e-6 (the shards' fp32
  partials are summed in another order); an Inf under weight 0 in one shard
  comes out NaN in exactly its column.
* Refusals: N not divisible by the shards, no process group, the shard
  count's clamp."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import _torch_fleet_worker as worker  # noqa: E402
from repro.core import policies as jpol  # noqa: E402
from repro.core import simulator as jsim  # noqa: E402
from repro.core import vaoi as jvaoi  # noqa: E402
from repro_torch.core import EHFLConfig  # noqa: E402
from repro_torch.core import channel as channel_lib  # noqa: E402
from repro_torch.core import harvest as harvest_lib  # noqa: E402
from repro_torch.core import fleet  # noqa: E402
from repro_torch.data import stream as stream_lib  # noqa: E402
from repro_torch.launch import mesh  # noqa: E402

N, S, POOL = 16, 6, 12
SHARDS = (1, 2, 4)
POLICIES = ("vaoi", "vaoi_soft", "fedavg", "fedbacys", "fedbacys_odd")
AGES = ("random", "equal", "zero", "exact_ties")
FEDAVG_TOL = 1e-6
RAGGED = {"a": (1,), "b": (3,), "c": (10,), "d": (37,), "e": (8, 8)}
HARVEST = {"bernoulli": {}, "markov": {"p_on": 0.9, "sojourn": 3.0}, "diurnal": {"period": 10.0}, "hetero": {}}
STREAM = {
    "static": {}, "drift": {"period": 3.0, "num_classes": 10}, "arrival": {"rate": 1.5, "window": 5},
    "shift": {"period": 2.0, "num_classes": 10},
}
CHANNEL = {
    "ideal": {}, "erasure": {"p_loss": 0.3, "concentration": 1.0}, "aloha": {"num_channels": 4},
    "fading": {"p_bad": 0.4, "sojourn": 2.0},
}
# ALOHA's first epoch: clients 1 (shard 0 of 4) and 9 (shard 2) collide on
# channel 0; client 5 is alone on channel 1 and client 14 on channel 2
ALOHA_ATTEMPT = (1, 5, 9, 14)
ALOHA_CHOICE = {1: 0, 5: 1, 9: 0, 14: 2}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Many small ops: one intra-op thread each, so that parallel test
    workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def k_values(shards):
    n_loc = N // shards
    return sorted({1, 3, n_loc, n_loc + 1, N})


def selection_cases():
    cases = []
    key = jax.random.PRNGKey(7)
    rng = np.random.default_rng(7)
    for policy in POLICIES:
        for shards in SHARDS:
            for k in k_values(shards):
                for ages in AGES:
                    key, sub = jax.random.split(key)
                    if policy == "vaoi_soft":
                        noise = np.asarray(jax.random.gumbel(sub, (N,)))
                    else:
                        noise = np.asarray(jax.random.uniform(sub, (N,), minval=0.0, maxval=1e-3))
                    age = {"random": rng.integers(0, 6, N), "equal": np.full(N, 3), "zero": np.zeros(N),
                           "exact_ties": np.full(N, 2)}[ages].astype(np.float32)
                    if ages == "exact_ties":  # equal scores: only the index breaks the tie
                        noise = np.zeros(N, np.float32)
                    cases.append(dict(kind="select", shards=shards, n=N, policy=policy, k=k, t=int(rng.integers(9)),
                                      age=age, noise=noise, key=np.asarray(sub), ages=ages))
    return cases


def np_of(x):
    return None if x is None else np.asarray(x)


def scenario_cases():
    rng, g = np.random.default_rng(3), torch.Generator().manual_seed(3)
    cases = []
    for name, params in HARVEST.items():
        proc = harvest_lib.make_process(name, p_bc=0.5, **params)
        base = dict(kind="harvest", n=N, name=name, p_bc=0.5, params=params, init=np_of(proc.init_draw(rng, N)),
                    epochs=[np_of(proc.epoch_draw(g, S, N)) for _ in range(2)])
        cases += [dict(base, shards=s) for s in (2, 4)]
    labels = rng.integers(0, 10, (N, POOL))
    for name, params in STREAM.items():
        st = stream_lib.make_stream(name, **params)
        base = dict(kind="stream", n=N, name=name, params=params, labels=labels, init=np_of(st.init_draw(rng, N)),
                    epochs=[np_of(st.epoch_draw(g, N, POOL)) for _ in range(3)])
        cases += [dict(base, shards=s) for s in (2, 4)]
    for name, params in CHANNEL.items():
        ch = channel_lib.make_channel(name, **params)
        attempting = [rng.random(N) < 0.3 for _ in range(3)]
        epochs = [np_of(ch.epoch_draw(g, N)) for _ in range(3)]
        if name == "aloha":
            attempting[0] = np.isin(np.arange(N), ALOHA_ATTEMPT)
            epochs[0] = np.array([ALOHA_CHOICE.get(i, 3) for i in range(N)], np.int64)
        base = dict(kind="channel", n=N, name=name, params=params, init=np_of(ch.init_draw(rng, N)),
                    attempting=attempting, epochs=epochs)
        cases += [dict(base, shards=s) for s in (2, 4)]
    return cases


def fedavg_cases():
    rng = np.random.default_rng(5)
    leaves = lambda k: {n: rng.standard_normal((k,) + s).astype(np.float32) for n, s in RAGGED.items()}
    cases = []
    for shards in SHARDS:
        for inf in (False, True):
            cap_loc = min(3, N // shards)
            old, old_mask = leaves(N), rng.random(N) < 0.4
            if inf:  # a non-uploading old carrier of the last shard holds an Inf
                row = N - 2
                old_mask[row] = False
                old["d"][row, 5] = np.inf
            cases.append(dict(
                kind="fedavg", shards=shards, n=N, inf=inf, old=old, old_mask=old_mask,
                slabs=[leaves(cap_loc) for _ in range(shards)],
                slab_masks=[rng.random(cap_loc) < 0.6 for _ in range(shards)],
                fallback={k: v[0] for k, v in leaves(1).items()},
            ))
    return cases


def refusal_case():
    return dict(kind="refuse", shards=4, n=N)  # N + 2 clients over 4 shards


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    cases = selection_cases() + scenario_cases() + fedavg_cases() + [refusal_case()]
    results = worker.run_job(cases, tmp_path_factory.mktemp("fleet_units"))
    return cases, results


def gathered(results, i, shards):
    """Case ``i``'s outputs of the ranks of its group, in rank order."""
    return [results[r][i] for r in range(shards)]


def cat(parts):
    if parts[0] is None:
        assert all(p is None for p in parts)
        return None
    if isinstance(parts[0], dict):
        return {k: cat([p[k] for p in parts]) for k in parts[0]}
    return torch.cat(parts) if parts[0].dim() else parts[0]


def assert_same(got, want, what):
    if want is None or got is None:
        assert got is None and want is None, what
    elif isinstance(want, dict):
        assert got.keys() == want.keys(), what
        for k in want:
            assert_same(got[k], want[k], f"{what}.{k}")
    else:
        assert got.dtype == want.dtype and torch.equal(got, want), f"{what}: {got} != {want}"


@pytest.mark.parametrize("shards", SHARDS)
@pytest.mark.parametrize("policy", POLICIES)
def test_sharded_selection_equals_solo_and_reference(job, policy, shards):
    cases, results = job
    seen = set()
    for i, c in enumerate(cases):
        if c["kind"] != "select" or c["policy"] != policy or c["shards"] != shards:
            continue
        seen.add((c["k"], c["ages"]))
        got = torch.cat(gathered(results, i, shards))
        solo = worker.select(c, 0, N, None)
        assert torch.equal(got, solo), (c["k"], c["ages"])
        if policy in ("vaoi", "vaoi_soft") and c["ages"] != "exact_ties":
            assert int(got.sum()) == min(c["k"], N)
        if c["ages"] == "exact_ties":  # equal scores: the lowest indices win, as lax.top_k's tie-break
            if policy in ("vaoi", "vaoi_soft"):
                assert got.nonzero().flatten().tolist() == list(range(min(c["k"], N)))
            continue
        if c["k"] > N:  # lax.top_k refuses k > N; the port selects everyone, as its solo path
            continue
        spec = jpol.make_policy(policy, num_clients=N, k=c["k"])
        key, age = jnp.asarray(c["key"]), jnp.asarray(c["age"])
        want = np.asarray(jpol.epoch_selection(spec, age, c["t"], c["k"], key))
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"k={c['k']} ages={c['ages']}")
        if policy == "vaoi":
            np.testing.assert_array_equal(got.numpy(), np.asarray(jvaoi.select_topk(age, c["k"], key)))
        elif policy == "vaoi_soft":
            np.testing.assert_array_equal(got.numpy(), np.asarray(jvaoi.select_gumbel(age, c["k"], key)))
    assert seen == {(k, a) for k in k_values(shards) for a in AGES}


SCENARIOS = [("harvest", n) for n in HARVEST] + [("stream", n) for n in STREAM] + [("channel", n) for n in CHANNEL]


@pytest.mark.parametrize("kind,name", SCENARIOS, ids=[f"{k}-{n}" for k, n in SCENARIOS])
def test_sharded_scenario_equals_global(job, kind, name):
    cases, results = job
    checked = 0
    for i, c in enumerate(cases):
        if c["kind"] != kind or c["name"] != name:
            continue
        want = getattr(worker, kind)(c, 0, N, None)
        got = cat(gathered(results, i, c["shards"]))
        assert_same(got, want, f"{kind} {name} at {c['shards']} shards")
        checked += 1
    assert checked == 2


def test_aloha_collision_spans_shards(job):
    """Clients 1 and 9 collide on channel 0 from shards 0 and 2: the fleet
    drops both, as the global channel does; each shard alone would have
    delivered its one."""
    cases, results = job
    (i, c), = [(i, c) for i, c in enumerate(cases) if c["kind"] == "channel" and c["name"] == "aloha"
               and c["shards"] == 4]
    got = torch.cat([r["delivered0"] for r in gathered(results, i, 4)])
    assert got.nonzero().flatten().tolist() == [5, 14]
    alone = torch.cat([worker.channel(c, r * 4, 4, None)["delivered0"] for r in range(4)])
    assert alone.nonzero().flatten().tolist() == [1, 5, 9, 14]


def jax_tree(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


@pytest.mark.parametrize("path", ["plain", "pallas"])
@pytest.mark.parametrize("shards", SHARDS)
def test_sharded_fedavg_matches_reference(job, shards, path):
    cases, results = job
    for i, c in enumerate(cases):
        if c["kind"] != "fedavg" or c["shards"] != shards:
            continue
        slab = {k: np.concatenate([s[k] for s in c["slabs"]]) for k in RAGGED}
        slab_mask = np.concatenate(c["slab_masks"])
        want_c = jsim._compact_mean(jax_tree(slab), jnp.asarray(slab_mask), jax_tree(c["old"]),
                                    jnp.asarray(c["old_mask"]), jax_tree(c["fallback"]), use_kernel=path == "pallas")
        masked = jsim._masked_mean_kernel if path == "pallas" else jsim._masked_mean
        want_d = masked(jax_tree(c["old"]), jnp.asarray(c["old_mask"]), jax_tree(c["fallback"]))
        ranks = gathered(results, i, shards)
        for r, got in enumerate(ranks):  # every rank holds the same global model
            assert all(torch.allclose(got[k], ranks[0][k], rtol=0, atol=0, equal_nan=True) for k in got), r
        for prefix, want in (("compact", want_c), ("dense", want_d)):
            for k in RAGGED:
                g, w = ranks[0][f"{prefix}_{k}"].numpy(), np.asarray(want[k])
                np.testing.assert_array_equal(np.isnan(g), np.isnan(w), err_msg=f"{prefix} {k} NaN columns")
                if c["inf"] and k == "d":
                    assert np.isnan(g).sum() == 1 and np.isnan(g[5])
                else:
                    assert not np.isnan(g).any()
                np.testing.assert_allclose(g, w, rtol=0, atol=FEDAVG_TOL, err_msg=f"{prefix} {k}")


def test_run_fleet_refuses_an_uneven_fleet(job):
    cases, results = job
    (i,) = [i for i, c in enumerate(cases) if c["kind"] == "refuse"]
    for r in range(4):
        assert results[r][i] == f"num_clients={N + 2} must divide over 4 shards"


@pytest.mark.parametrize("how,timeout_s", [("raise", 300.0), ("hang", 6.0)])
def test_a_failing_or_hung_rank_fails_the_fleet(how, timeout_s):
    """A rank that raises fails the fleet as soon as it does (its peer,
    blocked in a collective, is ended), long before the deadline; a rank
    that never reaches the collective fails it on the timeout, not after an
    unbounded wait.  The deadline counts the ranks' start, which takes
    seconds on a loaded host, so only the hang case runs into it."""
    import time

    t0 = time.monotonic()
    with pytest.raises((torch.multiprocessing.ProcessRaisedException, TimeoutError)) as info:
        mesh.spawn_fleet(worker.fail_or_hang, 2, "gloo", args=(how,), timeout_s=timeout_s)
    elapsed = time.monotonic() - t0
    if how == "raise":  # rank 1's error, or rank 0's from the collective its peer left
        assert isinstance(info.value, torch.multiprocessing.ProcessRaisedException)
        assert elapsed < timeout_s / 2
    else:
        assert elapsed < 60


def test_refusals(monkeypatch):
    with pytest.raises(ValueError, match="num_clients=10 must divide over 4 shards"):
        fleet.shard_size(10, 4)
    with pytest.raises(RuntimeError, match="initialized torch.distributed process group"):
        fleet.run_fleet(EHFLConfig(num_clients=4), None, {}, device="cpu")
    assert mesh.fleet_shards(100, 8) == 5 and mesh.fleet_shards(16, 4) == 4 and mesh.fleet_shards(7, 4) == 1
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(ValueError, match="no CUDA device"):
        mesh.fleet_shards(16)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    assert mesh.fleet_shards(16) == 2


def test_shard_and_gather_carry_round_trip():
    """``shard_carry`` then ``gather_carry`` is the carry; the fleet's
    born-sharded ``init_carry`` rows equal the solo carry's (rank by rank,
    through the solo ``init_carry``'s ``rows``)."""
    from repro_torch.configs import CNNConfig
    from repro_torch.core import simulator as sim
    from repro_torch.fl import cnn_backend

    cfg = EHFLConfig(num_clients=8, harvest="hetero", stream="drift", channel="fading", slots_per_epoch=4, kappa=2)
    backend = cnn_backend(CNNConfig(**worker.TINY))
    carry = sim.init_carry(cfg, backend, "cpu")
    parts = [fleet.shard_carry(cfg, carry, r, 4) for r in range(4)]
    assert parts[1].age.shape == (2,) and parts[1].msg_params["fc0_w"].shape[0] == 2
    assert parts[1].global_params is carry.global_params
    back = fleet.gather_carry(cfg, parts)
    for f in carry._fields:
        assert_same(sim._tree_map(lambda x: x, getattr(back, f)), getattr(carry, f), f)
    for r in range(4):
        born = sim.init_carry(cfg, backend, "cpu", rows=(2 * r, 2))
        for f in ("harvest", "stream", "channel", "age", "h"):
            assert_same(getattr(born, f), getattr(parts[r], f), f"rank {r} {f}")
