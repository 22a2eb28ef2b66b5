"""The port's scenario modules against the JAX package's: every harvest
process (``core/harvest.py``), data stream (``data/stream.py``) and channel
(``core/channel.py``), plus ``apply_view`` and ``_sample_weighted``.

Each case walks the reference's own key chain for several steps and feeds
the same draws to the port (``tests/_torch_replay.py``).  Charges, phases,
clocks, view indices and delivery masks must be equal exactly; the injected
float state (Beta rates, Dirichlet mixtures) bit for bit."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from _torch_replay import (  # noqa: E402
    channel_epoch,
    channel_init_draw,
    harvest_epoch,
    harvest_init_draw,
    state_key,
    stream_epoch,
    stream_init_draw,
)
from repro.core import channel as jchannel  # noqa: E402
from repro.core import harvest as jharvest  # noqa: E402
from repro.data import stream as jstream  # noqa: E402
from repro_torch.core import channel as tchannel  # noqa: E402
from repro_torch.core import harvest as tharvest  # noqa: E402
from repro_torch.data import stream as tstream  # noqa: E402

N, S, EPOCHS = 16, 10, 4

@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Hundreds of small ops per epoch: one intra-op thread each (before the
    module's fixtures run), so that parallel test workers do not
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t(x):
    return torch.from_numpy(np.array(x))


def same(got: torch.Tensor, want, what: str):
    got, want = got.numpy(), np.asarray(want)
    assert got.dtype == want.dtype or (got.dtype.kind == want.dtype.kind == "i"), (what, got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want, err_msg=what)


# ---------------------------------------------------------------------------
# harvest
# ---------------------------------------------------------------------------

HARVEST = {
    # non-degenerate parameters: markov's phases flip both ways, diurnal
    # crosses day and night (and runs its base-rate branch), hetero's rates spread
    "bernoulli": dict(p_bc=0.3),
    "markov": dict(p_bc=0.3, p_on=0.6, sojourn=3.0),
    "diurnal": dict(p_bc=0.2, period=7.0),
    "diurnal_base": dict(p_bc=0.8, period=13.0, day_frac=0.3),
    "hetero": dict(p_bc=0.3, concentration=1.5),
}


@pytest.mark.parametrize("case", list(HARVEST))
def test_harvest_process_matches_reference(case):
    name = case.split("_")[0]
    params = HARVEST[case]
    jproc, tproc = jharvest.make_process(name, **params), tharvest.make_process(name, **params)
    assert (jproc.persistent, jproc.mean_rate) == (tproc.persistent, tproc.mean_rate)
    battery = jnp.zeros((N,), jnp.int32)
    key = jax.random.PRNGKey(7)
    jstate = jproc.init(key, N)
    if tproc.persistent:
        carried = tproc.init(None if (d := harvest_init_draw(name, key, jstate, N)) is None else t(d), N)
        hkey = state_key(jstate)
    n_on = 0
    for epoch in range(EPOCHS):
        if tproc.persistent:
            u, hkey = harvest_epoch(name, hkey, S, N)
            tstate = tharvest.begin(carried, t(u), N, S)
        else:  # bernoulli re-seeds from the epoch's key: replay its bits
            jstate = jproc.init(jax.random.fold_in(key, epoch), N)
            bits, k = [], jstate
            for _ in range(S):
                k1, k = jax.random.split(k)
                bits.append(np.asarray(jax.random.bernoulli(k1, params["p_bc"], (N,))))
            tstate = tproc.init(t(np.stack(bits)), N)
        for s in range(S):
            jc, jstate = jproc.step(jstate, battery)
            tc, tstate = tproc.step(tstate, torch.zeros(N, dtype=torch.int32))
            same(tc, jc, f"{case} charge, epoch {epoch} slot {s}")
            n_on += int(tc.sum())
        if tproc.persistent:
            carried = tstate[0]
            if name == "diurnal":
                assert carried == int(jstate[0])
            else:  # markov phases (bool), hetero rates (float32 bits)
                same(carried, jstate[0], f"{case} state, epoch {epoch}")
    assert 0 < n_on < EPOCHS * S * N  # the comparison saw both outcomes


# ---------------------------------------------------------------------------
# streams
# ---------------------------------------------------------------------------

STREAMS = {
    "static": {},
    "drift": dict(alpha=0.5, period=3.0),
    "arrival": dict(rate=3.0, burst=2.5, window=5),
    "shift": dict(period=2, num_phases=3),
}
N_POOL, C = 20, 10


@pytest.mark.parametrize("name", list(STREAMS))
def test_stream_matches_reference(name):
    params = STREAMS[name]
    jsm, tsm = jstream.make_stream(name, **params), tstream.make_stream(name, **params)
    assert jsm.persistent == tsm.persistent
    key = jax.random.PRNGKey(3)
    labels = jax.random.randint(jax.random.PRNGKey(4), (N, N_POOL), 0, C)
    images = jax.random.normal(jax.random.PRNGKey(5), (N, N_POOL, 2, 2, 1))
    jstate = jsm.init(key, N)
    tstate = tsm.init(None if (d := stream_init_draw(name, jstate)) is None else t(d), N)
    skey = state_key(jstate) if jsm.persistent else None
    for epoch in range(EPOCHS + 2):
        jidx, jstate = jsm.step(jstate, jnp.int32(epoch), labels)
        u = None
        if skey is not None:
            u, skey = stream_epoch(name, skey, N, N_POOL)
            u = t(u)
        tidx, tstate = tsm.step(tstate, epoch, t(labels).long(), u)
        if jidx is None:
            assert tidx is None
            continue
        same(tidx, np.asarray(jidx).astype(np.int64), f"{name} view, epoch {epoch}")
        jim, jlab = jstream.apply_view(jidx, images, labels)
        tim, tlab = tstream.apply_view(tidx, t(images), t(labels).long())
        same(tim, jim, f"{name} view images")
        same(tlab, np.asarray(jlab).astype(np.int64), f"{name} view labels")
        if name in ("drift", "arrival"):  # pi (float32 bits), arrival counts
            same(tstate, jstate[0], f"{name} state, epoch {epoch}")
        if name == "drift":  # the rotated mixture, bit for bit
            want = jstream.rotate_mixture(jstate[0], jnp.int32(epoch), params["period"])
            same(tstream.rotate_mixture(tstate, epoch, params["period"]), want, f"mixture, epoch {epoch}")


def test_apply_view_matches_reference():
    idx = jax.random.randint(jax.random.PRNGKey(0), (N, N_POOL), 0, N_POOL)
    images = jax.random.normal(jax.random.PRNGKey(1), (N, N_POOL, 4, 4, 3))
    labels = jax.random.randint(jax.random.PRNGKey(2), (N, N_POOL), 0, C)
    jim, jlab = jstream.apply_view(idx, images, labels)
    tim, tlab = tstream.apply_view(t(idx).long(), t(images), t(labels).long())
    same(tim, jim, "images")
    same(tlab, np.asarray(jlab).astype(np.int64), "labels")
    ti, tl = t(images), t(labels)
    assert all(a is b for a, b in zip(tstream.apply_view(None, ti, tl), (ti, tl)))  # the identity view


@pytest.mark.parametrize("weights", ["dirichlet", "zero_rows", "sparse"])
def test_sample_weighted_matches_reference(weights):
    """The inverse CDF over explicit uniforms, including the uniform
    fallback of rows whose weights sum to <= 1e-12."""
    k_w, k_u = jax.random.split(jax.random.PRNGKey(11))
    n, n_pool = 32, 40
    w = jax.random.dirichlet(k_w, jnp.full((n_pool,), 0.3), (n,)).astype(jnp.float32)
    if weights == "zero_rows":
        w = w.at[::3].set(0.0).at[1].set(1e-14)
    elif weights == "sparse":
        w = (w > 0.05).astype(jnp.float32)
    want = jstream._sample_weighted(k_u, w)
    got = tstream._sample_weighted(t(jax.random.uniform(k_u, (n, n_pool))), t(w))
    same(got, np.asarray(want).astype(np.int64), weights)
    if weights == "zero_rows":  # the fallback spreads over the whole pool
        assert len(np.unique(got[::3].numpy())) > n_pool // 2


# ---------------------------------------------------------------------------
# channels
# ---------------------------------------------------------------------------

CHANNELS = {
    "ideal": {},
    "erasure": dict(p_loss=0.3),
    "erasure_beta": dict(p_loss=0.3, concentration=1.0),
    "aloha": dict(num_channels=3),
    "fading": dict(p_bad=0.4, sojourn=2.0),
}


@pytest.mark.parametrize("case", list(CHANNELS))
def test_channel_matches_reference(case):
    name, params = case.split("_")[0], CHANNELS[case]
    jch, tch = jchannel.make_channel(name, **params), tchannel.make_channel(name, **params)
    assert jch.persistent == tch.persistent
    key = jax.random.PRNGKey(5)
    jstate = jch.init(key, N)
    tstate = tch.init(None if (d := channel_init_draw(name, key, jstate, N)) is None else t(d), N)
    ckey = state_key(jstate) if jch.persistent else None
    n_lost = 0
    for epoch in range(3 * EPOCHS):
        attempting = jax.random.uniform(jax.random.PRNGKey(100 + epoch), (N,)) < 0.6
        jdel, jstate = jch.step(jstate, attempting)
        u = None
        if ckey is not None:
            u, ckey = channel_epoch(name, ckey, N, params.get("num_channels", 2))
            u = t(u).long() if name == "aloha" else t(u)
        tdel, tstate = tch.step(tstate, t(attempting), u)
        same(tdel, jdel, f"{case} delivered, epoch {epoch}")
        n_lost += int((t(attempting) & ~tdel).sum())
        if name in ("erasure", "fading"):  # rates (float32 bits), link phases
            same(tstate, jstate[0], f"{case} state, epoch {epoch}")
    assert (n_lost == 0) == (name == "ideal")
