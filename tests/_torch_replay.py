"""Replay the JAX package's key chains into the port's draw sources.

The reference draws inside its epoch (``epoch_body``'s ``split(carry.key,
4)``: the Alg. 2 tie-break, the Bernoulli slot chain, the per-client SGD
permutations) and inside its scenario processes, each of which carries its
own key: ``init_carry`` splits one off for the harvest process, then the
stream, then the channel.  These helpers walk the same chains and return
the draws as numpy arrays for ``repro_torch.core.ReplayDraws``.  Every
``bernoulli(k, p, shape)`` of the reference is ``uniform(k, shape) < p``,
so the scenarios' draws are those uniforms; Beta and Dirichlet draws are
taken as values from the reference's initial state.
"""
import jax
import jax.numpy as jnp
import numpy as np

from repro.core import init_carry
from repro_torch.core import InitDraws, ReplayDraws


def scenario_keys(cfg, num_classes: int, seed: int):
    """(k_run, k_harvest, k_stream, k_channel) as ``init_carry`` splits them;
    None for a scenario that takes no key."""
    _, k_run = jax.random.split(jax.random.PRNGKey(seed))
    keys = []
    for persistent in (
        cfg.harvest_process().persistent,
        cfg.data_stream(num_classes).persistent,
        cfg.channel_process().persistent,
    ):
        k = None
        if persistent:
            k_run, k = jax.random.split(k_run)
        keys.append(k)
    return (k_run, *keys)


def harvest_init_draw(name: str, k_harvest, state, n: int):
    """What the port's ``init`` takes: markov's phase uniforms, hetero's rates."""
    if name == "markov":
        return np.asarray(jax.random.uniform(jax.random.split(k_harvest)[0], (n,)))
    if name == "hetero":
        return np.asarray(state[0])
    return None


def stream_init_draw(name: str, state):
    return np.asarray(state[0]) if name == "drift" else None


def channel_init_draw(name: str, k_channel, state, n: int):
    if name == "erasure":
        return np.asarray(state[0])
    if name == "fading":
        return np.asarray(jax.random.uniform(jax.random.split(k_channel)[0], (n,)))
    return None


def state_key(state):
    """The key a reference scenario state carries (its last leaf)."""
    return state[-1] if isinstance(state, tuple) else state


def harvest_epoch(name: str, key, S: int, n: int):
    """One epoch of a persistent harvest process's per-slot draws from its
    key: (2, S, N) for markov, (S, N) otherwise; and the next key."""
    u = []
    for _ in range(S):
        if name == "markov":
            k_arr, k_flip, key = jax.random.split(key, 3)
            u.append(jnp.stack([jax.random.uniform(k_arr, (n,)), jax.random.uniform(k_flip, (n,))]))
        else:
            k1, key = jax.random.split(key)
            u.append(jax.random.uniform(k1, (n,)))
    return jnp.stack(u, axis=-2), key


def stream_epoch(name: str, key, n: int, n_pool: int):
    if name == "arrival":
        k_hit, k_extra, key = jax.random.split(key, 3)
        return jnp.stack([jax.random.uniform(k_hit, (n,)), jax.random.uniform(k_extra, (n,))]), key
    k_view, key = jax.random.split(key)
    return jax.random.uniform(k_view, (n, n_pool)), key


def channel_epoch(name: str, key, n: int, num_channels: int = 2):
    k, key = jax.random.split(key)
    if name == "aloha":
        return jax.random.randint(k, (n,), 0, max(1, int(num_channels))), key
    return jax.random.uniform(k, (n,)), key


def replay_draws(cfg, backend, n_samples: int, seed: int | None = None) -> ReplayDraws:
    """Every draw ``repro.core.simulator`` consumes in ``cfg.epochs`` epochs
    of ``run_simulation(replace(cfg, seed=seed))``, for the port."""
    seed = cfg.seed if seed is None else seed
    N, S = cfg.num_clients, cfg.slots_per_epoch
    m = cfg.kappa * max(1, n_samples // cfg.kappa)
    carry0 = init_carry(cfg, backend, seed)
    k_run, k_h, k_s, k_c = scenario_keys(cfg, backend.num_classes, seed)
    hname, sname, cname = cfg.harvest, cfg.stream, cfg.channel
    num_channels = dict(cfg.channel_params).get("num_channels", 2)
    init = InitDraws(
        harvest_init_draw(hname, k_h, carry0.harvest, N),
        stream_init_draw(sname, carry0.stream),
        channel_init_draw(cname, k_c, carry0.channel, N),
    )

    @jax.jit
    def one(key, hkey, skey, ckey):
        k_sel, k_scan, k_train, k_next = jax.random.split(key, 4)
        if cfg.policy == "vaoi_soft":
            noise = jax.random.gumbel(k_sel, (N,))
        else:
            noise = jax.random.uniform(k_sel, (N,), minval=0.0, maxval=1e-3)
        if hkey is None:  # bernoulli: the slot chain re-seeded from k_scan

            def slot(hk, _):
                k1, k2 = jax.random.split(hk)
                return k2, jax.random.bernoulli(k1, cfg.p_bc, (N,))

            _, harvest = jax.lax.scan(slot, k_scan, None, length=S)
        else:
            harvest, hkey = harvest_epoch(hname, hkey, S, N)
        perms = jax.vmap(lambda k: jax.random.permutation(k, n_samples)[:m])(jax.random.split(k_train, N))
        stream = channel = None
        if skey is not None:
            stream, skey = stream_epoch(sname, skey, N, n_samples)
        if ckey is not None:
            channel, ckey = channel_epoch(cname, ckey, N, num_channels)
        return (noise, harvest, perms, stream, channel), (k_next, hkey, skey, ckey)

    keys = (
        carry0.key,
        None if k_h is None else state_key(carry0.harvest),
        None if k_s is None else state_key(carry0.stream),
        None if k_c is None else state_key(carry0.channel),
    )
    rows = []
    for _ in range(cfg.epochs):
        draws, keys = one(*keys)
        rows.append(draws)
    cols = [None if rows[0][i] is None else np.stack([np.asarray(r[i]) for r in rows]) for i in range(5)]
    return ReplayDraws(*cols, init=init)
