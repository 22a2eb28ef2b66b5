"""Alg. 1, the full EHFL loop, in eager PyTorch.

The counterpart of ``repro.core.simulator``: all per-client state is stacked
on a leading N axis (batteries, ages, pending flags, feature moments and
model parameters); epochs and slots are Python loops; local training is
kappa-step SGD batched over clients with ``torch.func.vmap``, over the
*active set only* under the default compaction (the started clients are
gathered into a ``PolicySpec.max_active``-lane slab); FedAvg goes through
the ``fedavg_reduce`` kernel and Eq. 5 + Eq. 7 through ``vaoi_distance``.
On CUDA tensors those are the Hopper kernels; on CPU tensors their plain
versions (``kernels.ops``).  Random draws come from a ``core.draws`` source.
The scenario axes (``core.harvest``, ``data.stream``, ``core.channel``)
and the retry machine for lost uploads run as in the reference;
:func:`run_batch` is the seed axis.  ``core.fleet.run_fleet`` runs the same
:func:`epoch_body` with the client axis split over a ``torch.distributed``
group: only the :class:`EpochOps` points differ from the solo path.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, replace
from typing import Any, Callable, Dict, List, NamedTuple, Sequence, Tuple

import numpy as np
import torch
from torch.func import vmap
from torch.profiler import record_function

from repro_torch.core import channel as channel_lib
from repro_torch.core import energy as energy_lib
from repro_torch.core import harvest as harvest_lib
from repro_torch.core import policies as policy_lib
from repro_torch.core.draws import DrawSource, EpochDraws, TorchDraws, sgd_batch_size, shard_draws
from repro_torch.data import stream as stream_lib
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.optim import sgd_update

Params = Dict[str, torch.Tensor]


@dataclass(frozen=True)
class EHFLConfig:
    num_clients: int = 100
    epochs: int = 500
    slots_per_epoch: int = 30  # S
    kappa: int = 20  # training cost in slots == battery units
    p_bc: float = 0.1  # mean harvest rate (Bernoulli probability, Eq. 3)
    k: int = 10  # selection budget (Alg. 2)
    mu: float = 0.5  # VAoI significance threshold
    lr: float = 0.01  # SGD gamma
    probe_size: int = 30  # |B_i| for the proxy forward pass
    e_max: int = 25  # kappa + 5
    policy: str = "vaoi"
    num_groups: int = 0  # FedBacys group count G (0 = default N // k)
    alpha: float = 0.1  # Dirichlet concentration (data partition)
    seed: int = 0
    eval_every: int = 10
    aux_note: str = ""
    # scenario axes: (name, value) tuples keep the config frozen/hashable
    harvest: str = "bernoulli"
    harvest_params: Tuple[Tuple[str, float], ...] = ()
    stream: str = "static"
    stream_params: Tuple[Tuple[str, float], ...] = ()
    channel: str = "ideal"
    channel_params: Tuple[Tuple[str, float], ...] = ()
    # retry machine for failed uploads: a failed carrier re-queues with
    # capped exponential backoff (skip min(2^(attempts-1), backoff_cap)
    # epochs) and is dropped after max_retries failures
    max_retries: int = 3
    backoff_cap: int = 8
    # active-set compaction: "auto" compacts whenever the policy's slab is
    # smaller than N; False forces the dense path
    compact: Any = "auto"  # bool | "auto"

    def harvest_process(self) -> harvest_lib.HarvestProcess:
        return harvest_lib.make_process(self.harvest, p_bc=self.p_bc, **dict(self.harvest_params))

    def data_stream(self, num_classes: int | None = None) -> stream_lib.DataStream:
        """``num_classes`` is the dataset's class count (the simulator passes
        ``backend.num_classes``); an explicit ``stream_params`` entry wins."""
        params = dict(self.stream_params)
        if num_classes is not None and self.stream in stream_lib.CLASS_CONDITIONED:
            params.setdefault("num_classes", num_classes)
        return stream_lib.make_stream(self.stream, **params)

    def channel_process(self) -> channel_lib.ChannelProcess:
        return channel_lib.make_channel(self.channel, **dict(self.channel_params))


class Backend(NamedTuple):
    """Model plug-in for the simulator."""

    init: Callable[[torch.Generator, torch.device], Params]
    grad_loss: Callable[[Params, torch.Tensor, torch.Tensor], Tuple[torch.Tensor, Params]]
    feature: Callable[[Params, torch.Tensor], torch.Tensor]  # (params, inputs) -> (F,)
    probe: Callable[[Params, torch.Tensor], torch.Tensor]  # shared params, (N, b, ...) -> (N, F)
    predict: Callable[[Params, torch.Tensor], torch.Tensor]
    feature_dim: int
    num_classes: int


class EpochCarry(NamedTuple):
    global_params: Params
    msg_params: Params  # (N, ...) stacked messages
    h: torch.Tensor  # (N, F) historical moments
    age: torch.Tensor  # (N,) float32
    battery: torch.Tensor  # (N,) int32
    pending: torch.Tensor  # (N,) bool
    counter: torch.Tensor  # (N,) int32
    # carried scenario state (None for the stateless defaults): the harvest
    # process's, the stream's and the channel's
    harvest: Any = None
    stream: Any = None
    # retry machine: failed delivery attempts of the pending message, and
    # epochs left to sit out before re-contending; all-zero on ``ideal``
    retries: Any = None  # (N,) int32
    backoff: Any = None  # (N,) int32
    channel: Any = None


def _local_train(
    params: Params,
    images: torch.Tensor,
    labels: torch.Tensor,
    perms: torch.Tensor,
    cfg: EHFLConfig,
    backend: Backend,
    with_feature: bool = True,
) -> Tuple[Params, torch.Tensor | None]:
    """BATCHTRAIN (Alg. 1 lines 23-29) for B clients at once: kappa
    minibatch SGD steps over one permutation pass each, starting from the
    shared ``params``; accumulates the Eq. (6) historical moment.

    images (B, n, ...), labels (B, n), perms (B, kappa*bs).  The feature is
    taken after each step's update, on that step's batch.
    ``with_feature=False`` (non-VAoI policies) skips the feature forward and
    returns ``None`` for the moment.  Each step's stages are
    ``ehfl.local_train.*`` ranges (``batch``, ``grad``, ``update``,
    ``feature``), so a trace can put the device's idle down to a stage."""
    b, n = images.shape[:2]
    bs = sgd_batch_size(cfg.kappa, n)
    p = {k: v.unsqueeze(0).expand((b,) + v.shape).contiguous() for k, v in params.items()}
    rows = torch.arange(b, device=images.device).unsqueeze(1)
    grad_fn = vmap(backend.grad_loss)
    feat_fn = vmap(backend.feature)
    fsum = torch.zeros(b, backend.feature_dim, device=images.device) if with_feature else None
    for j in range(cfg.kappa):
        with record_function("ehfl.local_train.batch"):
            idx = perms[:, j * bs : (j + 1) * bs]
            imgs, lbls = images[rows, idx], labels[rows, idx]
        with record_function("ehfl.local_train.grad"):
            _, grads = grad_fn(p, imgs, lbls)
        with record_function("ehfl.local_train.update"):
            p = sgd_update(p, grads, cfg.lr)
        if with_feature:
            with record_function("ehfl.local_train.feature"):
                fsum = fsum + feat_fn(p, imgs) * bs  # batch-mean feature of w^(t,b+1)
    return p, fsum / (cfg.kappa * bs) if with_feature else None


def unflatten_clients(vec: torch.Tensor, aux: List[Tuple[str, torch.Size, torch.dtype]]) -> Params:
    """One aggregated (P,) vector back into the {name: tensor} dict (views
    where the dtype is the vector's)."""
    parts = vec.split([int(np.prod(shape, dtype=np.int64)) for _, shape, _ in aux])
    return {name: part.view(shape).to(dtype) for (name, shape, dtype), part in zip(aux, parts)}


def _identity(x: torch.Tensor) -> torch.Tensor:
    return x


def leaf_mean(
    stacks: Sequence[Params], weights: Sequence[torch.Tensor], reduce_sum: Callable = _identity,
    count: torch.Tensor | None = None,
) -> Params:
    """Σ_g Σ_k weights[g][k]·stacks[g][name][k] for every leaf name of the
    stacked {name: (K_g, ...)} dicts, in fp32, divided by ``count`` (at
    least 1) when given, then rounded to each leaf's dtype.  The leaves go
    to ``fedavg_reduce_leaves`` in sorted-name order (the columns of the
    reference's ``flatten_clients``), read in place, one call per leaf dtype
    (a launch reads one dtype: an MoE model keeps its router in fp32 beside
    bf16 weights); ``reduce_sum`` folds each call's (P,) partial."""
    names = sorted(stacks[0])
    out = {}
    for dtype in dict.fromkeys(stacks[0][n].dtype for n in names):
        part = [n for n in names if stacks[0][n].dtype == dtype]
        vec = reduce_sum(kops.fedavg_reduce_leaves([([s[n] for n in part], w) for s, w in zip(stacks, weights)]))
        if count is not None:
            vec = vec / count.clamp(min=1.0)
        out.update(unflatten_clients(vec, [(n, stacks[0][n].shape[1:], dtype) for n in part]))
    return {n: out[n] for n in names}


def _keep_if_empty(mean: Params, cnt: torch.Tensor, fallback: Params) -> Params:
    # no upload this epoch -> the global model stays as it was
    keep = cnt > 0
    return {k: torch.where(keep, mean[k], fallback[k]) for k in mean}


def _masked_mean(
    stacked: Params, mask: torch.Tensor, fallback: Params, reduce_sum: Callable = _identity
) -> Params:
    """FedAvg over the masked clients through ``fedavg_reduce`` over the
    leaves (one launch a leaf dtype, :func:`leaf_mean`) with normalized
    mask weights; ``fallback`` when nobody uploaded.  ``reduce_sum`` folds
    a shard's partial count and (P,) sum into fleet totals (the fleet's
    all-reduce; default: this is the whole client axis); the count is
    folded before the weights are formed."""
    w = mask.float()
    cnt = reduce_sum(w.sum())
    return _keep_if_empty(leaf_mean([stacked], [w / cnt.clamp(min=1.0)], reduce_sum), cnt, fallback)


def _compact_mean(
    slab: Params, slab_mask: torch.Tensor, old: Params, old_mask: torch.Tensor, fallback: Params,
    reduce_sum: Callable = _identity,
) -> Params:
    """FedAvg for the compacted path: this epoch's fresh uploads live in the
    (cap, ...) training slab (``slab_mask``), while carriers of an OLD
    message upload it from the N-wide ``old`` dict (``old_mask``).  One
    ``fedavg_reduce`` launch (a leaf dtype) reduces both groups, read in
    place, and adds them (slab + old); they share one count.
    ``reduce_sum`` as in :func:`_masked_mean`: a shard's (slab + old)
    partial is folded whole."""
    ws, wo = slab_mask.float(), old_mask.float()
    cnt = reduce_sum(ws.sum() + wo.sum())
    return _keep_if_empty(leaf_mean([slab, old], [ws, wo], reduce_sum, count=cnt), cnt, fallback)


def resolve_compact_cap(cfg: EHFLConfig, spec: policy_lib.PolicySpec) -> int | None:
    """The static training-slab size for this (config, policy), or ``None``
    for the dense path (fedavg's slab would be the whole fleet)."""
    # identity checks: `0 in (True, False, "auto")` is True (0 == False)
    if cfg.compact is False:
        return None
    if cfg.compact is not True and cfg.compact != "auto":
        raise ValueError(f"compact must be True, False or 'auto'; got {cfg.compact!r}")
    cap = spec.max_active
    if cap <= 0 or cap >= cfg.num_clients:
        return None
    return cap


def _tree_map(fn: Callable[[torch.Tensor], Any], tree: Any) -> Any:
    """``fn`` on every tensor of a scenario state or carry (tuples, dicts,
    NamedTuples); other leaves (None, the diurnal clock) as they are."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        items = [_tree_map(fn, v) for v in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)
    return tree


def init_carry(
    cfg: EHFLConfig,
    backend: Backend,
    device: str | torch.device | None = None,
    params: Params | None = None,
    seed: int | None = None,
    draws: DrawSource | None = None,
    rows: Tuple[int, int] | None = None,
) -> EpochCarry:
    """Initial :class:`EpochCarry`.  ``params`` (e.g. the reference's init,
    through ``checkpoint.convert``) replaces the random init drawn from
    ``seed`` (default ``cfg.seed``).  The scenarios' carried state is built
    from ``draws.init`` (default ``TorchDraws(seed)``), harvest, then
    stream, then channel, as the reference splits its keys.  ``rows =
    (off, n)`` builds only clients ``[off, off + n)`` (a fleet shard, from
    its window of the global draws); default all N."""
    device = resolve_device(device)
    seed = cfg.seed if seed is None else seed
    off, n = rows or (0, cfg.num_clients)
    if params is None:
        params = backend.init(torch.Generator().manual_seed(seed), device)
    else:
        params = {k: v.to(device) for k, v in params.items()}  # each leaf keeps its dtype (a bf16 LM stays bf16)
    processes = (cfg.harvest_process(), cfg.data_stream(backend.num_classes), cfg.channel_process())
    init_draws = shard_draws((draws or TorchDraws(seed)).init(cfg, backend.num_classes), off, n)
    state = [
        _tree_map(lambda x: x.to(device), p.init(None if x is None else torch.as_tensor(x).to(device), n))
        if p.persistent
        else None
        for p, x in zip(processes, init_draws)
    ]
    zeros = lambda dtype: torch.zeros(n, dtype=dtype, device=device)
    return EpochCarry(
        global_params=params,
        msg_params={k: v.unsqueeze(0).expand((n,) + v.shape).contiguous() for k, v in params.items()},
        h=torch.zeros(n, backend.feature_dim, device=device),
        age=zeros(torch.float32),
        battery=zeros(torch.int32),
        pending=zeros(torch.bool),
        counter=zeros(torch.int32),
        harvest=state[0],
        stream=state[1],
        retries=zeros(torch.int32),
        backoff=zeros(torch.int32),
        channel=state[2],
    )


def _rows(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return mask.reshape((-1,) + (1,) * (like.dim() - 1))


class EpochOps(NamedTuple):
    """The shard-aware points of :func:`epoch_body`.  The solo defaults
    (:data:`SOLO_OPS`) work on the whole client axis; ``core.fleet``
    substitutes collectives, so one :func:`epoch_body` serves the solo and
    the client-sharded path.  The reference's ``train_keys`` point is, in
    the port, the fleet handing :func:`epoch_body` its window of the
    epoch's global draws (``core.draws.shard_draws``), and its
    ``masked_mean`` / ``compact_mean`` points are :func:`_masked_mean` /
    :func:`_compact_mean` with ``reduce_sum`` as their hook."""

    # (spec, age, t, k, noise) -> (n_loc,) selection mask
    select: Callable = policy_lib.epoch_selection
    # a shard's partial sum (a count, a (P,) FedAvg partial) -> the fleet's
    reduce_sum: Callable[[torch.Tensor], torch.Tensor] = _identity
    # the epoch's metrics: local sums (and the (n_loc,) ``selected``) ->
    # fleet-wide sums (and the (N,) ``selected``)
    reduce_metrics: Callable[[Dict[str, torch.Tensor]], Dict[str, torch.Tensor]] = _identity


SOLO_OPS = EpochOps()


@record_function("ehfl.epoch")
def epoch_body(
    carry: EpochCarry,
    t: int,
    images: torch.Tensor,
    labels: torch.Tensor,
    draws: EpochDraws,
    *,
    cfg: EHFLConfig,
    backend: Backend,
    spec: policy_lib.PolicySpec,
    process: harvest_lib.HarvestProcess,
    stream: stream_lib.DataStream,
    channel: channel_lib.ChannelProcess,
    ops: EpochOps = SOLO_OPS,
) -> Tuple[EpochCarry, Dict[str, torch.Tensor]]:
    """One epoch of Alg. 1 over the clients in ``carry``: all N, or one
    shard's n_loc when ``core.fleet`` drives it (``ops`` then carries the
    collectives, and ``images``, ``labels`` and ``draws`` are the shard's
    rows).  ``images``/``labels`` are the per-client sample pools, which
    ``stream`` turns into this epoch's view; ``channel`` decides which
    uploads land; ``draws`` are this epoch's random draws."""
    N, S, kappa = cfg.num_clients, cfg.slots_per_epoch, cfg.kappa
    n = carry.age.shape[0]  # the clients of this carry: N, or a shard's n_loc

    # --- per-epoch data view (the probe batch comes from it too) ---
    # (the ``ehfl.*`` ranges name the layers in a torch.profiler trace)
    stream_state = carry.stream
    if stream.persistent:
        with record_function("ehfl.stream"):
            idx, stream_state = stream.step(carry.stream, t, labels, draws.stream)
            images, labels = stream_lib.apply_view(idx, images, labels)

    # --- CLIENTSELECT (Alg. 2) on the freshly-broadcast global model ---
    with record_function("ehfl.select"):
        selected = ops.select(spec, carry.age, t, cfg.k, draws.noise)
    if spec.uses_vaoi:
        with record_function("ehfl.probe"):
            # one batched forward of the shared global model over all N·probe images
            v = backend.probe(carry.global_params, images[:, : cfg.probe_size])
        with record_function("ehfl.vaoi"):
            m, age = kops.vaoi_distance(v, carry.h, carry.age, selected.float(), cfg.mu)
    else:
        age = carry.age
        m = torch.zeros(n, device=age.device)

    # --- slot-level energy dynamics ---
    if process.persistent:
        hstate = harvest_lib.begin(carry.harvest, draws.harvest, n, S)
    else:
        hstate = process.init(draws.harvest, n)
    st0 = energy_lib.init_slot_state(n, carry.battery.device, battery=carry.battery, S=S)
    st0 = st0._replace(pending=carry.pending, counter=carry.counter, harvest=hstate)
    with record_function("ehfl.slot_scan"):
        st = energy_lib.scan_epoch(
            st0, S=S, kappa=kappa, e_max=cfg.e_max, process=process,
            want_fn=policy_lib.make_want_fn(spec, selected, S, kappa),
            count_opportunity_fn=policy_lib.make_opportunity_fn(spec, selected, S, kappa),
            # retry backoff holds a pending message (and its energy) for the epoch
            tx_allowed=carry.backoff == 0,
        )

    # --- uplink channel + retry machine ---
    # ``st.uploaded`` clients spent a transmission unit; the channel decides
    # whose message landed.  A failed carrier stays pending (an old-carrier
    # retransmission once its backoff ends), re-ages its VAoI by one version
    # per failure, and is dropped after max_retries; no energy is refunded.
    with record_function("ehfl.channel"):
        delivered, channel_state = channel.step(carry.channel, st.uploaded, draws.channel)
        failed = st.uploaded & ~delivered
        attempts = carry.retries + failed.to(torch.int32)
        dropped = failed & (attempts >= cfg.max_retries)
        retrying = failed & ~dropped
        # capped exponential backoff min(2^(attempts-1), cap), the shift
        # clamped at 30 (it is read only where attempts >= 1)
        boff = torch.clamp(torch.ones_like(attempts) << torch.clamp(attempts - 1, 0, 30), max=cfg.backoff_cap)
        zero = torch.zeros_like(attempts)
        retries = torch.where(delivered | dropped, zero, torch.where(retrying, attempts, carry.retries))
        backoff = torch.where(retrying, boff, torch.clamp(carry.backoff - 1, min=0))
        pending = st.pending | retrying
        # a lost version is one more version the server is behind by
        age = age + failed.to(age.dtype)
    upload_mask = delivered

    # --- local training (only VAoI policies read the Eq. 6 moment h) ---
    pending_in = carry.pending  # entered the epoch with an unsent (old) message?
    cap = resolve_compact_cap(cfg, spec)

    def train(imgs, lbls, perms):
        with record_function("ehfl.local_train"):
            return _local_train(carry.global_params, imgs, lbls, perms, cfg, backend, with_feature=spec.uses_vaoi)

    if cap is None:
        # --- dense path: train all clients, keep the started ones ---
        trained, h_new = train(images, labels, draws.perms)
        started = st.started
        with record_function("ehfl.scatter"):
            msg_params = {
                k: torch.where(_rows(started, old), trained[k], old) for k, old in carry.msg_params.items()
            }
            h = torch.where(started[:, None], h_new, carry.h) if spec.uses_vaoi else carry.h
        with record_function("ehfl.fedavg"):
            # old-pending uploads use their old message
            contrib = {
                k: torch.where(_rows(pending_in, old), old, msg_params[k])
                for k, old in carry.msg_params.items()
            }
            new_global = _masked_mean(contrib, upload_mask, carry.global_params, ops.reduce_sum)
    else:
        # --- active-set compaction: gather the started clients into a
        # static (cap, ...) slab, train only the slab, write it back ---
        cap_loc = min(cap, n)
        # stable argsort of ~started: started clients first, in ascending
        # client order, so slab lane j is the j-th started client
        slab_idx = torch.argsort((~st.started).to(torch.int32), stable=True)[:cap_loc]
        slab_valid = torch.arange(cap_loc, device=slab_idx.device) < st.started.sum()
        trained, h_slab = train(images[slab_idx], labels[slab_idx], draws.perms[slab_idx])
        # padding lanes (clients that did not start) write back their own
        # old rows, so only the valid lanes change anything: the reference
        # drops them with an out-of-bounds scatter, which torch lacks
        with record_function("ehfl.scatter"):
            msg_params = {
                k: old.index_copy(0, slab_idx, torch.where(_rows(slab_valid, trained[k]), trained[k], old[slab_idx]))
                for k, old in carry.msg_params.items()
            }
            h = (
                carry.h.index_copy(0, slab_idx, torch.where(slab_valid[:, None], h_slab, carry.h[slab_idx]))
                if spec.uses_vaoi
                else carry.h
            )
        # fresh uploads reduce over the slab; carriers of an old message
        # upload it from the N-wide (pre-epoch) message dict
        slab_new = (upload_mask & ~pending_in)[slab_idx] & slab_valid
        old_mask = upload_mask & pending_in
        with record_function("ehfl.fedavg"):
            new_global = _compact_mean(
                trained, slab_new, carry.msg_params, old_mask, carry.global_params, ops.reduce_sum
            )

    # sums over this carry's clients, folded into fleet-wide sums by ops;
    # the two means divide by the global N
    metrics = ops.reduce_metrics({
        "energy": st.energy_used.sum(),
        "avg_age": age.sum(),
        "n_started": st.started.sum(),
        # n_uploaded counts attempts (energy spent); n_delivered what landed
        "n_uploaded": st.uploaded.sum(),
        "avg_m": m.sum(),
        "n_delivered": upload_mask.sum(),
        "n_failed": failed.sum(),
        "n_dropped": dropped.sum(),
        # retransmissions of a message that failed before: attempted (each an
        # old-carrier row of the FedAvg, weighted by delivery) and delivered
        "n_retried": (st.uploaded & (carry.retries > 0)).sum(),
        "n_resent": (upload_mask & (carry.retries > 0)).sum(),
        "selected": selected,  # (N,) mask: lets two runs compare selections exactly
    })
    metrics["avg_age"] = metrics["avg_age"] / N
    metrics["avg_m"] = metrics["avg_m"] / N
    return (
        carry._replace(
            global_params=new_global,
            msg_params=msg_params,
            h=h,
            age=age,
            battery=st.battery,
            pending=pending,
            counter=st.counter,
            harvest=st.harvest[0] if process.persistent else None,
            stream=stream_state,
            retries=retries,
            backoff=backoff,
            channel=channel_state,
        ),
        metrics,
    )


def make_epoch_fn(
    cfg: EHFLConfig, backend: Backend, data: Dict[str, torch.Tensor]
) -> Callable[[EpochCarry, int, EpochDraws], Tuple[EpochCarry, Dict[str, torch.Tensor]]]:
    """One epoch of Alg. 1 as a ``(carry, t, draws) -> (carry, metrics)`` function."""
    spec = policy_lib.make_policy(cfg.policy, num_clients=cfg.num_clients, k=cfg.k, num_groups=cfg.num_groups)
    process, stream, channel = cfg.harvest_process(), cfg.data_stream(backend.num_classes), cfg.channel_process()
    return lambda carry, t, draws: epoch_body(
        carry, t, data["images"], data["labels"], draws,
        cfg=cfg, backend=backend, spec=spec, process=process, stream=stream, channel=channel,
    )


def drive_epochs(
    epoch_fn: Callable,
    carry: EpochCarry,
    cfg: EHFLConfig,
    backend: Backend,
    data: Dict[str, torch.Tensor],
    draws: DrawSource,
) -> Dict[str, Any]:
    """The host loop: T epochs with macro-F1 eval after every ``eval_every``
    epochs and after the last.  ``metrics["epoch_s"]`` is each epoch's host
    wall time, taken after the device has finished it."""
    from repro_torch.models.cnn import macro_f1

    device = carry.age.device
    n_samples = data["images"].shape[1]
    per_epoch: List[Dict[str, torch.Tensor]] = []
    epoch_s, f1s, f1_epochs = [], [], []
    chunk = max(1, cfg.eval_every)
    for t in range(cfg.epochs):
        t0 = time.perf_counter()
        carry, ms = epoch_fn(carry, t, draws.epoch(t, cfg, n_samples, device))
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        epoch_s.append(time.perf_counter() - t0)
        per_epoch.append(ms)
        if (t + 1) % chunk == 0 or t + 1 == cfg.epochs:
            with record_function("ehfl.eval"):
                preds = backend.predict(carry.global_params, data["test_images"])
                f1s.append(macro_f1(preds, data["test_labels"], backend.num_classes))
            f1_epochs.append(t + 1)

    metrics = {k: torch.stack([ms[k] for ms in per_epoch]) for k in per_epoch[0]}
    metrics["f1"] = torch.stack(f1s)
    metrics["f1_epochs"] = torch.tensor(f1_epochs)
    metrics["total_energy"] = metrics["energy"].sum()
    metrics["epoch_s"] = torch.tensor(epoch_s, dtype=torch.float64)
    return {"metrics": metrics, "global_params": carry.global_params, "carry": carry}


def to_device_data(data: Dict[str, Any], device: torch.device) -> Dict[str, torch.Tensor]:
    """Client pools and test set (numpy arrays or tensors) on ``device``:
    images float32, labels int64."""
    out = {}
    for k in ("images", "labels", "test_images", "test_labels"):
        x = data[k] if isinstance(data[k], torch.Tensor) else torch.as_tensor(np.array(data[k]))
        out[k] = x.to(device=device, dtype=torch.int64 if k.endswith("labels") else torch.float32)
    return out


def run_simulation(
    cfg: EHFLConfig,
    backend: Backend,
    data: Dict[str, Any],
    *,
    draws: DrawSource | None = None,
    params: Params | None = None,
    device: str | torch.device | None = None,
) -> Dict[str, Any]:
    """Run T epochs of Alg. 1.  Returns metric trajectories + final model.

    ``draws`` defaults to ``TorchDraws(cfg.seed)``; ``params`` replaces the
    random initial global model; ``device=None`` means the GPU."""
    device = resolve_device(device)
    data = to_device_data(data, device)
    draws = draws or TorchDraws(cfg.seed)
    carry = init_carry(cfg, backend, device, params=params, draws=draws)
    epoch_fn = make_epoch_fn(cfg, backend, data)
    return drive_epochs(epoch_fn, carry, cfg, backend, data, draws)


def _stack(trees: Sequence[Any]) -> Any:
    """Stack per-seed results along a new leading axis: tensors with
    ``torch.stack``, Python numbers (the diurnal clock) as a tensor,
    containers leaf by leaf; None stays None."""
    first = trees[0]
    if isinstance(first, torch.Tensor):
        return torch.stack(list(trees))
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    if isinstance(first, tuple):
        items = [_stack(list(col)) for col in zip(*trees)]
        return type(first)(*items) if hasattr(first, "_fields") else tuple(items)
    if first is None:
        return None
    return torch.tensor(list(trees))


def run_batch(
    cfg: EHFLConfig,
    backend: Backend,
    data: Dict[str, Any],
    seeds: Sequence[int],
    *,
    draws: Sequence[DrawSource] | None = None,
    params: Sequence[Params] | None = None,
    device: str | torch.device | None = None,
) -> Dict[str, Any]:
    """Multi-seed sweep: seed i runs exactly as
    ``run_simulation(replace(cfg, seed=seeds[i]), ...)`` with ``draws[i]``
    (default ``TorchDraws(seeds[i])``) and ``params[i]`` (default its random
    init), one after the other on one device; ``data`` is shared (one
    partition, many scheduling runs).

    Returns :func:`run_simulation`'s dict with a leading seed axis on every
    metric, ``global_params`` and ``carry`` leaf, except
    ``metrics["f1_epochs"]``, the shared eval schedule, which stays 1-D;
    ``total_energy`` is (R,)."""
    seeds = [int(s) for s in seeds]
    for name, per_seed in (("draws", draws), ("params", params)):
        if per_seed is not None and len(per_seed) != len(seeds):
            raise ValueError(f"{name} has {len(per_seed)} entries for {len(seeds)} seeds")
    device = resolve_device(device)
    data = to_device_data(data, device)
    outs = [
        run_simulation(
            replace(cfg, seed=seed), backend, data, device=device,
            draws=None if draws is None else draws[i], params=None if params is None else params[i],
        )
        for i, seed in enumerate(seeds)
    ]
    metrics = _stack([o["metrics"] for o in outs])
    metrics["f1_epochs"] = outs[0]["metrics"]["f1_epochs"]
    return {
        "metrics": metrics,
        "global_params": _stack([o["global_params"] for o in outs]),
        "carry": _stack([o["carry"] for o in outs]),
    }
