"""LM training in the port against the JAX package, on the CPU at ``reduced()``.

Every case feeds both packages the same numpy-made inputs: the JAX
package's params from its own initialiser (zeroed biases nudged, as in
``tests/_torch_zoo.py``) carried to the port through
``checkpoint/convert.py``, and tokens, labels, prefix embeddings and
encoder frames from ``np.random.default_rng``.  Tolerances, fp32
throughout, where the two sides differ only in summation order:

- losses within ``LOSS_RTOL`` = 1e-5 relative;
- each gradient leaf within ``GRAD_RTOL`` = 1e-4 of its largest |element|
  (plus 1e-7: a leaf whose gradient is zero in the reference, a bias in a
  layer the loss does not reach, must be zero here too);
- params after SGD or AdamW steps within ``PARAM_ATOL`` = 1e-5 (the update
  moves them by at most lr · (|g| or 1), from values of order 1);
- features (a distribution over the vocab, entries near 1/V) within
  ``FEATURE_ATOL`` = 1e-7.

The reference's own entry point ``python -m repro.launch.train`` runs in a
child process; the port's round function is given the same tokens, params
and selection noise (replayed from the same ``jax.random`` chain), and its
per-round line and saved checkpoint are held to the child's.
"""
import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_zoo import MAX_SEQ, as_float, configs, nudge_biases  # noqa: E402
from repro.checkpoint import load_pytree as jload_pytree  # noqa: E402
from repro.configs import list_configs  # noqa: E402
from repro.data import make_token_dataset as jmake_token_dataset  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import decoder as jdecoder  # noqa: E402
from repro.optim import adamw_init as jadamw_init  # noqa: E402
from repro.optim import adamw_update as jadamw_update  # noqa: E402
from repro_torch.checkpoint import convert  # noqa: E402
from repro_torch.data import make_token_dataset  # noqa: E402
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.launch.train import run_rounds  # noqa: E402
from repro_torch.models import decoder  # noqa: E402
from repro_torch.optim import adamw_init, adamw_update  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
ARCHS = sorted(list_configs())
B, S = 2, 12  # S - 1 = 11 predicted positions
LOSS_RTOL, GRAD_RTOL, PARAM_ATOL, FEATURE_ATOL = 1e-5, 1e-4, 1e-5, 1e-7
# (ce_impl, ce_chunk): gather over the full logits, and one-hot over chunks
# of 5 of the 11 positions (4 columns of padding)
CE_FORMS = [("gather", 0), ("onehot", 5)]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Many small ops: one intra-op thread each, so that parallel test
    workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@dataclasses.dataclass
class World:
    jcfg: object
    cfg: object
    jparams: object
    np_params: object
    batch: dict  # numpy

    def params(self):
        return convert.decoder_params_from_reference(self.np_params, self.cfg, device="cpu")

    def tbatch(self):
        return {k: torch.from_numpy(v).long() if v.dtype == np.int32 else torch.from_numpy(v)
                for k, v in self.batch.items()}

    def jbatch(self):
        return {k: jnp.asarray(v) for k, v in self.batch.items()}


_WORLDS = {}


def world(name: str) -> World:
    if name not in _WORLDS:
        jcfg, cfg = configs(name)
        rng = np.random.default_rng(3)
        np_params = nudge_biases(
            jax.tree.map(np.asarray, jdecoder.init_params(jcfg, jax.random.PRNGKey(3), max_seq=MAX_SEQ)), 4
        )
        batch = {
            "tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
        }
        if cfg.num_prefix_tokens:
            batch["prefix_embeddings"] = (rng.standard_normal((B, cfg.num_prefix_tokens, cfg.d_model)) * 0.5).astype(
                np.float32)
        if cfg.is_encoder_decoder:
            batch["encoder_frames"] = (rng.standard_normal((B, cfg.encoder_seq, cfg.d_model)) * 0.5).astype(np.float32)
        _WORLDS[name] = World(jcfg, cfg, jax.tree.map(jnp.asarray, np_params), np_params, batch)
    return _WORLDS[name]


def port_value_and_grad(cfg, params, batch, **kw):
    flat = {k: v.detach().requires_grad_(True) for k, v in decoder.flat_params(params).items()}
    loss, parts = decoder.loss_fn(cfg, decoder.nest_params(flat), batch, **kw)
    grads = torch.autograd.grad(loss, list(flat.values()))
    return loss.detach(), parts, dict(zip(flat, grads))


def ref_as_port(tree, cfg):
    """A reference param-shaped tree (params, grads, AdamW moments) as the
    port's flat dict."""
    return decoder.flat_params(convert.decoder_params_from_reference(jax.tree.map(np.asarray, tree), cfg, "cpu"))


def assert_leaves_close(got: dict, want: dict, rtol: float = 0.0, atol: float = 0.0, what: str = "") -> None:
    assert sorted(got) == sorted(want), what
    for k in want:
        g, w = as_float(got[k]), as_float(want[k])
        assert g.shape == w.shape, (what, k, g.shape, w.shape)
        err, limit = np.abs(g - w).max(), rtol * np.abs(w).max() + atol
        assert err <= limit, f"{what} {k}: max abs error {err} > {limit}"


# ---------------------------------------------------------------------------
# loss_fn, remat, the feature taps
# ---------------------------------------------------------------------------


_REFERENCE = {}


def reference(arch: str):
    """The reference's (loss, parts) and grads for each of CE_FORMS, and its
    train step (lr 0.1, no remat): one jit an arch (cached; a module's
    tests run in one worker)."""
    if arch not in _REFERENCE:
        w = world(arch)

        def vg(form):
            return jax.value_and_grad(
                lambda p, b: jdecoder.loss_fn(w.jcfg, p, b, ce_impl=form[0], ce_chunk=form[1]), has_aux=True
            )

        step = jsteps.make_train_step(w.jcfg, lr=0.1, remat=False)
        _REFERENCE[arch] = jax.jit(lambda p, b: ([vg(f)(p, b) for f in CE_FORMS], step(p, b)))(w.jparams, w.jbatch())
    return _REFERENCE[arch]


@pytest.mark.parametrize("form", CE_FORMS, ids=lambda f: f"{f[0]}-chunk{f[1]}")
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_fn_value_and_grads_match_reference(arch, form):
    ce_impl, ce_chunk = form
    w = world(arch)
    (jloss, jparts), jgrads = reference(arch)[0][CE_FORMS.index(form)]
    loss, parts, grads = port_value_and_grad(w.cfg, w.params(), w.tbatch(), ce_impl=ce_impl, ce_chunk=ce_chunk)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=LOSS_RTOL)
    np.testing.assert_allclose(parts["ce"].item(), float(jparts["ce"]), rtol=LOSS_RTOL)
    np.testing.assert_allclose(parts["moe_aux"].item(), float(jparts["moe_aux"]), rtol=1e-6, atol=1e-7)
    assert_leaves_close(grads, ref_as_port(jgrads, w.cfg), GRAD_RTOL, 1e-7, "grad")


@pytest.mark.parametrize("form", [("gather", 0), ("onehot", 4)], ids=lambda f: f"{f[0]}-chunk{f[1]}")
@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "mamba2-1.3b", "jamba-v0.1-52b", "whisper-large-v3"])
def test_remat_is_bit_exact(arch, form):
    """Checkpointed super-blocks recompute the same values: loss and every
    gradient equal the un-checkpointed ones bit for bit (chunks of 4 over
    the 11 positions: 1 column of padding)."""
    w = world(arch)
    kw = dict(ce_impl=form[0], ce_chunk=form[1])
    plain = port_value_and_grad(w.cfg, w.params(), w.tbatch(), **kw)
    remat = port_value_and_grad(w.cfg, w.params(), w.tbatch(), remat=True, **kw)
    assert torch.equal(plain[0], remat[0])
    for k, g in plain[2].items():
        assert torch.equal(g, remat[2][k]), k


def test_per_token_forms_agree():
    """gather and one-hot pick the same gold logit: the same bits."""
    from repro_torch.models.common import softmax_cross_entropy, softmax_cross_entropy_per_token

    rng = np.random.default_rng(5)
    logits = torch.from_numpy(rng.standard_normal((3, 7, 50)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, 50, (3, 7)))
    a = softmax_cross_entropy_per_token(logits, labels, "gather")
    b = softmax_cross_entropy_per_token(logits, labels, "onehot")
    assert a.shape == (3, 7) and torch.equal(a, b)
    assert torch.equal(softmax_cross_entropy(logits, labels, "onehot"), a.mean())
    with pytest.raises(ValueError):
        softmax_cross_entropy_per_token(logits, labels, "dense")


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "mamba2-1.3b", "internvl2-2b", "whisper-large-v3"])
def test_feature_taps_match_reference(arch):
    """feature_vector of one batch and feature_vectors of N batches in one
    forward against the reference's per-client feature_vector."""
    w = world(arch)
    n_clients = 3
    rng = np.random.default_rng(6)
    toks = rng.integers(0, w.cfg.vocab_size, (n_clients, B, S)).astype(np.int32)
    extra = {k: np.stack([w.batch[k]] * n_clients) for k in ("prefix_embeddings", "encoder_frames") if k in w.batch}
    jfeat = jax.jit(lambda p, t, pe, ef: jdecoder.feature_vector(w.jcfg, p, t, pe, ef))
    want = np.stack([
        np.asarray(jfeat(w.jparams, toks[i], *(jnp.asarray(extra[k][i]) if k in extra else None
                                                 for k in ("prefix_embeddings", "encoder_frames"))))
        for i in range(n_clients)
    ])
    params = w.params()
    targs = {k: torch.from_numpy(v) for k, v in extra.items()}
    got = decoder.feature_vectors(w.cfg, params, torch.from_numpy(toks).long(), **targs)
    assert got.shape == (n_clients, w.cfg.vocab_size) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=FEATURE_ATOL)
    one = decoder.feature_vector(w.cfg, params, torch.from_numpy(toks[1]).long(),
                                 **{k: v[1] for k, v in targs.items()})
    np.testing.assert_allclose(one.numpy(), want[1], rtol=0, atol=FEATURE_ATOL)
    np.testing.assert_allclose(got.sum(-1).numpy(), 1.0, rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# AdamW, the converter round trip of its state, the token dataset
# ---------------------------------------------------------------------------


def _grads(rng, tree):
    return jax.tree.map(lambda a: (rng.standard_normal(a.shape) * 0.1).astype(np.float32), tree)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_three_steps_match_reference(dtype):
    jcfg, cfg = configs("qwen1.5-0.5b", dtype=getattr(jnp, dtype))
    cfg = dataclasses.replace(cfg, dtype=getattr(torch, dtype))
    np_params = jax.tree.map(np.asarray, jdecoder.init_params(jcfg, jax.random.PRNGKey(1), max_seq=MAX_SEQ))
    rng = np.random.default_rng(7)
    grads = [_grads(rng, np_params) for _ in range(3)]
    jp, jstate = jax.tree.map(jnp.asarray, np_params), jadamw_init(np_params)
    update = jax.jit(lambda p, g, st: jadamw_update(p, g, st, lr=1e-2))
    p = convert.decoder_params_from_reference(np_params, cfg, "cpu")
    state = adamw_init(p)
    assert state["step"].dtype == torch.int32
    assert all(v.dtype == torch.float32 for v in decoder.flat_params(state["m"]).values())
    for g in grads:
        jp, jstate = update(jp, g, jstate)
        p, state = adamw_update(p, convert.decoder_params_from_reference(g, cfg, "cpu"), state, lr=1e-2)
    assert int(state["step"]) == int(jstate["step"]) == 3
    flat, want = decoder.flat_params(p), ref_as_port(jp, cfg)
    assert all(flat[k].dtype == want[k].dtype for k in flat)
    # bf16: both sides round the same fp32 update once; allow one bf16 step
    assert_leaves_close(flat, want, 2**-8 if dtype == "bfloat16" else 0.0, PARAM_ATOL, "params")
    assert_leaves_close(decoder.flat_params(state["m"]), ref_as_port(jstate["m"], cfg), 0.0, 1e-7, "m")
    assert_leaves_close(decoder.flat_params(state["v"]), ref_as_port(jstate["v"], cfg), 1e-6, 1e-12, "v")


def test_adamw_state_round_trips_through_the_converter():
    """The reference's AdamW state after 2 steps, carried to the port
    through decoder_params_from_reference (m and v are param-shaped trees),
    gives the same step 3; and back through decoder_params_to_reference
    it is the reference's state bit for bit."""
    jcfg, cfg = configs("qwen1.5-0.5b")
    np_params = jax.tree.map(np.asarray, jdecoder.init_params(jcfg, jax.random.PRNGKey(2), max_seq=MAX_SEQ))
    rng = np.random.default_rng(8)
    grads = [_grads(rng, np_params) for _ in range(3)]
    jp, jstate = jax.tree.map(jnp.asarray, np_params), jadamw_init(np_params)
    update = jax.jit(lambda p, g, st: jadamw_update(p, g, st, lr=1e-2))
    for g in grads[:2]:
        jp, jstate = update(jp, g, jstate)
    np_state = jax.tree.map(np.asarray, jstate)
    state = {
        "m": convert.decoder_params_from_reference(np_state["m"], cfg, "cpu"),
        "v": convert.decoder_params_from_reference(np_state["v"], cfg, "cpu"),
        "step": torch.tensor(int(np_state["step"]), dtype=torch.int32),
    }
    for key in ("m", "v"):
        back = convert.decoder_params_to_reference(state[key], cfg)
        for got, want in zip(jax.tree.leaves(back), jax.tree.leaves(np_state[key])):
            assert np.array_equal(got, want)
    p = convert.decoder_params_from_reference(jax.tree.map(np.asarray, jp), cfg, "cpu")
    jp, jstate = update(jp, grads[2], jstate)
    p, state = adamw_update(p, convert.decoder_params_from_reference(grads[2], cfg, "cpu"), state, lr=1e-2)
    assert int(state["step"]) == 3
    assert_leaves_close(decoder.flat_params(p), ref_as_port(jp, cfg), 0.0, PARAM_ATOL, "params")
    assert_leaves_close(decoder.flat_params(state["m"]), ref_as_port(jstate["m"], cfg), 0.0, 1e-7, "m")
    assert_leaves_close(decoder.flat_params(state["v"]), ref_as_port(jstate["v"], cfg), 1e-6, 1e-12, "v")


def test_token_dataset_shape_range_and_topic_skew():
    """tests/test_data.py's check of the reference, on the port's draw."""
    d = make_token_dataset(torch.Generator().manual_seed(0), 4, 8, 32, vocab_size=512, alpha=0.1)
    toks = d["tokens"]
    assert toks.shape == (4, 8, 32) and toks.dtype == torch.int32
    assert int(toks.min()) >= 0 and int(toks.max()) < 512
    h0 = np.bincount(toks[0].numpy().ravel(), minlength=512)
    h1 = np.bincount(toks[1].numpy().ravel(), minlength=512)
    assert np.minimum(h0, h1).sum() / max(h0.sum(), 1) < 0.8
    again = make_token_dataset(torch.Generator().manual_seed(0), 4, 8, 32, vocab_size=512, alpha=0.1)
    assert torch.equal(again["tokens"], toks)
    ref = np.asarray(jmake_token_dataset(jax.random.PRNGKey(0), 4, 8, 32, vocab_size=512, alpha=0.1)["tokens"])
    assert ref.shape == tuple(toks.shape) and ref.dtype == np.int32


# ---------------------------------------------------------------------------
# make_train_step and the training rounds
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch):
    """tests/test_smoke_archs.py's train step (lr 0.1, no remat) against the
    reference's on the same params and batch; then the port's own remat
    step from there, on the same batch, lowers the loss."""
    w = world(arch)
    jloss, jnew = reference(arch)[1]
    loss0, new = make_train_step(w.cfg, lr=0.1, remat=False)(w.params(), w.tbatch())
    np.testing.assert_allclose(loss0.item(), float(jloss), rtol=LOSS_RTOL)
    assert_leaves_close(decoder.flat_params(new), ref_as_port(jnew, w.cfg), 0.0, PARAM_ATOL, "params")
    loss1, _ = make_train_step(w.cfg, lr=0.1, remat=True)(new, w.tbatch())
    assert loss1.item() < loss0.item()


@pytest.fixture(autouse=True, scope="module")
def reference_child(tmp_path_factory):
    """The reference's entry point with its defaults at reduced(), started in
    a child process when the module starts, so that it runs beside the
    other cases; (process, checkpoint path)."""
    path = tmp_path_factory.mktemp("reference_train") / "ref.npz"
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro.launch.train", "--arch", "qwen1.5-0.5b", "--reduced", "--save", str(path)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu",
             "XLA_FLAGS": "--xla_cpu_multi_thread_eigen=false"},  # one thread, beside the busy test workers
    )
    yield proc, path
    if proc.poll() is None:
        proc.kill()
    proc.communicate()


def reference_rounds(proc):
    stdout, stderr = proc.communicate(timeout=300)
    assert proc.returncode == 0, stderr[-3000:]
    rounds = re.findall(r"round (\d+): selected=\[([\d, ]*)\] loss=([\d.]+) avg_age=([\d.]+) avg_M=([\d.]+)", stdout)
    assert len(rounds) == 3, stdout
    return [{"selected": [int(i) for i in sel.split(",")], "loss": float(loss), "avg_age": float(age),
             "avg_m": float(m)} for _, sel, loss, age, m in rounds]


def test_round_function_matches_reference_entry_point(reference_child):
    """``python -m repro.launch.train --arch qwen1.5-0.5b --reduced --save``
    against the port's run_rounds on the same tokens, initial params and
    selection noise: the same clients each round, loss within 1e-4 (the
    printed 4 decimals), avg_age exactly (2 decimals of quarter steps),
    avg_M within 1e-4, and the child's saved params (through the JAX
    package's load_pytree and the converter) within PARAM_ATOL."""
    proc, path = reference_child
    want = reference_rounds(proc)
    jcfg, cfg = configs("qwen1.5-0.5b")
    kd, kp, kr = jax.random.split(jax.random.PRNGKey(0), 3)
    N, steps, batch, seq, rounds = 8, 4, 4, 64, 3
    toks = np.asarray(jmake_token_dataset(kd, N, batch * steps, seq, cfg.vocab_size)["tokens"])
    np_params = jax.tree.map(np.asarray, jdecoder.init_params(jcfg, kp, max_seq=seq))
    noise = []
    for _ in range(rounds):
        kr, ks = jax.random.split(kr)
        noise.append(np.asarray(jax.random.uniform(ks, (N,), minval=0.0, maxval=1e-3)))
    lines = []
    params, history = run_rounds(
        cfg, convert.decoder_params_from_reference(np_params, cfg, "cpu"), torch.from_numpy(toks.copy()),
        torch.from_numpy(np.stack(noise)), k=2, mu=0.001, lr=0.05, steps_per_round=steps, batch=batch,
        log=lines.append,
    )
    assert len(lines) == rounds
    for got, ref in zip(history, want):
        assert got["selected"] == ref["selected"]
        assert abs(got["loss"] - ref["loss"]) <= 1e-4 + 5e-5
        assert round(got["avg_age"], 2) == ref["avg_age"]
        assert abs(got["avg_m"] - ref["avg_m"]) <= 1e-4 + 5e-5
    saved = jload_pytree(jdecoder.init_params(jcfg, kp, max_seq=seq), str(path))
    assert_leaves_close(decoder.flat_params(params), ref_as_port(saved, cfg), 0.0, PARAM_ATOL, "saved params")


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("k", [2, 3, 4, 5, 8])
def test_round_mean_against_reference_sum(k, dtype):
    """The round mean of launch/train.py (the leaf table with weights 1/k: an
    fp32 sum rounded once) against ``repro.launch.train``'s ``sum(xs) / len(xs)`` in
    the params' dtype: bit for bit at k = 2 (halving is exact); otherwise
    within 2 ulps of the largest client's value (the reference rounds each
    partial sum, and 1/k is not exact in fp32)."""
    from repro_torch.kernels import ops

    rng = np.random.default_rng(k)
    xs = [jnp.asarray(x, getattr(jnp, dtype)) for x in rng.standard_normal((k, 20000)).astype(np.float32)]
    want = np.asarray(jax.jit(lambda *a: sum(a) / len(a))(*xs)).astype(np.float32)
    rows = np.stack([np.asarray(x).astype(np.float32) for x in xs])
    t = torch.from_numpy(rows).to(getattr(torch, dtype))
    got = ops.fedavg_reduce_leaves([([t], torch.full((k,), 1.0 / k))]).to(t.dtype).float().numpy()
    ulp = np.spacing(np.abs(rows).max(0)) * (2**16 if dtype == "bfloat16" else 1)
    if k == 2:
        np.testing.assert_array_equal(got, want)
    assert np.max(np.abs(got - want) / ulp) <= 2.0
