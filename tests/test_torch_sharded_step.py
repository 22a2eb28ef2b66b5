"""The launch layer's sharded steps on real ranks: ``make_train_step`` and
``make_prefill_step`` on DTensor params and batches laid out by
``launch/sharding.py``'s rules (fsdp mode) over ``make_host_mesh(2)``, a
(2, 2) mesh of 4 gloo ranks, against the same steps on plain tensors, at
``reduced()`` for qwen1.5 (dense), mamba2 (SSM), deepseek-moe (MoE) and
jamba (the hybrid, whose one KV head does not divide over ``model`` and is
repeated for its query heads).
One spawn of 4 ranks for the module (``tests/_torch_launch_worker.py``).

Tolerances, fp32: the sharded steps sum their contractions, the CE's
vocab reductions and the MoE aux loss in other orders, so the loss is held
to ``LOSS_RTOL`` = 1e-6 relative, each new param leaf (gathered whole) to
``LEAF_RTOL`` = 1e-5 of the leaf's largest element and the prefill logits
to ``LOGITS_RTOL`` = 1e-5 of the largest logit.  A run read loss gaps of
7.6e-8, leaf gaps up to 6.2e-6 (mamba2's conv weights, whose gradients add
over both mesh axes) and logit gaps up to 1.0e-6.  The qwen1.5 loss is also
held to the JAX package's ``make_train_step`` on the same converted params
within ``tests/test_torch_train.py``'s 1e-5."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_launch_worker as worker  # noqa: E402
from _torch_zoo import MAX_SEQ, configs, nudge_biases  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import decoder as jdecoder  # noqa: E402

ARCHS = ("qwen1.5-0.5b", "mamba2-1.3b", "deepseek-moe-16b", "jamba-v0.1-52b")
KINDS = ("train", "prefill")
B, S, LR = 4, 64, 0.1
LOSS_RTOL, LEAF_RTOL, LOGITS_RTOL, JAX_LOSS_RTOL = 1e-6, 1e-5, 1e-5, 1e-5


def _np_params(jcfg):
    return nudge_biases(jax.tree.map(np.asarray, jdecoder.init_params(jcfg, jax.random.PRNGKey(3), max_seq=MAX_SEQ)), 4)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Every (arch, kind) case in one spawn; qwen1.5's params are the JAX
    package's, converted, so its loss can be held to the reference."""
    cases, worlds = [], {}
    for arch in ARCHS:
        jcfg, cfg = configs(arch)
        batch = worker.seeded_batch(cfg, B, S, seed=5)
        worlds[arch] = (jcfg, batch)
        for kind in KINDS:
            case = dict(arch=arch, kind=kind, seed=3, max_seq=MAX_SEQ, mode="fsdp", lr=LR, ce_chunk=0, batch=batch)
            if arch == "qwen1.5-0.5b":
                case["np_params"] = _np_params(jcfg)
            cases.append(case)
    results = worker.run_sharded(cases, tmp_path_factory.mktemp("sharded_step"))
    return {(c["arch"], c["kind"]): r for c, r in zip(cases, results)}, worlds


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_train_step_equals_plain(run, arch):
    (loss_p, new_p), (loss_d, new_d) = run[0][(arch, "train")]["plain"], run[0][(arch, "train")]["sharded"]
    assert abs(loss_d.item() - loss_p.item()) <= LOSS_RTOL * abs(loss_p.item())
    assert sorted(new_d) == sorted(new_p)
    for k, want in new_p.items():
        got = new_d[k]
        assert got.shape == want.shape and got.dtype == want.dtype, k
        err = (got - want).abs().max().item()
        assert err <= LEAF_RTOL * want.abs().max().item(), f"{arch} {k}: {err}"


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_prefill_equals_plain(run, arch):
    plain, sharded = run[0][(arch, "prefill")]["plain"], run[0][(arch, "prefill")]["sharded"]
    assert sharded.shape == plain.shape == (B, 1, plain.shape[-1])
    assert (sharded - plain).abs().max().item() <= LOGITS_RTOL * plain.abs().max().item()


def test_sharded_qwen_loss_equals_the_reference(run):
    jcfg, batch = run[1]["qwen1.5-0.5b"]
    jparams = jax.tree.map(jnp.asarray, _np_params(jcfg))
    want, _ = jax.jit(jsteps.make_train_step(jcfg, lr=LR, remat=True))(jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    got = run[0][("qwen1.5-0.5b", "train")]["sharded"][0].item()
    assert abs(got - float(want)) <= JAX_LOSS_RTOL * abs(float(want))
