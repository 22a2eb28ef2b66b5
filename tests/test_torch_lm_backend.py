"""The EHFL simulator with LM clients (``fl/backend.py::lm_backend``), and the
LM training entry point's command line, against the JAX package on the CPU.

``run_simulation`` with ``lm_backend(reduced(qwen1.5-0.5b))`` on
``tests/test_system.py::test_lm_backend_runs_ehfl``'s setup (4 clients of 24
sequences of 16 tokens, k = 2, kappa = 4, probe 4), the reference's key
chain replayed into the port's draws (``tests/_torch_replay.py``) and its
initial params carried over through ``checkpoint/convert.py``: the integer
dynamics, ages and selections equal exactly; the global params within
``PARAM_ATOL`` = 1e-5 and avg_m within ``M_ATOL`` = 1e-6 (fp32, the two
sides differ in summation order; kappa = 4 SGD steps at lr 0.01 do not
amplify it past that).  The LM's probe runs the attention through
``kernels.ops.swa_attention``, on the CPU its plain version.
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

from _torch_replay import replay_draws  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.core import EHFLConfig as JEHFLConfig  # noqa: E402
from repro.core import init_carry as jinit_carry  # noqa: E402
from repro.core import run_simulation as jrun_simulation  # noqa: E402
from repro.core import simulator as jsim  # noqa: E402
from repro.core import vaoi as jvaoi  # noqa: E402
from repro.data import make_token_dataset as jmake_token_dataset  # noqa: E402
from repro.fl import lm_backend as jlm_backend  # noqa: E402
from repro.models import decoder as jdecoder  # noqa: E402
from repro_torch.checkpoint import convert  # noqa: E402
from repro_torch.configs import CONFIG as CNN_CONFIG  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core import simulator as tsim  # noqa: E402
from repro_torch.fl import cnn_backend, lm_backend  # noqa: E402
from repro_torch.models import decoder  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
PARAM_ATOL, M_ATOL = 1e-5, 1e-6
SIM = dict(num_clients=4, epochs=2, slots_per_epoch=8, kappa=4, p_bc=1.0, k=2, mu=0.01, e_max=9, eval_every=2,
           probe_size=4)
EXACT_METRICS = ("n_started", "n_uploaded", "energy", "avg_age")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Many small ops: one intra-op thread each, so that parallel test
    workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs():
    """test_system.py's LM run in the JAX package, and the port's on the
    same tokens, initial params and draws."""
    jcfg, cfg = jreduced(jget_config("qwen1.5-0.5b")), reduced(get_config("qwen1.5-0.5b"))
    toks = jmake_token_dataset(jax.random.PRNGKey(0), 4, 24, 16, jcfg.vocab_size)["tokens"]
    data = {
        "images": toks,
        "labels": jnp.zeros(toks.shape[:2], jnp.int32),
        "test_images": toks[0],
        "test_labels": jnp.zeros((toks.shape[1],), jnp.int32),
    }
    jbackend = jlm_backend(jcfg)
    ref = jrun_simulation(JEHFLConfig(**SIM), jbackend, data)
    # the reference keeps no selection metric: step its epoch function and
    # take each epoch's selection as its epoch_body does, from the ages and
    # the key the epoch starts with
    epoch_fn = jax.jit(jsim.make_epoch_fn(JEHFLConfig(**SIM), jbackend, data))
    carry, ref["selected"] = jinit_carry(JEHFLConfig(**SIM), jbackend), []
    for t in range(SIM["epochs"]):
        ref["selected"].append(np.asarray(jvaoi.select_topk(carry.age, SIM["k"], jax.random.split(carry.key, 4)[0])))
        carry, _ = epoch_fn(carry, t)
    ref["stepped_age"] = np.asarray(carry.age)
    params0 = jax.tree.map(np.asarray, jinit_carry(JEHFLConfig(**SIM), jbackend).global_params)
    port = tsim.run_simulation(
        tsim.EHFLConfig(**SIM), lm_backend(cfg), {k: np.asarray(v) for k, v in data.items()},
        draws=replay_draws(JEHFLConfig(**SIM), jbackend, 24),
        params=decoder.flat_params(convert.decoder_params_from_reference(params0, cfg, "cpu")), device="cpu",
    )
    return cfg, ref, port


def test_lm_simulation_dynamics_match_reference_exactly(runs):
    _, ref, port = runs
    for k in EXACT_METRICS:
        np.testing.assert_array_equal(port["metrics"][k].numpy(), np.asarray(ref["metrics"][k]), err_msg=k)
    np.testing.assert_array_equal(port["metrics"]["selected"].numpy(), np.stack(ref["selected"]))
    np.testing.assert_array_equal(port["carry"].age.numpy(), ref["stepped_age"])
    assert port["metrics"]["n_started"].sum().item() > 0
    for field in ("age", "battery", "pending", "counter"):
        np.testing.assert_array_equal(getattr(port["carry"], field).numpy(), np.asarray(getattr(ref["carry"], field)),
                                      err_msg=field)


def test_lm_simulation_floats_match_reference(runs):
    cfg, ref, port = runs
    np.testing.assert_allclose(port["metrics"]["avg_m"].numpy(), np.asarray(ref["metrics"]["avg_m"]), rtol=0,
                               atol=M_ATOL)
    assert np.isfinite(port["metrics"]["avg_m"].numpy()).all()
    want = decoder.flat_params(convert.decoder_params_from_reference(
        jax.tree.map(np.asarray, ref["global_params"]), cfg, "cpu"))
    got = port["global_params"]
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=0, atol=PARAM_ATOL, err_msg=k)
    np.testing.assert_allclose(port["metrics"]["f1"].numpy(), np.asarray(ref["metrics"]["f1"]), rtol=0, atol=1e-6)


def test_lm_backend_runs_an_ssm_client():
    """The SSM family batches under vmap too: one epoch of reduced
    mamba2-1.3b clients, finite, with clients trained."""
    cfg = reduced(get_config("mamba2-1.3b"))
    toks = torch.randint(0, cfg.vocab_size, (4, 8, 12), generator=torch.Generator().manual_seed(0))
    data = {"images": toks, "labels": torch.zeros(4, 8, dtype=torch.long), "test_images": toks[0],
            "test_labels": torch.zeros(8, dtype=torch.long)}
    out = tsim.run_simulation(tsim.EHFLConfig(**{**SIM, "epochs": 1, "eval_every": 1}), lm_backend(cfg), data,
                              device="cpu")
    assert out["metrics"]["n_started"].sum().item() > 0
    assert all(torch.isfinite(v).all() for v in out["global_params"].values())


# the routed archs run (tests/test_torch_lm_backend_moe.py); the
# encoder-decoder stays refused, as the reference cannot run it either
@pytest.mark.parametrize("arch,exc", [("whisper-large-v3", ValueError)])
def test_lm_backend_refuses_what_vmap_cannot_batch(arch, exc):
    with pytest.raises(exc, match=arch):
        lm_backend(reduced(get_config(arch)))


def test_init_carry_keeps_each_leaf_dtype():
    """A bf16 LM's params stay bf16 in the carry (the reference keeps the
    backend's dtype); the fp32 CNN stays fp32."""
    cfg = reduced(get_config("qwen1.5-0.5b"))
    cfg = dataclasses.replace(cfg, dtype=torch.bfloat16)
    params = decoder.flat_params(decoder.init_params(cfg, 0, "cpu"))
    carry = tsim.init_carry(tsim.EHFLConfig(**SIM), lm_backend(cfg), "cpu", params=params)
    assert all(v.dtype == torch.bfloat16 for v in carry.global_params.values())
    assert all(v.dtype == torch.bfloat16 and v.shape[0] == 4 for v in carry.msg_params.values())
    cnn = cnn_backend(CNN_CONFIG)
    cparams = cnn.init(torch.Generator().manual_seed(0), torch.device("cpu"))
    ccarry = tsim.init_carry(tsim.EHFLConfig(**SIM), cnn, "cpu", params=cparams)
    assert all(v.dtype == torch.float32 for v in ccarry.global_params.values())


def test_flat_params_round_trip():
    params = decoder.init_params(reduced(get_config("whisper-large-v3")), 0, "cpu")
    flat = decoder.flat_params(params)
    assert "layers.1.cross.wq" in flat and "enc_layers.0.attn.wk" in flat and "final_norm.scale" in flat
    back = decoder.nest_params(flat)
    assert decoder.flat_params(back).keys() == flat.keys()
    assert back["layers"][1]["cross"]["wq"] is params["layers"][1]["cross"]["wq"]
    assert len(back["layers"]) == len(params["layers"]) and isinstance(back["enc_layers"], list)


# ---------------------------------------------------------------------------
# The training entry point's command line and the example
# ---------------------------------------------------------------------------


def run_cli(args, timeout=300):
    """``args`` in a child with one intra-op thread, as the test workers
    run (a child with a thread a core, beside busy workers, spins)."""
    out = subprocess.run(args, capture_output=True, text=True, timeout=timeout, cwd=ROOT,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def test_train_cli_saves_a_checkpoint_the_reference_reads(tmp_path):
    """``python -m repro_torch.launch.train --reduced --device cpu --save``:
    a line per round, and an npz in the reference's layout that the JAX
    package's load_pytree restores onto its own param tree."""
    from repro.checkpoint import load_pytree as jload_pytree

    stdout = run_cli([sys.executable, "-m", "repro_torch.launch.train", "--arch", "qwen1.5-0.5b", "--reduced",
                      "--device", "cpu", "--rounds", "2", "--clients", "4", "--save", str(tmp_path / "port.npz")])
    assert len(re.findall(r"^round \d+: selected=\[\d+, \d+\] loss=", stdout, re.M)) == 2
    template = jdecoder.init_params(jreduced(jget_config("qwen1.5-0.5b")), jax.random.PRNGKey(0), max_seq=64)
    restored = jload_pytree(template, str(tmp_path / "port.npz"))
    assert jax.tree.structure(restored) == jax.tree.structure(template)
    assert all(np.isfinite(np.asarray(x, np.float32)).all() for x in jax.tree.leaves(restored))


def test_example_runs_to_its_end_on_the_cpu():
    stdout = run_cli([sys.executable, str(ROOT / "examples" / "lm_federated_torch.py"), "--device", "cpu",
                      "--rounds", "2", "--clients", "4"])
    assert "round 1: selected=" in stdout


def test_train_cli_raises_without_cuda_unless_told_cpu(monkeypatch):
    from repro_torch.launch import train

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(["--arch", "qwen1.5-0.5b", "--reduced", "--rounds", "1"])
