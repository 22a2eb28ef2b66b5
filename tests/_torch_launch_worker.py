"""The child side of the port's launch-layer tests (``tests/test_torch_sharding.py``,
``test_torch_cost_analysis.py``, ``test_torch_dryrun.py``,
``test_torch_sharded_step.py``).

Process groups must not leak into a pytest worker, so every case that needs
one runs here, in a child: the gloo ranks of a sharded step are spawned by
``repro_torch.launch.mesh.spawn_fleet`` and run :func:`sharded_rank`; the
``fake``-group cases run in one process started as

    python tests/_torch_launch_worker.py JOB OUT

(:func:`fake_main`).  A job is a pickled list of cases; the results go to
files the test reads.  This module imports torch and the port only.
"""
from __future__ import annotations

import pickle
import sys
from pathlib import Path
from typing import Any, Dict

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.base import InputShape, get_config, reduced
from repro_torch.launch import cost_analysis, dryrun, sharding, steps
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import decoder


# ---------------------------------------------------------------------------
# Real ranks (gloo): the sharded steps against the plain ones
# ---------------------------------------------------------------------------


def _batch(case: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(v) for k, v in case["batch"].items()}


def _full(x):
    from torch.distributed.tensor import DTensor

    return x.full_tensor() if isinstance(x, DTensor) else x


def sharded_rank(rank: int, job_path: str, out_dir: str) -> None:
    """Each case: the plain step on this rank's whole copy, then the same
    step on DTensors laid out by the rules over a (2, 2) mesh of the 4
    ranks, its outputs gathered whole.  Rank 0 saves both."""
    from torch.distributed.tensor.experimental import implicit_replication

    torch.set_num_threads(1)
    cases = pickle.loads(Path(job_path).read_bytes())
    mesh = make_host_mesh(2, device_type="cpu")
    out = []
    for case in cases:
        cfg = reduced(get_config(case["arch"]))
        if "np_params" in case:  # the JAX package's params, carried over
            from repro_torch.checkpoint import convert

            params = convert.decoder_params_from_reference(case["np_params"], cfg, device="cpu")
        else:
            params = decoder.init_params(cfg, seed=case["seed"], device="cpu", max_seq=case["max_seq"])
        batch = _batch(case)
        dparams = sharding.distribute_params(params, mesh, case["mode"])
        dbatch = sharding.distribute_inputs(batch, mesh)
        got: Dict[str, Any] = {}
        if case["kind"] == "train":
            step = steps.make_train_step(cfg, lr=case["lr"], ce_chunk=case["ce_chunk"])
            loss, new = step(params, batch)
            got["plain"] = (loss, decoder.flat_params(new))
            with implicit_replication():
                loss, new = step(dparams, dbatch)
                got["sharded"] = (_full(loss), {k: _full(v) for k, v in decoder.flat_params(new).items()})
        else:
            batch.pop("labels", None)
            dbatch.pop("labels", None)
            step = steps.make_prefill_step(cfg, use_kernel=False)
            got["plain"] = step(params, batch)
            with implicit_replication():
                got["sharded"] = _full(step(dparams, dbatch))
        out.append(got)
    if rank == 0:
        torch.save(out, Path(out_dir) / "sharded.pt")


def run_sharded(cases, tmp: Path, timeout_s: float = 300.0):
    from repro_torch.launch.mesh import spawn_fleet

    job = tmp / "job.pkl"
    job.write_bytes(pickle.dumps(cases))
    spawn_fleet(sharded_rank, 4, "gloo", args=(str(job), str(tmp)), timeout_s=timeout_s)
    return torch.load(tmp / "sharded.pt", weights_only=False)


# ---------------------------------------------------------------------------
# The fake group: placements, known collectives and FLOPs, traced steps
# ---------------------------------------------------------------------------


def _placements(case, mesh):
    """The spec's placements on a mesh of ``case["mesh"]``: (2, 2) over
    ("data", "model"), or (1, 2, 2) over ("pod", "data", "model")."""
    from torch.distributed.device_mesh import init_device_mesh

    if tuple(case["mesh"]) == (1, 2, 2):
        mesh = init_device_mesh("cpu", (1, 2, 2), mesh_dim_names=("pod", "data", "model"))
    return [(type(p).__name__, getattr(p, "dim", None)) for p in sharding.to_placements(case["spec"], mesh)]


def _redistribute(case, mesh):
    """A (B, d) fp32 DTensor of ``src`` placements redistributed to ``dst``
    under a StepCost: the collectives it counted."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    names = {"S0": Shard(0), "S1": Shard(1), "R": Replicate(), "P": Partial()}
    src = tuple(names[p] for p in case["src"])
    dst = tuple(names[p] for p in case["dst"])
    B, d = case["shape"]
    local = [B, d]
    for p in src:  # each mesh dim has 2 ranks
        if isinstance(p, Shard):
            local[p.dim] //= 2
    with FakeTensorMode():
        x = DTensor.from_local(torch.empty(local), mesh, src, run_check=False, shape=(B, d), stride=(d, 1))
        cost = cost_analysis.StepCost()
        with cost:
            x.redistribute(mesh, dst)
    return cost.summary()


def _matmul(case, mesh):
    """(M, K) @ (K, N) in bf16 with the left operand replicated or its rows
    sharded over ``data``: the FLOPs rank 0 counts."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard

    M, K, N = case["shape"]
    left = (Shard(0), Replicate()) if case["sharded"] else (Replicate(), Replicate())
    with FakeTensorMode():
        a = sharding.distribute(torch.empty(M, K, dtype=torch.bfloat16), mesh, left)
        b = sharding.distribute(torch.empty(K, N, dtype=torch.bfloat16), mesh, (Replicate(), Replicate()))
        cost = cost_analysis.StepCost()
        with cost:
            a @ b
    return cost.summary()


def _trace(case, mesh):
    cfg = reduced(get_config(case["arch"]))
    shape = InputShape(case["kind"], case["seq"], case["batch"], case["kind"])
    got, _ = dryrun.trace_step(cfg, shape, mesh, **case.get("options", {}))
    got["model_flops"] = dryrun.model_flops(cfg, shape, mesh.size(), got["flops"])
    return got


def _production_mesh(case, mesh):
    """The production mesh over this 4-rank group: refused by name."""
    from repro_torch.launch.mesh import make_production_mesh

    return make_production_mesh(multi_pod=case["multi_pod"], device_type="cpu").shape


FAKE = {
    "placements": _placements, "redistribute": _redistribute, "matmul": _matmul, "trace": _trace,
    "production_mesh": _production_mesh,
}


def fake_main(job_path: str, out_path: str) -> None:
    """Every case of the job over a fake group of 4 ranks, a (2, 2) host
    mesh on the CPU; each result, or the error it raised, to ``out_path``."""
    torch.set_num_threads(1)
    cases = pickle.loads(Path(job_path).read_bytes())
    dryrun.start_fake_group(4)
    out = []
    try:
        mesh = make_host_mesh(2, device_type="cpu")
        for case in cases:
            try:
                out.append(FAKE[case["case"]](case, mesh))
            except Exception as e:  # the test reports which case failed and how
                out.append({"error": f"{type(e).__name__}: {e}"})
    finally:
        dist.destroy_process_group()
    Path(out_path).write_bytes(pickle.dumps(out))


def run_fake(cases, tmp: Path, timeout_s: float = 300.0):
    """Run ``cases`` in a child process over a fake group of 4 ranks."""
    import os
    import subprocess

    repo = Path(__file__).resolve().parent.parent
    job, out = tmp / "fake_job.pkl", tmp / "fake_out.pkl"
    job.write_bytes(pickle.dumps(cases))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(repo / "src"), os.environ.get("PYTHONPATH", "")]))
    r = subprocess.run(
        [sys.executable, __file__, str(job), str(out)], capture_output=True, text=True, timeout=timeout_s, env=env
    )
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
    return pickle.loads(out.read_bytes())


def seeded_batch(cfg, batch: int, seq: int, seed: int, labels: bool = True) -> Dict[str, np.ndarray]:
    """Token ids (and labels, prefix embeddings, encoder frames where the
    arch takes them) drawn from numpy with ``seed``."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (batch, seq), dtype=np.int32)}
    if labels:
        out["labels"] = rng.integers(0, cfg.vocab_size, (batch, seq), dtype=np.int32)
    if cfg.num_prefix_tokens:
        out["prefix_embeddings"] = rng.standard_normal((batch, cfg.num_prefix_tokens, cfg.d_model)).astype(np.float32)
    if cfg.is_encoder_decoder:
        out["encoder_frames"] = rng.standard_normal((batch, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return out


if __name__ == "__main__":
    fake_main(sys.argv[1], sys.argv[2])
