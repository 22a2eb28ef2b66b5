"""The port's dry-run (``launch/dryrun.py``): the production layout over a
fake group, per-device cost, the reference's record.

* ``python -m repro_torch.launch.dryrun --arch qwen1.5-0.5b --shape
  train_4k --seq 512 --device cpu``, plain and with ``--act-sharding --ce
  onehot --ce-chunk 128``: the counterparts of the reference's
  ``tests/test_dryrun_launch.py`` cases, each in its own process (it starts
  a fake group of 256 ranks).  The record has 256 chips, per-device FLOPs
  (the model's FLOPs over the chips, within the ratio band below, and not
  the whole step's), collectives of every kind counted, a bottleneck, and
  ``model_flops_per_chip`` by the reference's formula.  The useful-FLOP
  ratio of a remat train step is held to [0.5, 1.0]: the forward runs
  twice (6 N D over about 8 N D) and attention adds FLOPs the model count
  does not hold; at 512 tokens a run read 0.80 and 0.74.
* ``skip_reason`` and ``decode_cache_plan`` equal the reference's for every
  arch x shape (the reference's read in a child: importing
  ``repro.launch.dryrun`` sets its 512-device XLA_FLAGS in the importing
  process).
* One arch of each family at ``reduced()`` over a fake group of 4 ranks on
  a (2, 2) mesh in one child process (``tests/_torch_launch_worker.py``):
  train, prefill and decode each trace, count FLOPs on every matmul-bearing
  step, and report memory; and the test process has no process group
  afterwards."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import _torch_launch_worker as worker  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import list_configs  # noqa: E402
from repro_torch.configs import INPUT_SHAPES, get_config  # noqa: E402
from repro_torch.launch import cost_analysis, dryrun  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
RATIO_BAND = (0.5, 1.0)
FAMILIES = ("qwen1.5-0.5b", "mamba2-1.3b", "deepseek-moe-16b", "jamba-v0.1-52b", "internvl2-2b", "whisper-large-v3")
KINDS = {"train": (4, 32), "prefill": (4, 32), "decode": (4, 48)}  # (batch, seq or cache length)


@pytest.mark.parametrize("extra", [[], ["--act-sharding", "--ce", "onehot", "--ce-chunk", "128"]])
def test_dryrun_small_seq_subprocess(tmp_path, extra):
    out = tmp_path / "rec.json"
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "qwen1.5-0.5b", "--shape", "train_4k",
           "--seq", "512", "--device", "cpu", "--out", str(out), *extra]
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=300, cwd=REPO, env=env)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    assert "== dry-run summary: 1 ok / 0 skipped / 0 failed ==" in r.stdout
    rec = json.loads(out.read_text())
    assert rec["n_chips"] == 256 and rec["mesh"] == "16x16" and "compile_s" not in rec
    assert rec["cost"]["flops"] > 0
    assert rec["roofline"]["bottleneck"] in ("compute", "memory", "collective")
    for k in (*cost_analysis.COLLECTIVES, "total"):
        assert rec["collectives"][k] >= 0
    assert rec["collectives"]["all-gather"] > 0 and rec["collectives"]["all-reduce"] > 0
    assert rec["collective_counts"]["reduce-scatter"] > 0
    cfg = get_config("qwen1.5-0.5b")
    model = 6 * cfg.active_param_count() * 256 * 512 / 256
    assert rec["model_flops_per_chip"] == model == 6 * jget_config("qwen1.5-0.5b").active_param_count() * 512
    assert RATIO_BAND[0] <= rec["useful_flop_ratio"] <= RATIO_BAND[1]
    assert rec["memory"]["peak_bytes"] >= rec["memory"]["argument_bytes"] > 0
    assert rec["act_sharding"] == bool(extra) and rec["ce_impl"] == ("onehot" if extra else "gather")


_REF_PLANS = """
import json
from repro.configs import INPUT_SHAPES, get_config, list_configs
from repro.launch import dryrun
print(json.dumps({f"{a}|{s}": [dryrun.skip_reason(get_config(a), INPUT_SHAPES[s]),
                               list(dryrun.decode_cache_plan(get_config(a), INPUT_SHAPES[s]))]
                  for a in list_configs() for s in INPUT_SHAPES}))
"""


@pytest.fixture(scope="module")
def ref_plans():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", _REF_PLANS], capture_output=True, text=True, timeout=300, env=env)
    assert r.returncode == 0, r.stderr[-2000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("shape_name", sorted(INPUT_SHAPES))
@pytest.mark.parametrize("arch", sorted(list_configs()))
def test_skip_reason_and_cache_plan_equal_the_reference(ref_plans, arch, shape_name):
    cfg, shape = get_config(arch), INPUT_SHAPES[shape_name]
    skip, plan = ref_plans[f"{arch}|{shape_name}"]
    assert dryrun.skip_reason(cfg, shape) == skip
    assert list(dryrun.decode_cache_plan(cfg, shape)) == plan


@pytest.fixture(scope="module")
def traces(tmp_path_factory):
    cases = [dict(case="trace", arch=a, kind=k, batch=b, seq=s) for a in FAMILIES for k, (b, s) in KINDS.items()]
    cases += [dict(case="production_mesh", multi_pod=mp, arch=f"mesh{int(mp)}", kind="refused") for mp in (False, True)]
    return dict(zip([(c["arch"], c["kind"]) for c in cases], worker.run_fake(cases, tmp_path_factory.mktemp("dry"))))


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_refuses_a_group_of_another_size(traces, multi_pod):
    got = traces[(f"mesh{int(multi_pod)}", "refused")]
    assert got["error"].startswith("ValueError") and ("512" if multi_pod else "256") in got["error"], got


def test_meshes_refuse_without_a_group():
    from repro_torch.launch.mesh import make_host_mesh, make_production_mesh

    with pytest.raises(RuntimeError, match="initialized process group"):
        make_production_mesh(device_type="cpu")
    with pytest.raises(RuntimeError, match="initialized process group"):
        make_host_mesh(device_type="cpu")


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("arch", FAMILIES)
def test_each_family_traces_on_a_fake_mesh(traces, arch, kind):
    got = traces[(arch, kind)]
    assert "error" not in got, got
    assert got["flops"] > 0 and got["unfused_bytes"] > 0
    assert got["collectives"]["total"] == sum(got["collectives"][k] for k in cost_analysis.COLLECTIVES)
    mem = got["memory"]
    assert mem["peak_bytes"] >= mem["argument_bytes"] > 0 and mem["output_bytes"] > 0
    per_chip, ratio = got["model_flops"]
    assert per_chip > 0 and ratio == per_chip / got["flops"]


def test_no_process_group_leaks_into_the_test_process():
    assert not torch.distributed.is_initialized()
