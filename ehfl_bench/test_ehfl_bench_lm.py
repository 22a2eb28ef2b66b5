"""The ``lm`` family on the CPU at its tiny size: the cell
``deepseek-v2-lite-5l-ep8.n8.vaoi`` end to end through the comparison,
each of the model's planted faults (``faults_lm.py``) and the fp8-operand
control turning ``correct`` false; its configuration file against the
published config it cuts; the family's counts against hand counts; the
readers of the ``lm.*`` spans and of the expert layer's row counter
against hand counts on a synthetic window."""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from ehfl_bench import run, world
from ehfl_bench.families import lm
from ehfl_bench.faults_lm import FAULTS as LM_FAULTS
from ehfl_bench.test_ehfl_bench_counting import trace

ROOT = Path(__file__).resolve().parent.parent
CELL = "deepseek-v2-lite-5l-ep8.n8.vaoi"
LM_METRICS = {"lm.moe.device_ms", "lm.attn.device_ms", "lm.moe.rows_per_token"}
# the published config.json's numbers and groups (hf:deepseek-ai/DeepSeek-V2-Lite)
PUBLISHED = {
    "first_k_dense_replace": 1, "hidden_size": 2048, "intermediate_size": 10944, "kv_lora_rank": 512,
    "max_position_embeddings": 163840, "moe_intermediate_size": 1408, "moe_layer_freq": 1, "n_group": 1,
    "n_routed_experts": 64, "n_shared_experts": 2, "num_attention_heads": 16, "num_experts_per_tok": 6,
    "num_hidden_layers": 27, "num_key_value_heads": 16, "qk_nope_head_dim": 128, "qk_rope_head_dim": 64,
    "rms_norm_eps": 1e-06, "rope_theta": 10000, "routed_scaling_factor": 1, "topk_group": 1, "v_head_dim": 128,
    "vocab_size": 102400,
    "rope_scaling": {"beta_fast": 32, "beta_slow": 1, "factor": 40, "mscale": 0.707, "mscale_all_dim": 0.707,
                     "original_max_position_embeddings": 4096, "type": "yarn"},
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def load(tiny: bool = False) -> dict:
    return world.load_cell(CELL, tiny=tiny)


def last_line(fault: str | None = None, seed: int = 23_456_789_012) -> tuple:
    """One tiny run in a fresh interpreter (a run refuses to report once JAX
    is loaded), the model's faults registered beside the generic ones."""
    code = ("import sys, torch; torch.set_num_threads(1); from ehfl_bench import run, faults_lm; "
            "faults_lm.register(); "
            f"sys.exit(run.main(['--workload', {CELL!r}, '--seed', '{seed}', '--seconds', '0.3', '--trace', '0'], "
            f"device='cpu', tiny=True, fault={fault!r}))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    lines = proc.stdout.strip().splitlines()
    return proc.returncode, json.loads(lines[-1]) if lines else proc.stderr[-3000:]


def test_the_cell_runs_and_matches_the_reference():
    rc, res = last_line()
    assert rc == 0 and res["correct"] is True, res
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["metrics"]) == {"epoch_ms", "peak_mem_gib", "setup_s"}


@pytest.mark.parametrize("fault", sorted(LM_FAULTS))
def test_a_planted_model_fault_is_not_correct(fault):
    rc, res = last_line(fault)
    assert rc == 0 and res["correct"] is False, (fault, res["checks"])


def test_the_fp8_control_is_not_correct():
    from ehfl_bench import check

    w = run.build(load(tiny=True), 515151, torch.device("cpu"))
    _, snaps, _ = run.check_epochs(w, run.settle(w))
    assert check.passed(check.judge(run.compare(w, snaps), w.cell["limits"]))
    assert not check.passed(check.judge(run.compare(w, snaps, side="control"), w.cell["limits"]))


def test_the_file_holds_the_published_config_but_the_cut():
    conf = world.load_json(world.BENCH / "configs" / "deepseek-v2-lite-5l-ep8.json")
    changed = {k for k, v in PUBLISHED.items() if conf[k] != v}
    assert changed == {"n_routed_experts", "vocab_size"} and changed <= set(conf["reduced"])
    assert (conf["n_routed_experts"], conf["vocab_size"], conf["layers_held"]) == (8, 12800, 5)
    model = conf["model"]
    assert model["num_hidden_layers"] == conf["layers_held"] and model["experts_held"] == conf["n_routed_experts"]
    for k in ("hidden_size", "kv_lora_rank", "qk_nope_head_dim", "qk_rope_head_dim", "v_head_dim", "intermediate_size",
              "moe_intermediate_size", "num_experts_per_tok", "n_shared_experts", "rope_scaling", "rms_norm_eps"):
        assert model[k] == PUBLISHED[k], k  # every width as published
    assert model["n_routed_experts"] == 64 and model["vocab_size"] == conf["vocab_size"]
    entry = {c["name"]: c for c in run.benchmark_entry()["configs"]}["deepseek-v2-lite-5l-ep8"]
    assert entry["file"] == "ehfl_bench/configs/deepseek-v2-lite-5l-ep8.json" and entry["reduced"] == conf["reduced"]
    assert conf["source"].startswith(entry["source"])


def test_the_port_config_is_the_registered_arch_cut():
    from repro_torch.configs import get_config

    model = world.load_json(world.BENCH / "configs" / "deepseek-v2-lite-5l-ep8.json")["model"]
    want = dataclasses.replace(get_config("deepseek-v2-lite"), num_layers=5, experts_held=8, vocab_size=12800)
    assert lm.port_config(model) == want


def test_counts_against_hand_counts():
    cell = load()
    model = cell["model_config"]["model"]
    # layer 0: MLA 13,763,072 + MLP 67,239,936 + norms 4,096; an expert layer: MLA 13,763,072 + 8 experts
    # 69,206,016 + shared 17,301,504 + router 131,072 + norms 4,096; embedding + head 52,428,800 + final norm 2,048
    layer0, moe_layer = 81_007_104, 100_405_760
    assert lm.param_count(model) == layer0 + 4 * moe_layer + 52_430_848 == 535_060_992
    assert lm.param_count(model) == cell["model_config"]["param_count"]
    # a token: projections 27,525,120 a layer (13,762,560 multiply-adds), the dense MLP 134,479,872, an expert
    # layer's router 262,144 + shared 34,603,008 + 6 x 8/64 routed 12,976,128, the head 52,428,800; and the
    # causal attention core 2 x 16 x 320 x 2048 x 2049 / 2 a sequence and layer
    per_token = 5 * 27_525_120 + 134_479_872 + 4 * (262_144 + 34_603_008 + 12_976_128) + 52_428_800
    core = 2 * 16 * 320 * 2048 * 2049 // 2
    assert lm.forward_flops(model) == 2048 * per_token + 5 * core
    assert lm.leaf_bytes(model) == {"bfloat16": (535_060_992 - 4 * 131_072, 2), "float32": (4 * 131_072, 4)}
    assert lm.feature_dim(model) == 12_800 and lm.feature_bytes() == 4
    cfg = world.ehfl_config(cell, 0)
    fwd = lm.forward_flops(model)
    # 2 started clients: 4 steps of 2 sequences, forward + backward + feature tap; the probe 8 x 2; one eval of 8
    flops = lm.useful_flops(cell, cfg, n_epochs=1, n_started=2, n_evals=1)
    assert flops == 2 * 4 * 2 * fwd * 4 + 8 * 2 * fwd + 8 * fwd


def test_the_lm_reference_loads_nothing_of_the_program():
    from ehfl_bench.test_ehfl_bench_imports import FORBIDDEN, loaded_top_levels

    found = loaded_top_levels("import ehfl_bench.reference.deepseek_v2, ehfl_bench.reference.ehfl")
    assert not found & set(FORBIDDEN + ["repro_torch"]), found
    harness = loaded_top_levels("import torch; torch.set_num_threads(1); from ehfl_bench import run, faults_lm; "
                                "run.import_port(); import ehfl_bench.families.lm; from repro_torch.fl import backend")
    assert "repro_torch" in harness and not harness & set(FORBIDDEN)


# one epoch (us): the probe's forward and one SGD step's, each through an attention core and an expert
# layer, and device operations (name, start, end, launch)
EPOCH_RANGES = [
    ("ehfl.probe", 0, 300), ("lm.attn", 20, 80), ("lm.moe", 100, 200), ("lm.moe.route", 100, 120),
    ("lm.moe.experts", 120, 180), ("ehfl.local_train.grad", 400, 700), ("lm.attn", 410, 450), ("lm.moe", 460, 520),
]
EPOCH_OPS = [
    ("scores", 30, 90, 25), ("softmax", 85, 120, 60),  # the probe's core: their union, 90
    ("router", 130, 140, 105), ("expert_gemm", 140, 210, 130), ("Memcpy DtoD", 205, 215, 190),  # 85
    ("head", 250, 300, 250), ("vaoi_distance", 310, 320, None),  # launched under neither
    ("scores_bwd_fwd", 420, 470, 415),  # the step's core: 50
    ("expert_fwd", 470, 500, 465),  # the step's expert layer: 30
    ("expert_bwd", 530, 600, 530),  # the backward, launched after the forward's range closed
]


def shifted(rows, by):
    return [(r[0], r[1] + by, r[2] + by, *[None if x is None else x + by for x in r[3:]]) for r in rows]


def window(ranges=EPOCH_RANGES):
    cell = load()
    return trace(epochs=2, ranges=ranges + shifted(ranges, 1000), device_ops=EPOCH_OPS + shifted(EPOCH_OPS, 1000),
                 cell=cell, cfg=world.ehfl_config(cell, 0), family=lm)


def test_lm_readers_against_hand_counts(monkeypatch):
    from repro_torch.models import moe

    tr = window()
    assert run.load_reader("lm.attn.device_ms")(tr) == pytest.approx(0.140)
    assert run.load_reader("lm.moe.device_ms")(tr) == pytest.approx(0.115)
    # 8 held experts each compute every token: 3 calls of 2 x 2048 tokens
    monkeypatch.setitem(moe.COUNTS, "rows", 3 * 8 * 2 * 2048)
    monkeypatch.setitem(moe.COUNTS, "tokens", 3 * 2 * 2048)
    assert run.load_reader("lm.moe.rows_per_token")(tr) == 8.0


def test_lm_readers_return_nothing_without_records(monkeypatch):
    from repro_torch.models import moe

    # a window without the lm.* ranges (a program that has no such spans), and an empty counter
    tr = window([r for r in EPOCH_RANGES if not r[0].startswith("lm.")])
    monkeypatch.setitem(moe.COUNTS, "rows", 0)
    monkeypatch.setitem(moe.COUNTS, "tokens", 0)
    for name in sorted(LM_METRICS):
        assert run.load_reader(name)(tr) is None, name
    # a program whose expert layer has no counter
    monkeypatch.delattr(moe, "COUNTS")
    assert run.load_reader("lm.moe.rows_per_token")(tr) is None


def test_the_cell_reports_the_lm_metrics():
    names = {m["name"] for m in run.per_layer_metrics(CELL)}
    assert names == LM_METRICS | {
        "device_idle_share", "kernel_launches_per_epoch", "epoch_mfu", "probe.device_ms", "vaoi_distance.roofline_pct",
        "slot_scan.host_ms", "local_train.device_ms", "slab.useful_pct", "state.resident_gib",
        "local_train.grad.device_ms", "local_train.grad.launches_per_step", "local_train.feature.device_ms",
        "scatter.device_ms"}
    assert {m["name"] for m in run.end_to_end_metrics(CELL)} == {"epoch_ms", "peak_mem_gib", "setup_s"}
    for cell in ("paper-cnn.n100.vaoi", "paper-cnn.n100.fedavg", "paper-cnn.n1000.vaoi"):
        assert not LM_METRICS & {m["name"] for m in run.per_layer_metrics(cell)}, cell
