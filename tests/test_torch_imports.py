"""The port stands alone: no module of ``src/repro_torch/``, no torch
example (``examples/*_torch.py``) or bench (``benchmarks/*_torch.py``) and
nothing in ``chip_smoke.py`` or the tools that drive it
(``tools/ehfl_step_survey.py``, ``tools/prefill_compare.py``,
``tools/vaoi_plan_sweep.py``), nor the
launch layer's inspection script (``experiments/perf/inspect_comms_torch.py``), imports
``jax`` or the JAX package ``repro``; and its entry points never quietly
fall back to the CPU."""
import ast
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = (
    sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    + sorted((ROOT / "examples").glob("*_torch.py"))
    + sorted((ROOT / "benchmarks").glob("*_torch.py"))
    + [ROOT / "chip_smoke.py", ROOT / "tools" / "ehfl_step_survey.py", ROOT / "tools" / "prefill_compare.py",
       ROOT / "tools" / "vaoi_plan_sweep.py", ROOT / "experiments" / "perf" / "inspect_comms_torch.py"]
)


def imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
            if node.module == "benchmarks":  # a bench module imported by name
                yield from (f"benchmarks.{a.name}" for a in node.names)


def test_port_files_exist():
    assert len(PORT_FILES) > 20
    assert (ROOT / "chip_smoke.py").exists()
    names = {p.name for p in PORT_FILES}
    assert {"channel.py", "stream.py", "ehfl_cifar_torch.py", "serve_demo_torch.py"} <= names


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [m for m in imported_modules(path) if m.split(".")[0] in ("jax", "jaxlib", "repro", "flax", "optax")
           or (m.startswith("benchmarks.") and not m.endswith("_torch"))]  # the JAX benches import jax
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


@pytest.mark.parametrize(
    "entry",
    [
        "run_simulation", "run_batch", "init_carry", "make_federated_dataset",
        "decoder.init_params", "decoder.init_cache", "decoder_params_from_reference",
        "starcoder2.init_params", "starcoder2.init_cache", "starcoder2.params_from_reference",
        "stream_bench_torch.run", "channel_bench_torch.run", "fleet_bench_torch.run", "kernels_bench_torch.run",
    ],
)
def test_entry_points_raise_without_cuda(entry, monkeypatch):
    from repro_torch.checkpoint.convert import decoder_params_from_reference
    from repro_torch.configs import CNNConfig, get_config, reduced
    from repro_torch.core import EHFLConfig, init_carry, run_batch, run_simulation
    from repro_torch.data import make_federated_dataset
    from repro_torch.fl import cnn_backend
    from repro_torch.models import decoder

    sys.path.insert(0, str(ROOT))
    from benchmarks import channel_bench_torch, fleet_bench_torch, kernels_bench_torch, stream_bench_torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tiny = CNNConfig(image_size=8, conv_channels=(2, 2, 2, 2, 2, 2), fc_dims=(4, 4))
    cfg = EHFLConfig(num_clients=2, epochs=1, k=1)
    lm = reduced(get_config("mamba2-1.3b"))
    sc = reduced(get_config("starcoder2-3b"))
    calls = {
        "run_simulation": lambda: run_simulation(cfg, cnn_backend(tiny), {}),
        "run_batch": lambda: run_batch(cfg, cnn_backend(tiny), {}, [0, 1]),
        "decoder.init_params": lambda: decoder.init_params(lm),
        "decoder.init_cache": lambda: decoder.init_cache(lm, 1, 8),
        "decoder_params_from_reference": lambda: decoder_params_from_reference({"blocks": ({},)}, lm),
        "starcoder2.init_params": lambda: decoder.init_params(sc),
        "starcoder2.init_cache": lambda: decoder.init_cache(sc, 1, 8),
        "starcoder2.params_from_reference": lambda: decoder_params_from_reference({"blocks": ({},)}, sc),
        "init_carry": lambda: init_carry(cfg, cnn_backend(tiny)),
        "make_federated_dataset": lambda: make_federated_dataset(0, num_clients=2, samples_per_client=2),
        "stream_bench_torch.run": lambda: stream_bench_torch.run(True),
        "channel_bench_torch.run": lambda: channel_bench_torch.run(True),
        "fleet_bench_torch.run": lambda: fleet_bench_torch.run(True),
        "kernels_bench_torch.run": lambda: kernels_bench_torch.run(True),
    }
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calls[entry]()


def test_unported_config_axes_raise():
    """Every scenario axis is ported: each scenario builds a carry; only an
    unknown scenario name raises."""
    from repro_torch.core import CHANNEL_SCENARIOS, SCENARIOS, STREAM_SCENARIOS, EHFLConfig
    from repro_torch.core.simulator import init_carry
    from repro_torch.configs import CNNConfig
    from repro_torch.fl import cnn_backend

    backend = cnn_backend(CNNConfig(image_size=8, conv_channels=(2,) * 6, fc_dims=(4, 4)))
    axes = (("harvest", SCENARIOS), ("stream", STREAM_SCENARIOS), ("channel", CHANNEL_SCENARIOS))
    for axis, names in axes:
        for name in names:
            init_carry(EHFLConfig(num_clients=2, **{axis: name}), backend, device="cpu")
        with pytest.raises(ValueError, match="known"):
            init_carry(EHFLConfig(num_clients=2, **{axis: "bogus"}), backend, device="cpu")
