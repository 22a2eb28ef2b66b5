"""What the harness and the reference load: no module whose top-level name,
compared whole, is jax, jaxlib, flax or repro (the JAX package; the port
``repro_torch`` only begins with its name); the reference loads nothing of
the port either.  Each check runs in a fresh interpreter, since the test
process itself may hold JAX from other test files."""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ["jax", "jaxlib", "flax", "repro"]


def loaded_top_levels(code: str) -> set:
    probe = code + "; import sys, json; print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"
    proc = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return set(json.loads(proc.stdout.strip().splitlines()[-1]))


def test_the_harness_loads_no_jax_and_not_the_jax_package():
    code = ("import torch; torch.set_num_threads(1); from ehfl_bench import run, control, faults; "
            "run.import_port(); "
            "import ehfl_bench.families.cnn, ehfl_bench.reference.cnn, ehfl_bench.reference.ehfl; "
            "from repro_torch.fl import backend; from repro_torch.models import cnn; "
            "[run.load_reader(m['name']) for m in run.benchmark_entry()['per_layer']]")
    found = loaded_top_levels(code)
    assert "repro_torch" in found
    assert not found & set(FORBIDDEN), found & set(FORBIDDEN)


def test_the_reference_loads_nothing_of_the_program():
    found = loaded_top_levels("import ehfl_bench.reference.cnn, ehfl_bench.reference.ehfl")
    assert not found & set(FORBIDDEN + ["repro_torch"]), found


def test_a_run_ends_with_no_jax_loaded():
    code = ("import io, contextlib, torch; torch.set_num_threads(1); from ehfl_bench import run; "
            "buf = io.StringIO(); "
            "ctx = contextlib.redirect_stdout(buf); ctx.__enter__(); "
            "rc = run.main(['--workload', 'paper-cnn.n100.vaoi', '--seed', '3', '--seconds', '0.2', '--trace', '0'], "
            "device='cpu', tiny=True); ctx.__exit__(None, None, None); assert rc == 0")
    assert not loaded_top_levels(code) & set(FORBIDDEN)


LATE_IMPORT = {
    # a per-layer reader that imports JAX inside read(), in a traced run (the
    # profiler's capture stood in by an untraced window: the CPU has no kernels)
    "reader": ("def capture(fn):\n"
               "    t0 = time.perf_counter(); res = fn()\n"
               "    return res, {'window_s': time.perf_counter() - t0, 'device_ops': [], 'ranges': []}\n"
               "def load_reader(name):\n"
               "    def read(tr):\n"
               "        import jax\n"
               "    return read\n"
               "run.capture, run.load_reader = capture, load_reader\n", "1"),
    # the reference importing JAX once the window has closed
    "reference": ("real = run.compare\n"
                  "def compare(*a, **k):\n"
                  "    import jax\n"
                  "    return real(*a, **k)\n"
                  "run.compare = compare\n", "0"),
}


@pytest.mark.parametrize("where", sorted(LATE_IMPORT))
def test_jax_loaded_after_the_window_leaves_no_result(tmp_path, where):
    """The gate runs last: JAX loaded by a reader or the reference, after
    the window, still ends the run with no result line."""
    (tmp_path / "jax").mkdir()
    (tmp_path / "jax" / "__init__.py").write_text("")
    patch, trace = LATE_IMPORT[where]
    code = (f"import sys, time, torch; sys.path.insert(0, {str(tmp_path)!r}); torch.set_num_threads(1)\n"
            "from ehfl_bench import run\n" + patch +
            "sys.exit(run.main(['--workload', 'paper-cnn.n100.vaoi', '--seed', '3', '--seconds', '0.2', "
            f"'--trace', '{trace}'], device='cpu', tiny=True))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == "", (proc.stdout[-2000:], proc.stderr[-2000:])
    assert "the run loaded jax" in proc.stderr, proc.stderr[-2000:]
