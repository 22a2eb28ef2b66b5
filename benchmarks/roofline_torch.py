"""The roofline table from the port's dry-run records; the counterpart of
``benchmarks/roofline.py``.

Reads ``experiments/dryrun_torch/*.json`` (written by
``python -m repro_torch.launch.dryrun``) and emits ``roofline.py``'s rows
under its names: one per (arch x shape x mesh x variant), the roofline-bound
step time in us (the largest of the three terms), the three terms, the
bottleneck and the useful-FLOP ratio.  The terms use the H100's constants
(``repro_torch/launch/mesh.py``), and the memory term the unfused byte
count, an upper bound (``launch/cost_analysis.py``).  Run it as the
``roofline`` suite of ``benchmarks/run_torch.py``; it reads files only, so
``device`` is not used.
"""
from __future__ import annotations

import json
from pathlib import Path

DRYRUN = Path(__file__).resolve().parent.parent / "experiments" / "dryrun_torch"


def load_records():
    recs = []
    for f in sorted(DRYRUN.glob("*.json")):
        try:
            r = json.loads(f.read_text())
        except (OSError, ValueError):  # a record being written, or not JSON: not a row
            continue
        r["_file"] = f.stem
        recs.append(r)
    return recs


def run(quick: bool = True, device=None):
    rows = []
    for rec in load_records():
        variant = rec["_file"].split("__", 2)[-1].replace("__", "+")
        name = f"roofline/{rec['arch']}/{rec['shape']}/{rec['mesh']}/{variant}"
        if "skipped" in rec:
            rows.append({"name": name, "us_per_call": 0.0, "derived": f"skipped={rec['skipped']}"})
            continue
        if "error" in rec:
            rows.append({"name": name, "us_per_call": 0.0, "derived": "ERROR"})
            continue
        r = rec["roofline"]
        dom = r["bottleneck"]
        step_s = max(r["compute_s"], r["memory_s"], r["collective_s"])
        ratio = rec.get("useful_flop_ratio")
        rows.append(
            {
                "name": name,
                "us_per_call": step_s * 1e6,  # roofline-bound step time
                "derived": (
                    f"compute_s={r['compute_s']:.3e};memory_s={r['memory_s']:.3e};"
                    f"collective_s={r['collective_s']:.3e};bottleneck={dom};"
                    f"useful_flop_ratio={ratio:.3f}" if ratio else f"bottleneck={dom}"
                ),
            }
        )
    if not rows:
        rows.append({"name": "roofline/NO_DRYRUN_DATA", "us_per_call": 0.0,
                     "derived": "run: python -m repro_torch.launch.dryrun --all"})
    return rows
