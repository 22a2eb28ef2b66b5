#!/usr/bin/env python3
"""Time one arch's prefill step for two source trees of the port, in turns,
on one GPU: tree A, tree B, tree B, tree A, each in a fresh process.

    python3 tools/prefill_compare.py --arch whisper-large-v3 --a <dir> --b <dir>

Each directory holds a checkout (its ``src/repro_torch``).  A process builds
the kernels from its tree, draws the arch's published-width weights (bf16,
seed 0) and the same inputs as ``chip_smoke.py`` phase 11 (B x S tokens,
prefix embeddings or encoder frames where the arch takes them), runs one
warm-up prefill and then ``--runs`` timed ones (host clock ended by
synchronize), and prints one JSON line.  The last line is the medians by
tree, beside the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys

CHILD = r"""
import json, statistics, sys, time
sys.path.insert(0, sys.argv[1] + "/src")
import torch
from repro_torch.configs import get_config
from repro_torch.kernels import build
from repro_torch.launch.steps import make_prefill_step
from repro_torch.models import decoder
arch, bsz, seq, runs = sys.argv[2], int(sys.argv[3]), int(sys.argv[4]), int(sys.argv[5])
build.build()
cfg = get_config(arch)
dev = torch.device("cuda")
params = decoder.init_params(cfg, seed=0, device=dev)
g = torch.Generator(device=dev).manual_seed(1)
batch = {"tokens": torch.randint(0, cfg.vocab_size, (bsz, seq), generator=g, device=dev)}
if cfg.num_prefix_tokens:
    prefix = torch.randn(bsz, cfg.num_prefix_tokens, cfg.d_model, generator=g, device=dev) * 0.02
    batch["prefix_embeddings"] = prefix.to(cfg.dtype)
if cfg.is_encoder_decoder:
    batch["encoder_frames"] = torch.randn(bsz, cfg.encoder_seq, cfg.d_model, generator=g, device=dev).to(cfg.dtype)
prefill = make_prefill_step(cfg)
prefill(params, batch)
torch.cuda.synchronize()
times = []
for _ in range(runs):
    t0 = time.perf_counter()
    prefill(params, batch)
    torch.cuda.synchronize()
    times.append((time.perf_counter() - t0) * 1e3)
print(json.dumps({"tree": sys.argv[1], "runs_ms": times, "median_ms": statistics.median(times)}))
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--a", required=True, help="first tree (e.g. the parent commit)")
    ap.add_argument("--b", required=True, help="second tree (e.g. the change)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=448)
    ap.add_argument("--runs", type=int, default=5)
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    medians = {args.a: [], args.b: []}
    for tree in (args.a, args.b, args.b, args.a):
        out = subprocess.run([sys.executable, "-c", CHILD, tree, args.arch, str(args.batch), str(args.seq),
                              str(args.runs)], capture_output=True, text=True, check=True, timeout=900)
        row = json.loads(out.stdout.strip().splitlines()[-1])
        print(json.dumps(row), flush=True)
        medians[tree].append(row["median_ms"])
    print(json.dumps({"arch": args.arch, "batch": args.batch, "seq": args.seq, "medians_ms": medians,
                      "device": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
