#!/usr/bin/env python3
"""Time one arch's prefill step (and, with ``--decode``, its serve step) for
two source trees of the port, in turns, on one GPU: tree A, tree B, tree B,
tree A, each in a fresh process.

    python3 tools/prefill_compare.py --arch whisper-large-v3 --a <dir> --b <dir>
    python3 tools/prefill_compare.py --arch llama4-scout-17b-a16e --layers 12 --batch 1 --seq 4096 \
        --decode 16 --a <dir> --b <dir>

Each directory holds a checkout (its ``src/repro_torch``).  A process builds
the kernels from its tree, draws the arch's published-width weights (bf16,
seed 0) and the same inputs as ``chip_smoke.py`` phase 11 (B x S tokens,
prefix embeddings or encoder frames where the arch takes them), runs one
warm-up prefill and then ``--runs`` timed ones (host clock ended by
synchronize), then ``--decode`` serve steps of the same batch from an empty
cache, each timed alone (the median leaves out the first two), and prints
one JSON line.  ``--layers`` cuts the depth as phase 11 does (0: the
published depth).  The last line is the medians by tree, beside the card's
name and power limit.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys

CHILD = r"""
import dataclasses, json, statistics, sys, time
sys.path.insert(0, sys.argv[1] + "/src")
import torch
from repro_torch.configs import get_config
from repro_torch.kernels import build
from repro_torch.launch.steps import make_prefill_step, make_serve_step
from repro_torch.models import decoder
arch, bsz, seq, runs, layers, steps = sys.argv[2], *map(int, sys.argv[3:8])
build.build()
cfg = get_config(arch)
if layers:
    cfg = dataclasses.replace(cfg, num_layers=layers)
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
row = {"tree": sys.argv[1], "runs_ms": times, "median_ms": statistics.median(times)}
if steps:
    cache = decoder.init_cache(cfg, bsz, steps, device=dev, cross_cache=cfg.is_encoder_decoder)
    if cfg.is_encoder_decoder:
        cache = decoder.prefill_cross_cache(cfg, params, cache, decoder.encode(cfg, params, batch["encoder_frames"]))
    serve = make_serve_step(cfg)
    step_ms = []
    for t in range(steps):
        t0 = time.perf_counter()
        _, cache = serve(params, cache, batch["tokens"][:, t : t + 1], torch.full((bsz,), t, device=dev))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    row.update(decode_ms=step_ms, decode_median_ms=statistics.median(step_ms[2:]))
print(json.dumps(row))
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--a", required=True, help="first tree (e.g. the parent commit)")
    ap.add_argument("--b", required=True, help="second tree (e.g. the change)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=448)
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--layers", type=int, default=0, help="depth cut (0: the published depth)")
    ap.add_argument("--decode", type=int, default=0, help="serve steps to time after the prefills")
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    medians, decode = {args.a: [], args.b: []}, {args.a: [], args.b: []}
    for tree in (args.a, args.b, args.b, args.a):
        out = subprocess.run([sys.executable, "-c", CHILD, tree, args.arch, str(args.batch), str(args.seq),
                              str(args.runs), str(args.layers), str(args.decode)], capture_output=True, text=True,
                             check=True, timeout=900)
        row = json.loads(out.stdout.strip().splitlines()[-1])
        print(json.dumps(row), flush=True)
        medians[tree].append(row["median_ms"])
        decode[tree].append(row.get("decode_median_ms"))
    print(json.dumps({"arch": args.arch, "layers": args.layers, "batch": args.batch, "seq": args.seq,
                      "medians_ms": medians, "decode_medians_ms": decode if args.decode else None, "device": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
