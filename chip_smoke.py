#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--epochs T]

Phases, each of which must pass (any failure exits non-zero and prints no
result line):

1. Device: the card's name and power limit as nvidia-smi reports them.
2. Build: the six Hopper kernels from ``src/repro_torch/csrc`` with nvcc
   (sm_90a), one nvcc per source, all started together; ptxas' registers,
   spills and shared memory for each ssd_scan, swa_attention and
   mla_attention instance (the bf16 tensor-core instances the prefills run,
   ssd_scan's at ds = 128 and swa_attention's at D = 128, must not spill).
3. Kernels against their plain PyTorch versions on the card, at the main
   paths' shapes (timed with CUDA events; the EHFL kernels also by their
   device time under torch.profiler, without the wrapper's host time) and
   over ragged fp32/bf16 sweeps.  vaoi_distance at (100, 10) beside its
   launch floor (the wrapper's whole path into an empty kernel on the same
   plan, grid and cluster shape) and ``vector_norm``, the three timed in
   turns, and the wrapper path's steps on the host clock; vaoi_distance's
   wide route at (8, 151,936), (4, 102,400) and (1024, 4096) (VAOI_WIDE:
   rows split over a thread-block cluster, 16-byte loads), each by event
   and device time beside its launch floor and ``vector_norm`` in turns,
   its byte bound and its plan; the vaoi sweep covers every plan (the
   thread route, the cluster route at S = 1 to 16, rows off 16-byte
   alignment), sets mu between the rows' m so both branches of Eq. 7 are
   taken and the ages compared exactly, and holds two calls at F > 32
   equal bit for bit;
   fedavg_reduce in the TPU kernel's signature at
   (10, 845,738) and (100, 845,738) beside ``torch.mv``, then the main
   path's launch, the leaf table (the CNN's 18 leaves, a slab group of 10
   rows and an old-carrier group of 100, read in place), beside its byte
   bound, its plain version and the library route it replaces (two
   ``torch.cat``, two ``torch.mv``, the add); a ragged sweep of the leaf
   table whose 110-row tables hold non-finite values under weight 0, which
   must come out NaN in exactly their columns; ssd_scan and swa_attention at
   their prefill shapes both in bf16 on their tensor-core routes (each
   element within ``ssd_bf16_limit`` / ``bf16_limit``; a plain scan without
   the state's decay across chunks, and a plain attention one key tile
   short of the window, must fail those limits) and on the same inputs in
   fp32 on their FMA routes (1e-4 of the largest output / 2e-5), both routes
   timed.  Then both LM kernels at phase 11's prefill shapes (ZOO_SWA_SHAPES:
   head dims 64 and 128, GQA groups 1 to 8, whisper's encoder non-causal
   over 1500 frames; ZOO_SSD_SHAPE, jamba's scan at ds 16 over 128 heads),
   bf16, each element within its limit, timed beside the plain version and
   (attention) SDPA.  mla_attention at the LM cell's shapes (MLA_SHAPES:
   B 4 and 16, S 2048, 16 heads, q/k 192, v 128), forward and backward, each
   element within ``reference_and_limits`` (the plain bf16 path must fail
   the forward's), timed beside its bound, the plain version and SDPA, and
   its launches in one epoch of the LM cell (MLA_CELL_LAUNCHES: 45 forward,
   20 backward).  Last conv_lanes (CONV_LANES_SHAPES: the paper CNN's six
   convolutions, 100 and then 10 lanes of 15 images), each direction within
   ``conv_lanes_limit`` of its plain version in strict fp32, timed in turns
   with it and the grouped ``F.conv2d`` call, beside its bound.
4. The EHFL slice: ``run_simulation`` at the paper's width (the 845,738-parameter
   CNN, N=100 clients x 300 samples, k=10, S=30, kappa=20, a 500-image test
   set) for T epochs on the GPU, with ``TorchDraws(seed=0)``.  Only the depth
   T is cut (the paper runs 500 epochs).  The kernel launch counters must
   read T for vaoi_distance and T for fedavg_reduce (one leaf-table launch
   an epoch reduces both the slab and the old-carrier stack), T * kappa * 23
   for conv_lanes (``cnn_conv_launches``: 17 a vmapped SGD step, 6 a
   feature forward; the CNN's EHFL runs of the later phases the same way),
   and by direction T * kappa * 12 forward, 5 input-grad and 6 weight-grad
   launches (``cnn_conv_directions``), and fedavg_reduce's row-group counter 2T.
5. The same run on the CPU (plain versions, same data, init and draws):
   integer dynamics, ages and selections equal exactly; params and f1
   within the stated fp32 tolerances.  The last GPU epoch runs under
   torch.profiler: each ``ehfl.*`` layer's host and device time, and
   ``ehfl.fedavg`` must hold no ``aten::cat`` and no concatenation kernel
   (9a's profiled epochs too).
6. The serving slice: ``mamba2-1.3b`` at its published width and depth
   (48 layers, d 2048, vocab 50280, bf16), random weights from
   ``torch.Generator`` seed 0 on the card.  (a) ``make_prefill_step`` on
   B=4 prompts x P=2048: median time, prefill tokens/s, and the ssd_scan
   counter at exactly 48 per call, all on the tensor-core route, plus one
   profiled prefill by
   ``lm.*`` range; (b) the same prefill through the plain chunked scan,
   logits compared; (c) requests as ``examples/serve_demo_torch.py`` runs
   them: B=4 prompts of P=320 stepped through ``make_serve_step``, then 32
   greedy tokens; (d) the kernel-route prefill logits at P=320 against the
   serve step's logits at the last prompt token (chunked scan against the
   exact recurrence), in bf16 and in an fp32 copy of the weights; (e) peak
   GPU memory.
7. The attention slice: ``starcoder2-3b`` at its published width and depth
   (30 layers, d 3072, 24 query heads and 2 KV heads of 128, gelu MLP
   12288, vocab 49152, window 4096, bf16), random weights from
   ``torch.Generator`` seed 0 on the card, after the Mamba2 weights are
   freed.  (a) ``make_prefill_step`` on B=1 x P=16384 (StarCoder2's
   training context): median time, prefill tokens/s, the swa_attention
   counter at exactly 30 per call, all on the tensor-core route, one
   profiled prefill by ``lm.*`` range;
   (b) the same prefill through the plain masked-softmax route, logits
   compared; (c) requests: B=4 prompts of P=320 stepped through
   ``make_serve_step`` (a rolling KV cache), then 32 greedy tokens; (d) the
   kernel-route prefill logits at P=320 against the serve step's at the
   last prompt token, in bf16 and in an fp32 copy of the weights; (e) peak
   GPU memory; (f) a rolling wrap at the same width: 2 layers, window 256,
   fp32, 600 tokens stepped, every 50th step's logits held against a
   kernel-route prefill of the same prefix.
11. The rest of the zoo (``ZOO``), each at its published width, bf16,
   random weights from ``torch.Generator`` seed 0 on the card, freed before
   the next: qwen1.5-0.5b, codeqwen1.5-7b, command-r-35b, deepseek-moe-16b,
   llama4-scout-17b-a16e at 12 of 48 layers (215.5 GB whole),
   jamba-v0.1-52b at 16 of 32 (two super-blocks of 8; 102.9 GB whole),
   internvl2-2b with 256 prefix embeddings a row and whisper-large-v3 over
   1500 encoder frames.  For each, as in phases 6 and 7: (a) the prefill
   step, median of 3 after a warm-up, the kernel counters at exactly the
   spec's launches on the tensor-core routes, one profiled prefill (the
   ``lm.moe`` and ``lm.cross`` ranges too) and, for MoE, the share of
   token-expert choices dropped at the published capacity; (b) the plain
   route, logits within LOGITS_LIMITS, and the same prefill with the
   attention kernel's causal mask off, which must fail them; (c) 4 requests
   of 32 prompt tokens (128 for the routed stacks) through the serve step
   (whisper's after its cross K/V cache is filled), then 8 greedy; (d) prefill against decode in bf16
   at the run's depth (MoE at capacity_factor E / k, where nothing drops;
   InternVL2 without a prefix) and in fp32 on a fresh 2-layer model at full
   width; (e) peak memory.
12. LM training at ``qwen1.5-0.5b``'s published width (24 layers, d 1024,
   vocab 151,936, bf16, random weights seed 0), after phase 11.  (a)
   ``launch/train.py``'s round function with ``repro.launch.train``'s
   defaults (8 clients, k = 2, 4 steps of 4 x 64 tokens, 3 rounds, mu
   0.001, lr 0.05): each round exactly 72 swa_attention launches (the
   probe's 24 and 24 for each of the k refreshes, all on the tensor-core
   route), 1 vaoi_distance and 10 fedavg_reduce (290 leaves in runs of
   32); round time, tokens trained per second, probe ms, peak memory, one
   profiled round by ``lm.train.*`` range; the probe's features through
   the kernel against the plain route (each attention call within
   bf16_limit, the features within PROBE_FEATURE_RTOL, which the kernel
   without its causal mask must exceed); Eq. 5 + 7 at (8, 151,936) and
   the 290-leaf mean against their plain versions, timed beside
   ``vector_norm`` and ``cat`` + ``mv``.  (b) ``make_train_step`` with
   remat and the chunked CE (C = 256) at 4 x 2048: a warm-up and 5 timed
   steps on one batch (the loss must fall), tokens/s, the share of bf16
   peak by 6·N·T, peak memory, one profiled step; the chunked loss
   against the full-logits loss.  (c) one mamba2-1.3b step at 1 x 2048.
   Then one fp32 step of a 2-layer cut at full width on the card against
   the same step on the CPU.  Phase 3 also holds swa_attention at the
   probe's and the refresh's shapes (TRAIN_SWA_SHAPES).
13. EHFL with routed LM clients (``ROUTED_*``), after phase 12.  (a)
   ``run_simulation`` with ``lm_backend`` for deepseek-moe-16b at its
   published width (d 2048, 64 routed experts of d_ff 1408 plus 2 shared,
   top-6, vocab 102,400, bf16, random weights seed 0), cut to 2 of 28
   layers, 4 clients x 16 sequences of 64 tokens, k = 2, kappa = 4, 3
   epochs: each epoch exactly one swa_attention launch per attention layer
   (the probe, on the tensor-core route), one vaoi_distance at (4, 102,400)
   (the cluster route, 16 segments a row) and ceil((13 L + 3) / 32) fedavg_reduce launches (the leaf table);
   steady epoch time, clients and tokens trained per second, probe ms, the
   share of choices dropped at capacity, peak memory, one profiled epoch;
   the EHFL kernels at these shapes against their plain versions; the MoE
   dispatch at published width in fp32 under vmap(grad) against a per-lane
   loop and against the prefill's call; one fp32 epoch of a 2-layer cut on
   the card against the CPU's (its local SGD teacher-forced step by step
   where a routing flip makes the free run part).  Phase 3 holds swa_attention at the probe's shape.  (b)
   llama4-scout-17b-a16e and jamba-v0.1-52b at reduced() through the same
   entry point, one epoch each, launches exact (jamba's probe launches
   ssd_scan too).
14. The drivers beside the package: ``examples/quickstart_torch.py`` cut
   to 10 epochs a policy and 4 a scenario seed, and one cell of ``benchmarks/ehfl_grid_torch.py``'s quick
   protocol (vaoi, alpha 0.1, p_bc 0.1, 2 seeds), each with its launches
   counted and its wall time.
9a. The scenario axes at phase 4's width and depth: three runs that cover
   every harvest, stream and channel scenario (markov + drift + fading;
   hetero + arrival + erasure at p_loss 0.3, concentration 1.0; diurnal
   with period 60 + shift with period 4 + aloha with 2 channels), each
   printing its epoch time, clients trained per second, f1 and the
   channel's failed and dropped totals; each must launch vaoi_distance T
   and fedavg_reduce T times over 2T row groups, fail some uploads, send
   retrying carriers
   through the old-carrier pass and account every attempt (n_delivered +
   n_failed = n_uploaded); some retransmission must land over the three.
   The first is held against the CPU epoch by epoch from shared state for
   3 epochs, as in phase 5, with the retry counters, the scenario state and
   the stream's view indices compared exactly; inside each epoch the CPU's
   local training is teacher-forced by the GPU's, SGD step by SGD step
   (each step from the GPU's weights within STEP_ATOL of the GPU's step),
   and the free-running spreads (GPU against itself, GPU against the
   unforced CPU) are printed beside it.
9b. ``run_batch`` over seeds 0, 1, 2 at phase 4's width and depth: 3T
   launches of each kernel and 6T fedavg_reduce row groups, the output
   shapes, per-seed epoch time and seeds per hour
   at T=500; then, under cuDNN's deterministic algorithms, seed 1 of the
   batch against a solo run of seed 1 (integer fields and selections
   exactly, params within phase 5's tolerance).
10. The client-sharded fleet (``core/fleet.py``) at phase 4's width and depth.
   10a: ``run_fleet`` on one NCCL rank in this process: T vaoi_distance and
   T fedavg_reduce launches over 2T row groups, its epoch time and clients
   trained per second beside phase 4's, one profiled epoch with the
   ``ehfl.fleet.*`` ranges (the collectives); under cuDNN's deterministic
   algorithms held against a solo run (slot dynamics, ages, selections and
   retry counters exactly; params, h within phase 5's tolerance).  10b:
   four gloo ranks on this one card (NCCL refuses two ranks on one GPU),
   25 clients a rank: the last 3 epochs held against the solo run on the
   card epoch by epoch from shared state (``fleet.shard_carry`` of the solo
   carry, the ranks' rows gathered back), deterministic cuDNN, some client
   training in them; each rank's T-epoch ``run_fleet`` counted (T
   vaoi_distance launches at (25, 10), T fedavg_reduce launches over 2T
   row groups) and timed, one profiled epoch a rank, and the all-reduces
   timed alone.  10c: the same four ranks at N=1024 (256 a rank) for T
   epochs: epoch time, clients trained per second, each rank's peak memory.
   Phase 3 also times vaoi_distance at a shard's (25, 10) beside its launch
   floor, and its sweeps hold the shards' shapes ((25, 10), (50, 10),
   (256, 10); leaf tables of a 10-row slab beside 25 and 256 old rows).
15. The bench suite (``benchmarks/run_torch.py``), after phase 10: the
   kernels, stream, channel and fleet suites at their quick protocols
   through the harness's suite functions, each file written to a temp
   directory and held to ``tools/check_bench.py::check_schema``.  Every
   stream and channel row counted: vaoi_distance exactly one launch an
   epoch under a VAoI policy (none otherwise), fedavg_reduce exactly one
   an epoch over two row groups when compacted (one when dense); the ideal
   channel rows bit for bit the static stream rows and the lossy rows'
   delivery semantics (``channel_bench_torch.check_ideal_bitmatch``),
   under cuDNN's deterministic algorithms as the benches run.  The fleet
   rows from one NCCL rank, then 4 gloo ranks on the card at N = 1024.
   Each suite's wall time.
16. The launch layer, after phase 15 (``LAUNCH_*``).  (a) In a child
   process, ``python -m repro_torch.launch.dryrun`` for qwen1.5-0.5b x
   train_4k at full shape (256 x 4096) on the 16 x 16 production mesh over
   a fake group of 256 ranks (fake tensors of device type cuda: nothing is
   allocated): per-device TFLOP, collective GB by kind, the roofline terms
   under the H100's constants, the trace time, and ``run_torch --only
   roofline``'s row for the record.  (b) One NCCL rank: phase 12b's step
   (4 x 2048, remat, chunked CE) on DTensors over the (1, 1) host mesh
   against the same step on plain tensors, loss and every new leaf
   compared; both timed (the DTensor step's extra time is DTensor's host
   cost); the (1, 1) dry-run's per-device FLOPs for the step over the plain
   step's time as a share of the bf16 peak.  The group is destroyed after.
8. Last: one JSON line listing every ported kernel, then the result line.

TF32 is switched off for cuDNN convolutions and matmuls, so the GPU runs
compute in full fp32 where they are fp32, like the plain versions they are
compared with.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import itertools
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
# H100 SXM published peaks, defined once with their source in the port
from repro_torch.launch.mesh import HBM_BW as HBM_BYTES_PER_S  # noqa: E402
from repro_torch.launch.mesh import PEAK_FLOPS_BF16 as BF16_FLOPS  # noqa: E402
from repro_torch.launch.mesh import PEAK_FLOPS_FP32 as FP32_FLOPS  # noqa: E402

# ssd_scan against ssd_scan_ref.  fp32 inputs (the FMA route): both read the
# same inputs and accumulate in fp32 (the kernel by chunks, the plain version
# step by step), so they differ only by summation order: error <= 1e-4 *
# max(1, max |ref|).  bf16 inputs (the tensor-core route) also round P, x*w
# and the state's copy to bf16: each element is held to
# kernels.ssd_scan.ssd_bf16_limit, derived from those roundings, and a plain
# scan without the state's decay across chunks must exceed that limit.
SSD_RTOL = 1e-4
# Serving.  Shapes of the issue: mamba2-1.3b's prefill B x P, starcoder2-3b's
# at its training context, and for both requests of REQ_P prompt tokens then
# REQ_G greedy tokens.
PREFILL_B, PREFILL_P, PREFILL_RUNS = 4, 2048, 5
SC_PREFILL_B, SC_PREFILL_P = 1, 16384
REQ_B, REQ_P, REQ_G = 4, 320, 32
# Logits of two routes through the model (kernel route against plain route,
# prefill against decode), as max |a - b| over max |b|, plus the least cosine
# similarity of a row: (bf16 rtol, bf16 least cosine, fp32 rtol) per model.
# In fp32 (TF32 off) the routes differ in summation order only.  In bf16 they
# round at 2**-8 per op in different orders, every residual add rounds in
# bf16, and the random-weight stack amplifies those differences.
# mamba2-1.3b: the 48-layer stack spreads them to 0.07-0.09 of the largest
# logit (cosine 0.996-0.997) on an H100 (PERF.md), where the fp32 copy of the
# same weights agreed to 2e-5: bf16 is held at 0.2 and cosine 0.99, which a
# wrong scan (uncorrelated rows) fails.  starcoder2-3b: its 30 layers read
# 0.0121 (cosine 0.99993) kernel against plain route at 16384 tokens and
# 0.0129 (cosine 0.99991) prefill against decode on an H100 (PERF.md), and
# the fp32 copy 2.8e-6: bf16 is held at 0.05 and cosine 0.999, fp32 at 1e-4.
# Phase 11 on an H100 (PERF.md): each fp32 2-layer check read 0.8e-6 to
# 6.6e-6, held at 1e-4.  The dense stacks, internvl2 and whisper read 0.012-0.023
# (cosine >= 0.99973) in both bf16 comparisons, as starcoder2-3b: held at
# 0.05 and 0.999, which their attention kernel run without its causal mask
# fails (0.084-1.63, cosine <= 0.9971).  deepseek-moe-16b read 0.111
# (cosine 0.9948) kernel against plain route, llama4-scout 0.031 (0.9994),
# jamba-v0.1-52b 0.094 (0.995; 14 SSM layers in bf16, as mamba2-1.3b): held
# at 0.3 and 0.98, 0.1 and 0.99, and mamba2's 0.2 and 0.99.  Without its
# causal mask the attention kernel reads 1.41 (0.13) and 0.86 (0.52); a scan
# kernel that swaps B and C reads 0.226 (0.979) on jamba.  Jamba's 2
# attention layers have no positions: over thousands of random keys each
# row's softmax is near uniform, and the causal-mask mutant moved its logits
# by 0.092 (0.9952), inside the limit, so it is printed, not required to fail.
LOGITS_LIMITS = {
    "mamba2-1.3b": (0.2, 0.99, 1e-3), "starcoder2-3b": (0.05, 0.999, 1e-4),
    "qwen1.5-0.5b": (0.05, 0.999, 1e-4), "codeqwen1.5-7b": (0.05, 0.999, 1e-4), "command-r-35b": (0.05, 0.999, 1e-4),
    "deepseek-moe-16b": (0.3, 0.98, 1e-4), "llama4-scout-17b-a16e": (0.1, 0.99, 1e-4),
    "jamba-v0.1-52b": (0.2, 0.99, 1e-4), "internvl2-2b": (0.05, 0.999, 1e-4), "whisper-large-v3": (0.05, 0.999, 1e-4),
}
# Prefill against decode in bf16 where the stack routes tokens to experts:
# top-k routing is discontinuous, and where bf16 rounding moves two experts'
# probabilities past each other the prefill and the decode step send the
# token to different experts (printed per layer; with top-1 that replaces its
# whole routed output).  The fp32 2-layer check holds the function itself at
# 1e-4.  deepseek-moe-16b read 0.074 (cosine 0.9971; 26 of 112 last-token
# routes differ), llama4-scout 0.263 (0.963; 1 of 48), jamba 0.175 (0.985;
# 4 of 32): held at 0.3 and 0.98, 0.5 and 0.9, 0.3 and 0.97.
PREFILL_DECODE_BF16 = {
    "deepseek-moe-16b": (0.3, 0.98), "llama4-scout-17b-a16e": (0.5, 0.9), "jamba-v0.1-52b": (0.3, 0.97),
}

# Phase 3's rows for phase 11: (B, H, Hkv, S, D, causal) of each arch's
# prefill attention (whisper: its encoder, non-causal over 1500 frames, and
# its decoder), and jamba's scan (B, S, heads, hp, ds, chunk)
ZOO_SWA_SHAPES = {
    "qwen1.5-0.5b": (4, 16, 16, 4096, 64, True),
    "codeqwen1.5-7b": (1, 32, 32, 4096, 128, True),
    "command-r-35b": (1, 64, 8, 4096, 128, True),
    "deepseek-moe-16b": (1, 16, 16, 4096, 128, True),
    "llama4-scout-17b-a16e": (1, 40, 8, 4096, 128, True),
    "jamba-v0.1-52b": (1, 32, 8, 4096, 128, True),
    "internvl2-2b": (4, 16, 8, 2048, 128, True),
    "whisper-large-v3 encoder": (4, 20, 20, 1500, 64, False),
    "whisper-large-v3 decoder": (4, 20, 20, 448, 64, True),
}
ZOO_SSD_SHAPE = (1, 4096, 128, 64, 16, 256)

# swa_attention against swa_attention_ref: both read the same inputs and keep
# scores, m, l and sums in fp32, so in fp32 (the FMA route) they differ by
# summation order (tests/test_kernels.py's 2e-5).  The bf16 route (tensor
# cores) also rounds each probability to bf16 before P V: each element is
# held to kernels.swa_attention.bf16_limit, 2**-8 sum_j p_ij |v_j| (that
# rounding's bound) + 2**-7 |ref| (a bf16 step of either output) + 1e-6,
# inside test_kernels.py's 0.05 absolute.  The plain version with the window
# one 64-key tile short (4032 for 4096) must exceed the same limit at the
# prefill shape, so the limit tells a right kernel from a wrong one.
SWA_TOL = {"float32": 2e-5, "bfloat16": 0.05}
SWA_MUTANT_SHORT = 64
# the rolling wrap: 2 layers at full width, window 256, fp32, 600 tokens
WRAP_LAYERS, WRAP_WINDOW, WRAP_B, WRAP_STEPS, WRAP_EVERY = 2, 256, 2, 600, 50

# Phase 5 tolerances, GPU (kernels, cuDNN, fp32) against CPU (plain, fp32),
# for one epoch from the same state.  The two run different convolution
# algorithms (cuDNN picks implicit-GEMM and Winograd kernels) and sum in
# different orders, and kappa=20 SGD steps through ReLU and max-pool are not
# smooth: where an activation sits near a switch, a rounding-sized
# difference flips it and the trained weights part by far more than
# rounding (up to 6.3e-4 per epoch on an H100, PERF.md).  Params and
# moments h are held to 2e-3 per epoch; M is one forward, held to 1e-5; one
# flipped prediction among 500 test images moves macro-F1 by about 0.004.
# The ages are compared exactly; their mean avg_age only to 1e-6, as the
# GPU divides by N through a reciprocal.  ``sgd_sensitivity`` reports how
# far one client's trained weights move on the GPU when its initial weights
# change by 1e-7 relative, the smooth part of that spread.  Free-running
# GPU and CPU trajectories part after a few epochs of training (some
# client's M lands within that spread of mu), which is why the comparison
# restarts every epoch from the GPU run's state.
PARAM_ATOL, M_ATOL, F1_ATOL, AGE_MEAN_ATOL = 2e-3, 1e-5, 0.01, 1e-6
EXACT = ("battery", "age", "pending", "counter")
EXACT_METRICS = ("selected", "n_started", "n_uploaded", "energy")

# Phase 9a: phase 4's run under three combinations that cover every
# harvest, stream and channel scenario; the first is held against the CPU
# for SCENARIO_CPU_EPOCHS epochs.  Phase 9b: run_batch over BATCH_SEEDS.
SCENARIO_RUNS = (
    ("markov_drift_fading", dict(harvest="markov", stream="drift", channel="fading")),
    ("hetero_arrival_erasure", dict(harvest="hetero", stream="arrival", channel="erasure",
                                    channel_params=(("p_loss", 0.3), ("concentration", 1.0)))),
    ("diurnal_shift_aloha", dict(harvest="diurnal", harvest_params=(("period", 60.0),), stream="shift",
                                 stream_params=(("period", 4.0),), channel="aloha",
                                 channel_params=(("num_channels", 2.0),))),
)
SCENARIO_CPU_EPOCHS = 3
# 9a's CPU epochs are teacher-forced step by step: at each of the kappa SGD
# steps the CPU computes its own update from the GPU's weights of the step
# before, is held to STEP_ATOL against the GPU's step, and goes on from the
# GPU's weights.  Free-running, the two part by the chaos described above
# before an epoch ends: under markov harvest 1-3 clients start in an epoch
# and h is per client, so no average damps one client's flip, and the GPU
# parts from itself (cuDNN's atomics, same inputs) by more than PARAM_ATOL
# (PERF.md).  One step from the same weights differs by the two devices'
# conv algorithms and summation orders, and where a rounding-sized
# difference flips a ReLU or a max-pool choice, by that position's share of
# the gradient: up to 6.4e-5 over 640 forced steps on an H100, against
# steps of 0.012-0.064 (tools/ehfl_step_survey.py, PERF.md).  Each step is
# held to 2e-4, about three times that, as PARAM_ATOL is to phase 5's 6.3e-4.
STEP_ATOL = 2e-4
BATCH_SEEDS = (0, 1, 2)

# Phase 12, LM training at qwen1.5-0.5b's published width (bf16).  12a: the
# round function of launch/train.py with repro.launch.train's
# defaults: 8 clients, k = 2, 4 steps of 4 x 64 tokens a round, 3 rounds, mu
# 0.001, lr 0.05.  12b: make_train_step with remat and the chunked CE at
# B x S = 4 x 2048 (C = 256: the 2047 predicted positions in 8 chunks, one
# column of padding), a warm-up step then STEP_RUNS timed.  12c: one
# mamba2-1.3b step at 1 x 2048 with remat.  The steps of 12b and 12c take
# the rounds' lr on one batch.
TRAIN_ARCH, SSM_TRAIN_ARCH = "qwen1.5-0.5b", "mamba2-1.3b"
TRAIN_ROUNDS = dict(clients=8, k=2, steps_per_round=4, batch=4, seq=64, rounds=3, mu=0.001, lr=0.05)
STEP_B, STEP_S, STEP_CHUNK, STEP_RUNS, SSM_STEP_B, SSM_STEP_S, SSM_STEP_RUNS = 4, 2048, 256, 5, 1, 2048, 2
# Phase 3 holds swa_attention at the shapes phase 12 gives it: the batched
# probe over N x batch = 32 sequences and a client's refresh over its 4
# (B, H, Hkv, S, D, causal)
TRAIN_SWA_SHAPES = {
    "qwen1.5-0.5b probe": (32, 16, 16, 64, 64, True),
    "qwen1.5-0.5b refresh": (4, 16, 16, 64, 64, True),
}
# Phase 12's checks.  One train step of a 2-layer fp32 cut at full width
# (two_layer_config) on the card against the same step on the CPU, TF32 off:
# loss within TRAIN_LOSS_RTOL relative, params within TRAIN_PARAM_ATOL (the
# two sum in other orders; lr times a gradient's rounding is far below it).
# The probe's features through swa_attention against the plain route: each
# of its attention calls within bf16_limit of the plain version on that
# call's inputs, and the feature rows within PROBE_FEATURE_RTOL of the
# largest row's norm, which the kernel without its causal mask must exceed.
# The chunked CE's loss against the full-logits loss on the same params and
# batch within CE_CHUNK_RTOL (the same bf16 logits summed in other orders).
TRAIN_LOSS_RTOL, TRAIN_PARAM_ATOL = 1e-5, 1e-6
PROBE_FEATURE_RTOL = 0.05
CE_CHUNK_RTOL = 1e-5

# Phase 13, EHFL with routed LM clients.  13a: deepseek-moe-16b at its
# published width (d 2048, 16 heads of 128, 64 routed experts of d_ff 1408
# plus 2 shared, top-6, vocab 102,400), bf16, random weights seed 0, cut to
# ROUTED_DEPTH of 28 layers: the simulator holds the global model, the N
# message rows (old and new side by side while they are written) and,
# while the slab trains, k lanes, k gradients and k updated lanes, plus the
# (P,) fp32 mean.  At 2 layers (1.60 B parameters, 3.2 GB a bf16 copy) an
# H100 measured a peak of 63.9 GB; 3 layers (2.18 B) would need about 87.  The
# dynamics of tests/test_torch_lm_backend.py at the reference driver's
# 64-token sequences: 4 clients x 16 sequences, k = 2, kappa = 4 steps of
# 4 sequences, probe 4, 3 epochs.  13b: llama4-scout-17b-a16e and
# jamba-v0.1-52b at reduced() through the same entry point, one epoch each
# (at published width one llama4 layer with its embedding and head is about
# 8.6 GB a bf16 copy, and the simulator's N + 3k copies do not fit).
ROUTED_ARCH, ROUTED_DEPTH = "deepseek-moe-16b", 2
ROUTED_SIM = dict(num_clients=4, k=2, kappa=4, probe_size=4, slots_per_epoch=8, p_bc=1.0, e_max=9, mu=0.01,
                  epochs=3, eval_every=3)
ROUTED_SEQS, ROUTED_SEQ_LEN = 16, 64
ROUTED_REDUCED = ("llama4-scout-17b-a16e", "jamba-v0.1-52b")
# Phase 3 holds swa_attention at 13a's probe: N x probe = 16 sequences
ROUTED_SWA_SHAPES = {"deepseek-moe-16b EHFL probe": (16, 16, 16, 64, 128, True)}
# 13a's checks.  The dispatch at published width, fp32, TF32 off: one MoE
# layer's params in two lanes, each lane a client's step batch (4 x 64
# tokens), under vmap(grad) against a per-lane loop and against the call
# as the prefill step makes it (inference mode, no vmap): top_idx and the
# kept mask exactly (tokens with two of their first k + 1 probabilities
# within NEAR_TIE are counted and left out, as in tests/test_torch_moe.py),
# y within DISPATCH_Y_RTOL of its largest element, the vmapped gradients
# within DISPATCH_GRAD_RTOL of the largest gradient element (an H100 read
# 2.5e-6 for both, and the prefill's call 0).  Then one fp32 epoch of a
# 2-layer cut at published width on the card against the same epoch on the
# CPU, from the same state and draws (ROUTED_CHECK_SIM: 2 clients and
# k = 1, as 4 clients' fp32 copies do not fit the card): selections, ages,
# battery, energy and the other integers exactly, the global params within
# ROUTED_PARAM_ATOL (an H100 read 1.2e-7: the two sum in other orders, and
# no routing flipped).  Where a routing flip makes the free run part beyond
# it, the local SGD is teacher-forced step by step instead, as in phase
# 9a: each CPU step from the card's weights within ROUTED_STEP_ATOL
# (STEP_ATOL, a quarter of a step's largest update, 7.9e-4) of the card's.
DISPATCH_Y_RTOL, DISPATCH_GRAD_RTOL, NEAR_TIE = 1e-5, 1e-4, 1e-6
ROUTED_CHECK_SIM = dict(ROUTED_SIM, num_clients=2, k=1, epochs=1, eval_every=1)
ROUTED_PARAM_ATOL, ROUTED_STEP_ATOL = 1e-6, STEP_ATOL
# Phase 14, the drivers beside the package: examples/quickstart_torch.py
# cut to QUICK_EPOCHS per policy and QUICK_GALLERY_EPOCHS per scenario seed
# (its defaults are 25 and 10), and one cell of
# benchmarks/ehfl_grid_torch.py's quick protocol (vaoi, alpha 0.1, p_bc
# 0.1, 2 seeds); the full grid is not run.
QUICK_EPOCHS, QUICK_GALLERY_EPOCHS = 10, 4
DRIVER_CELL = ("vaoi", 0.1, 0.1)
QUICK_KAPPA = 20  # the quickstart's and the grid's SGD steps an epoch
# Phase 15, the bench suite: the harness's suites at their quick protocols,
# and the fleet bench once more over BENCH_GLOO_RANKS gloo ranks on the card
BENCH_SUITES = ("kernels", "stream", "channel", "fleet")
BENCH_GLOO_RANKS, BENCH_GLOO_N = 4, 1024
# Phase 16, the launch layer.  16a: the dry-run of LAUNCH_ARCH x train_4k at
# full shape (256 x 4096) on the 16 x 16 production mesh over a fake group of
# 256 ranks, in a child process, and run_torch's roofline row for its record.
# 16b: phase 12b's step (LAUNCH_ARCH, bf16, seed 0, STEP_B x STEP_S, remat,
# the chunked CE) on one NCCL rank, on DTensors over the (1, 1) host mesh and
# on plain tensors, LAUNCH_RUNS timed steps each after a warm-up.  On one rank
# every DTensor op runs the plain op on the whole tensor, but the DTensor
# path takes its own forms at two places (models/spmd.py, models/common.py):
# the CE's logsumexp as max, sum and log, and the embedding's lookup by
# F.embedding (its backward adds the rows of repeated tokens in another
# order).  So the gradients part by rounding, and a bf16 weight's update is
# about one rounding step of the weight: where the exact update lies near a
# rounding boundary the two steps round it apart.  Two H100 runs read the
# loss bit for bit, 50 of 290 leaves bit for bit, and the largest gaps,
# 0.013-0.020 of a leaf's largest element, at the attention biases ``bk``
# and ``bv``: they start at zero, so after one step a bias is its update
# alone and a gradient's rounding is a share of the whole leaf (``bk``'s
# gradient is zero in exact arithmetic, as softmax ignores a shift shared
# by every key, so both steps move it by rounding noise alone).  The loss
# is held to LAUNCH_LOSS_RTOL relative and each new leaf to
# LAUNCH_LEAF_RTOL (four bf16 rounding steps) of its largest element.
LAUNCH_ARCH, LAUNCH_RUNS, LAUNCH_DRYRUN_TIMEOUT_S = "qwen1.5-0.5b", 3, 600
LAUNCH_LOSS_RTOL, LAUNCH_LEAF_RTOL = 1e-5, 2.0 ** -5


def log(msg: str) -> None:
    print(msg, flush=True)


def event_samples(fn, iters: int, warmup: int = 5) -> list:
    """CUDA-event times (ms) of ``iters`` back-to-back runs of ``fn``, after
    ``warmup``.  Where ``fn`` is host-bound they read its host time."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return [s.elapsed_time(e) for s, e in pairs]


def time_ms(fn, iters: int = 25, warmup: int = 5) -> float:
    """Median device time of ``fn`` over ``iters`` runs, after ``warmup``."""
    return statistics.median(event_samples(fn, iters, warmup))


def interleaved_ms(fns: dict, iters: int, rounds: int = 4) -> dict:
    """Median event time of each of ``fns`` over ``iters`` runs, taken in
    ``rounds`` turns through all of them, so that a drift of the shared
    host's speed falls on each alike."""
    samples = {name: [] for name in fns}
    for _ in range(rounds):
        for name, fn in fns.items():
            samples[name] += event_samples(fn, iters // rounds)
    return {name: statistics.median(x) for name, x in samples.items()}


def device_ms(fn, iters: int = 20, only: str | None = None) -> dict:
    """Device time per call of ``fn``: the CUDA kernels' durations under
    torch.profiler over ``iters`` calls after one warm-up, so the host time
    of a Python wrapper does not count; and the kernels captured per call.
    The profiler can miss a few launches, so each kernel name counts its
    mean duration times its launches per call (its captured count over
    ``iters``, rounded).  A session now and then delivers none of its
    kernel records: then up to four more are taken.  ``only``: count just
    the kernels whose name holds it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    durations = {}
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        for e in prof.events():
            if e.device_type == DeviceType.CUDA and (only is None or only in e.name):
                durations.setdefault(e.name, []).append(e.time_range.elapsed_us())
        if durations:
            break
    return {"ms": sum(statistics.mean(d) * max(1, round(len(d) / iters)) for d in durations.values()) / 1e3,
            "kernels_per_call": sum(len(d) for d in durations.values()) / iters}


def add_device_ms(row: dict, kernel, library) -> None:
    """Add to ``row`` the device time per call of the kernel's wrapper and of
    the library call, and how many kernels each launches."""
    dk, dl = device_ms(kernel), device_ms(library)
    row.update(device_ms=dk["ms"], kernels_per_call=dk["kernels_per_call"], library_device_ms=dl["ms"],
               library_kernels_per_call=dl["kernels_per_call"])


def cnn_conv_directions(kappa: int, policy: str) -> dict:
    """conv_lanes launches of one epoch of the CNN clients' local training,
    by direction: kappa vmapped SGD steps of six convolutions (6 forward,
    5 input-grad and 6 weight-grad launches: conv0's input needs no
    gradient) and, under a VAoI policy, each step's Eq. 6 feature forward
    (6 more forward launches)."""
    return {"launches_forward": kappa * (6 + 6 * policy.startswith("vaoi")), "launches_input_grad": kappa * 5,
            "launches_weight_grad": kappa * 6}


def cnn_conv_launches(kappa: int, policy: str) -> int:
    """All conv_lanes launches of one such epoch (17 a SGD step, 23 under VAoI)."""
    return sum(cnn_conv_directions(kappa, policy).values())


def conv_direction_counts() -> dict:
    """conv_lanes' launch counter of each direction (``ops.reset_launch_counts`` clears them)."""
    from repro_torch.kernels import conv_lanes as kc

    return {f"launches_{d}": getattr(kc.conv_lanes, f"launches_{d}") for d in kc.DIRECTIONS}


def bound(nbytes: float, flops: float, peak: float = FP32_FLOPS) -> tuple[float, str]:
    """The least time (ms) for this work: bytes over HBM bandwidth or
    operations over ``peak``, whichever is larger, and which one it is."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


# The EHFL kernels are microseconds long and their callers host-bound: their
# per-call event times (and their library calls') are medians over EHFL_ITERS.
EHFL_ITERS = 200
# vaoi_distance's wide route at the LM clients' shapes (phase 12's qwen1.5
# features, phase 13's deepseek-moe features) and the kernels bench's
VAOI_WIDE = ((8, 151_936), (4, 102_400), (1024, 4096))
# the vaoi sweep's shapes: (25, 10), (50, 10) and (256, 10) a fleet shard's
# rows at N=100 over 4 and 2 ranks, N=1024 over 4; then every plan on an
# H100's 132 SMs: the thread route's edge (F 32/33), odd F (rows off 16-byte
# alignment), the cluster route at S = 1 (1024, 4096), 2 (20, 16384), 4
# (8, 16384), 8 (8, 151,936) and 16 (1, 151,936), (4, 102,400)
VAOI_SWEEP = ((10, 10), (100, 10), (100, 16), (100, 32), (100, 33), (128, 512), (257, 300), (33, 1025),
              (100, 130), (10, 700), (5, 1025), (25, 10), (50, 10), (256, 10), (3, 40_001),
              (1, 151_936), (8, 151_936), (4, 102_400), (1024, 4096), (20, 16_384), (8, 16_384))
# (n, f, v's and h's offsets in elements into their storage): 16-byte
# vectors between a scalar head and tail where v and h sit alike, scalar
# loads where they do not
VAOI_OFFSETS = ((8, 151_936, 1, 1), (3, 40_001, 1, 0), (33, 1025, 3, 3), (20, 16_384, 0, 2))


def vaoi_mu_between(torch, v, h) -> float:
    """An Eq. 7 threshold that splits the rows of (v, h): inside the widest
    gap between neighbouring m = |v - h| in the middle half of the rows, so
    that rows take both branches and a kernel's m and the plain version's
    (which differ in the order of the sum) fall on the same side of it, and
    the ages can be compared exactly.  Half the one m of a single row."""
    m = torch.sort(torch.linalg.vector_norm(v.float() - h.float(), dim=-1).cpu()).values
    n = m.numel()
    if n == 1:
        return 0.5 * m[0].item()
    lo, hi = max(1, n // 4), max(2, -(-3 * n // 4))
    k = lo + int(torch.argmax(m[lo:hi] - m[lo - 1:hi - 1]))
    return 0.5 * (m[k - 1] + m[k]).item()
# the main path's FedAvg rows: the slab (5 of 10 upload) and the old-carrier
# stack (5 of 100 carry an old message)
SLAB_ROWS, OLD_ROWS, SLAB_UP, OLD_UP = 10, 100, 5, 5
# a fleet shard's clients in phase 10b: N=100 over FLEET_RANKS ranks
FLEET_RANKS = 4
FLEET_SHARD_ROWS = OLD_ROWS // FLEET_RANKS
# The leaf table against its plain version, fp32 and bf16 alike: both read
# bf16 exactly into fp32 and accumulate in fp32, so they part only by the
# order of the sum (one dropped row of 110 would miss by about 0.01).
LEAF_TOL = 1e-5


def cnn_leaf_table(torch, g, dev, rows=((SLAB_ROWS, SLAB_UP), (OLD_ROWS, OLD_UP))):
    """The main path's FedAvg table: the paper CNN's 18 leaves (sorted
    names), a slab group of SLAB_ROWS rows and an old-carrier group of
    OLD_ROWS, fp32, with SLAB_UP and OLD_UP nonzero weights; or the groups
    of ``rows`` ((row count, nonzero weights) each)."""
    from repro_torch.configs import CONFIG
    from repro_torch.models.cnn import init_params

    shapes = {k: v.shape for k, v in init_params(CONFIG, torch.Generator().manual_seed(0), torch.device("cpu")).items()}
    groups = []
    for k, up in rows:
        w = torch.zeros(k)
        w[torch.randperm(k, generator=g)[:up]] = 1.0
        groups.append(([torch.randn(k, *shapes[n], generator=g).to(dev) for n in sorted(shapes)], w.to(dev)))
    return groups


def flatten_route(torch, groups):
    """The library route the leaf-table launch replaces: each group's leaves
    concatenated (``torch.cat``), reduced by ``torch.mv``, the two added."""
    out = None
    for leaves, w in groups:
        part = torch.mv(torch.cat([t.reshape(t.shape[0], -1) for t in leaves], 1).T, w)
        out = part if out is None else out + part
    return out


def ragged_leaf_tables(torch, g, dev):
    """Leaf tables of the sweep, one and two groups (SLAB_ROWS + OLD_ROWS
    rows), fp32 and bf16: column counts that are and are not multiples of 4,
    a leaf whose base is not 16-byte aligned (a contiguous view one element
    into its storage), 32 leaves (one launch's most) and 70 (three launches,
    runs whose slices start off a 16-byte boundary).  Every fourth weight is
    0 and each group's weights sum to 1; in the two-group tables each leaf
    holds -Inf in a zero-weight slab row (column 0) and +Inf in a
    zero-weight old row (its last column), whose columns must come out NaN.
    Yields (groups, dtype, NaN columns expected)."""
    layouts = [(1, 3, 10, 37, 4096), (4096, 10, 1280, 32, 845), (5, 2049, 7, 1000, 9),
               tuple(int(c) for c in torch.randint(1, 3000, (32,), generator=g)),
               tuple(int(c) for c in torch.randint(1, 3000, (70,), generator=g))]
    for dtype in (torch.float32, torch.bfloat16):
        for cols in layouts:
            for n_groups in (1, 2):
                groups = []
                for k in (SLAB_ROWS, OLD_ROWS)[:n_groups]:
                    leaves = []
                    for j, c in enumerate(cols):
                        leaf = torch.randn(k, c, generator=g).to(dtype)
                        if n_groups == 2 and k == SLAB_ROWS:
                            leaf[4, 0] = -float("inf")
                        elif n_groups == 2:
                            leaf[0, c - 1] = float("inf")
                        if j == 1:  # a contiguous leaf whose base is one element off alignment
                            leaves.append(torch.empty(k * c + 1, dtype=dtype, device=dev)[1:].view(k, c).copy_(leaf))
                        else:
                            leaves.append(leaf.to(dev))
                    w = torch.rand(k, generator=g)
                    w[::4] = 0.0
                    groups.append((leaves, (w / w.sum()).to(dev)))
                nan_cols = sum(1 if c == 1 else 2 for c in cols) if n_groups == 2 else 0
                yield groups, dtype, nan_cols


def leaves_in_runs(torch, groups):
    """The leaf table through the wrapper's loop over runs of MAX_LEAVES
    leaves (the path of a table of more than MAX_LEAVES), here over a table
    that fits one run, beside the wrapper's one launch."""
    from repro_torch.kernels import build
    from repro_torch.kernels import fedavg_reduce as fr

    cols, ptrs, index = fr.check_leaves(groups)
    out = torch.empty(sum(cols), dtype=torch.float32, device=groups[0][1].device)
    return fr.reduce_in_runs(groups, cols, ptrs, build.launch_stream("fedavg_reduce", index), out)


def abba_ms(a, b, iters: int) -> dict:
    """Event times of ``a`` and ``b`` in turns A, B, B, A, ``iters`` runs
    each: each one's median over its two turns, the medians of the turns,
    and the spread (the larger gap between one's two turns)."""
    turns = {"a": [], "b": []}
    for name, fn in (("a", a), ("b", b), ("b", b), ("a", a)):
        turns[name].append(event_samples(fn, iters))
    med = {k: [statistics.median(x) for x in v] for k, v in turns.items()}
    out = {f"{k}_ms": statistics.median(v[0] + v[1]) for k, v in turns.items()}
    out.update(a_turns_ms=med["a"], b_turns_ms=med["b"],
               spread_ms=max(abs(med["a"][0] - med["a"][1]), abs(med["b"][0] - med["b"][1])))
    out["a_minus_b_ms"] = out["a_ms"] - out["b_ms"]
    return out


def host_ms(fns: dict, iters: int = 2000, rounds: int = 6) -> dict:
    """Host time (ms) per call of each of ``fns``: the host clock over
    ``iters`` back-to-back calls, in ``rounds`` turns through all of them,
    the median round.  For steps too short for a CUDA event pair, whose own
    cost (about 14 us) would drown them."""
    import torch

    samples = {name: [] for name in fns}
    for _ in range(rounds):
        for name, fn in fns.items():
            for _ in range(50):
                fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            samples[name].append((time.perf_counter() - t0) * 1e3 / iters)
            torch.cuda.synchronize()
    return {name: statistics.median(x) for name, x in samples.items()}


def vaoi_host_path(torch, v, h, age, q, dev) -> dict:
    """Where a vaoi_distance call's time goes, on the host clock
    (:func:`host_ms`): the whole call, its launch floor, each step of the
    wrapper's path on its own (the cached plan's lookup among them), and
    their sum; beside them the outputs as
    one (2, N) tensor split by ``unbind`` (the path's alternative), and the
    library route and its two calls."""
    from repro_torch.kernels import build
    from repro_torch.kernels import vaoi_distance as kv

    n, f = v.shape
    m, a = torch.empty_like(age), torch.empty_like(age)
    empty = kv._launcher("vaoi_empty_launch")
    stream = build.launch_stream("vaoi_distance", v.get_device())
    segments = kv.split_plan(n, f, v.element_size(), kv.sm_count(v.get_device()))
    params = kv._ARGS.pack(v.data_ptr(), h.data_ptr(), age.data_ptr(), q.data_ptr(), m.data_ptr(), a.data_ptr(),
                           stream, 0.5, n, f, False, segments)
    d = v - h
    steps = {
        "check_inputs": lambda: kv.check_inputs(v, h, age, q),
        "get_device_x4": lambda: (v.get_device(), h.get_device(), age.get_device(), q.get_device()),
        "launch_stream": lambda: build.launch_stream("vaoi_distance", 0),
        "outputs_empty_like_x2": lambda: (torch.empty_like(age), torch.empty_like(age)),
        "split_plan": lambda: kv.split_plan(n, f, v.element_size(), kv.sm_count(v.get_device())),
        "pack_params": lambda: kv._ARGS.pack(v.data_ptr(), h.data_ptr(), age.data_ptr(), q.data_ptr(),
                                             m.data_ptr(), a.data_ptr(), stream, 0.5, n, f, False, segments),
        "ctypes_empty_launch": lambda: empty(params),
    }
    timed = host_ms({
        "vaoi_distance": lambda: kv.vaoi_distance(v, h, age, q, 0.5),
        "launch_floor": lambda: kv.launch_floor(v, h, age, q, 0.5),
        **steps,
        "outputs_2n_unbind": lambda: torch.empty(2, n, dtype=torch.float32, device=v.device).unbind(),
        "library": lambda: torch.linalg.vector_norm(v - h, dim=1),
        "library_sub": lambda: v - h,
        "library_vector_norm": lambda: torch.linalg.vector_norm(d, dim=1),
    })
    return {**timed, "sum_of_steps": sum(timed[k] for k in steps)}


def vaoi_wide_rows(torch, ref, kern_vaoi, vaoi_floor, g, dev) -> list:
    """vaoi_distance's wide route at VAOI_WIDE (fp32): against its plain
    version (m within 1e-6 of the largest, ages equal, mu between the rows'
    m so both branches of Eq. 7 are taken), two calls bit for bit, then
    event times in turns beside its launch floor on the same plan and
    ``vector_norm(v - h)``, device times of all three, the byte bound, the
    plan and the row's seconds."""
    from repro_torch.kernels import vaoi_distance as kv

    rows = []
    for n, f in VAOI_WIDE:
        t0 = time.perf_counter()
        v = torch.softmax(torch.randn(n, f, generator=g), -1).to(dev)
        h = torch.softmax(torch.randn(n, f, generator=g), -1).to(dev)
        age = torch.randint(0, 7, (n,), generator=g).float().to(dev)
        q = (torch.rand(n, generator=g) < 0.25).float().to(dev)
        mu = vaoi_mu_between(torch, v, h)
        m_k, a_k = kern_vaoi(v, h, age, q, mu)
        m_2, a_2 = kern_vaoi(v, h, age, q, mu)
        m_r, a_r = ref.vaoi_distance_ref(v, h, age, q, mu)
        err = (m_k - m_r).abs().max().item()
        if err > 1e-6 * max(1.0, m_r.abs().max().item()) or not torch.equal(a_k, a_r):
            raise AssertionError(f"vaoi_distance ({n}, {f}) disagrees with its plain version: {err}")
        if not (torch.equal(m_k, m_2) and torch.equal(a_k, a_2)):
            raise AssertionError(f"vaoi_distance ({n}, {f}): two calls differ")
        b_ms, b_by = bound(2 * n * f * 4 + 4 * n * 4, 3 * n * f + 4 * n)
        kernel, floor = (lambda: kern_vaoi(v, h, age, q, mu)), (lambda: vaoi_floor(v, h, age, q, mu))
        library = lambda: torch.linalg.vector_norm(v - h, dim=-1)  # noqa: E731
        plan = kv.plan_of(v)
        row = {
            "kernel": "vaoi_distance", "shape": [n, f], "dtype": "float32",
            "design": f"{plan['route']} route, {plan['segments']} segment(s) a row", "plan": plan,
            "max_abs_err": err, "tol": "1e-6 of max(1, |m|), ages equal", "bitwise_repeat": True,
            **interleaved_ms({"ms": kernel, "launch_floor_ms": floor, "library_ms": library}, EHFL_ITERS),
            "plain_ms": time_ms(lambda: ref.vaoi_distance_ref(v, h, age, q, mu)),
            "bound_ms": b_ms, "bound_by": b_by, "launch_floor_device_ms": device_ms(floor, EHFL_ITERS)["ms"],
            "library": "linalg.vector_norm(v - h, dim=-1)",
        }
        add_device_ms(row, kernel, library)
        row.update(device_bound_share=b_ms / row["device_ms"], ms_over_library=row["ms"] / row["library_ms"],
                   mu=mu, rows_reaching_mu=int((m_r >= mu).sum().item()), seconds=time.perf_counter() - t0)
        log(json.dumps(row))
        rows.append(row)
        del v, h
    return rows


def phase_kernels(torch, ref, kern_vaoi, vaoi_floor, kern_fedavg, kern_leaves, dev):
    """Phase 3 (EHFL kernels).  Returns per-kernel main-path numbers for the
    final line: vaoi_distance beside its launch floor, and fedavg_reduce's
    leaf-table launch at the main path's layout (the single-matrix calls of
    the TPU kernel's signature are timed beside it)."""
    from repro_torch.kernels.vaoi_distance import plan_of as vaoi_plan_of

    t_start = time.perf_counter()
    g = torch.Generator().manual_seed(0)
    results = {}

    # --- vaoi_distance at the main path's (N, F) = (100, 10), beside the launch floor ---
    n, f = 100, 10
    v = torch.softmax(torch.randn(n, f, generator=g), -1).to(dev)
    h = torch.softmax(torch.randn(n, f, generator=g), -1).to(dev)
    age = torch.randint(0, 7, (n,), generator=g).float().to(dev)
    q = (torch.rand(n, generator=g) < 0.1).float().to(dev)
    m_k, a_k = kern_vaoi(v, h, age, q, 0.5)
    m_r, a_r = ref.vaoi_distance_ref(v, h, age, q, 0.5)
    err = max((m_k - m_r).abs().max().item(), (a_k - a_r).abs().max().item())
    if not err <= 1e-5:
        raise AssertionError(f"vaoi_distance (100, 10) disagrees with its plain version: {err}")
    b_ms, b_by = bound(2 * n * f * 4 + 4 * n * 4, 3 * n * f + 4 * n)
    kernel, floor = (lambda: kern_vaoi(v, h, age, q, 0.5)), (lambda: vaoi_floor(v, h, age, q, 0.5))
    library = lambda: torch.linalg.vector_norm(v - h, dim=1)  # noqa: E731
    timed = interleaved_ms({"ms": kernel, "launch_floor_ms": floor, "library_ms": library}, EHFL_ITERS)
    row = {
        "kernel": "vaoi_distance", "shape": [n, f], "dtype": "float32",
        "design": "thread route (F <= 32), one thread a row", "plan": vaoi_plan_of(v),
        "max_abs_err": err, "tol": 1e-5, **timed,
        "plain_ms": time_ms(lambda: ref.vaoi_distance_ref(v, h, age, q, 0.5)),
        "bound_ms": b_ms, "bound_by": b_by, "launch_floor_device_ms": device_ms(floor, EHFL_ITERS)["ms"],
    }
    add_device_ms(row, kernel, library)
    row.update(bound_with_launch_floor_ms=max(b_ms, row["launch_floor_device_ms"]),
               device_over_launch_floor=row["device_ms"] / row["launch_floor_device_ms"],
               host_clock_ms=vaoi_host_path(torch, v, h, age, q, dev))
    log(json.dumps(row))
    results["vaoi_distance"] = [row]

    # --- vaoi_distance at a fleet shard's (N_loc, F) = (25, 10): N=100 over 4 ranks (phase 10b) ---
    n = FLEET_SHARD_ROWS
    vs, hs, ages, qs = v[:n].contiguous(), h[:n].contiguous(), age[:n].contiguous(), q[:n].contiguous()
    m_k, a_k = kern_vaoi(vs, hs, ages, qs, 0.5)
    m_r, a_r = ref.vaoi_distance_ref(vs, hs, ages, qs, 0.5)
    err = max((m_k - m_r).abs().max().item(), (a_k - a_r).abs().max().item())
    if not err <= 1e-5:
        raise AssertionError(f"vaoi_distance ({n}, {f}) disagrees with its plain version: {err}")
    b_ms, b_by = bound(2 * n * f * 4 + 4 * n * 4, 3 * n * f + 4 * n)
    kernel, floor = (lambda: kern_vaoi(vs, hs, ages, qs, 0.5)), (lambda: vaoi_floor(vs, hs, ages, qs, 0.5))
    library = lambda: torch.linalg.vector_norm(vs - hs, dim=1)  # noqa: E731
    timed = interleaved_ms({"ms": kernel, "launch_floor_ms": floor, "library_ms": library}, EHFL_ITERS)
    shard = {
        "kernel": "vaoi_distance", "role": "fleet shard (phase 10b)", "shape": [n, f], "dtype": "float32",
        "plan": vaoi_plan_of(vs),
        "max_abs_err": err, "tol": 1e-5, **timed, "plain_ms": time_ms(lambda: ref.vaoi_distance_ref(vs, hs, ages, qs, 0.5)),
        "bound_ms": b_ms, "bound_by": b_by, "launch_floor_device_ms": device_ms(floor, EHFL_ITERS)["ms"],
    }
    add_device_ms(shard, kernel, library)
    shard.update(bound_with_launch_floor_ms=max(b_ms, shard["launch_floor_device_ms"]),
                 device_over_launch_floor=shard["device_ms"] / shard["launch_floor_device_ms"])
    log(json.dumps(shard))
    results["vaoi_distance_shard"] = shard
    results["vaoi_distance_wide"] = vaoi_wide_rows(torch, ref, kern_vaoi, vaoi_floor, g, dev)

    # --- fedavg_reduce in the TPU kernel's signature: the slab (10, P) and the old-carrier stack (100, P) ---
    p = 845_738
    single = []
    for k, role in ((SLAB_ROWS, "slab"), (OLD_ROWS, "old_carrier")):
        msgs = torch.randn(k, p, generator=g).to(dev)
        w = (torch.rand(k, generator=g) < (0.5 if role == "slab" else 0.05)).float().to(dev)
        err = (kern_fedavg(msgs, w) - ref.fedavg_reduce_ref(msgs, w)).abs().max().item()
        if not err <= 1e-5:
            raise AssertionError(f"fedavg_reduce ({k}, {p}) disagrees with its plain version: {err}")
        b_ms, b_by = bound(k * p * 4 + k * 4 + p * 4, 2 * k * p)
        kernel, library = (lambda: kern_fedavg(msgs, w)), (lambda: torch.mv(msgs.T, w))
        row = {
            "kernel": "fedavg_reduce", "role": f"single matrix, {role}", "shape": [k, p], "dtype": "float32",
            "max_abs_err": err, "tol": 1e-5, "ms": time_ms(kernel, EHFL_ITERS),
            "plain_ms": time_ms(lambda: ref.fedavg_reduce_ref(msgs, w)), "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": time_ms(library, EHFL_ITERS),
        }
        add_device_ms(row, kernel, library)
        log(json.dumps(row))
        single.append(row)
        del msgs

    # --- the main path's launch: the leaf table, slab + old-carrier stack in place ---
    groups = cnn_leaf_table(torch, g, dev)
    rows_total = SLAB_ROWS + OLD_ROWS
    p = sum(t[0].numel() for t in groups[0][0])
    got, want = kern_leaves(groups), ref.fedavg_reduce_leaves_ref(groups)
    err = (got - want).abs().max().item()
    lib_err = (flatten_route(torch, groups) - want).abs().max().item()
    if not (err <= 1e-5 and got.shape == (p,)):
        raise AssertionError(f"fedavg_reduce's leaf table disagrees with its plain version: {err}")
    b_ms, b_by = bound(rows_total * p * 4 + 4 * rows_total + 4 * p, 2 * rows_total * p)
    kernel, library = (lambda: kern_leaves(groups)), (lambda: flatten_route(torch, groups))
    plain = lambda: ref.fedavg_reduce_leaves_ref(groups)  # noqa: E731
    row = {
        "kernel": "fedavg_reduce", "role": "leaf table: slab + old-carrier stack, one launch (the main path)",
        "shape": [[SLAB_ROWS, OLD_ROWS], p], "leaves": len(groups[0][0]), "nonzero_weights": [SLAB_UP, OLD_UP],
        "dtype": "float32", "max_abs_err": err, "tol": 1e-5, "library_max_abs_err": lib_err,
        "ms": time_ms(kernel, EHFL_ITERS), "plain_ms": time_ms(plain), "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": time_ms(library, EHFL_ITERS),
        "library": "two torch.cat, two torch.mv, the add",
    }
    add_device_ms(row, kernel, library)
    row.update(plain_device_ms=device_ms(plain)["ms"], device_bound_share=b_ms / row["device_ms"],
               single_matrix=[{k: r[k] for k in ("role", "shape", "ms", "device_ms", "bound_ms", "library_ms",
                                                   "library_device_ms")} for r in single])
    # the wrapper's cost: the loop over runs of MAX_LEAVES leaves (a table
    # of 18 is one run) against the wrapper's one launch, its arguments
    # built from the whole table at once, in turns A, B, B, A.  Three H100
    # runs read the loop 0.0296, 0.0009 and 0.0352 ms over the one launch
    # (spreads 0.0190, 0.0057, 0.0209), so a table that fits one launch
    # takes it
    runs = lambda: leaves_in_runs(torch, groups)  # noqa: E731
    if not torch.equal(runs(), got):
        raise AssertionError("the leaf table through the run loop disagrees with the wrapper's")
    row["wrapper_turns"] = abba_ms(runs, kernel, EHFL_ITERS)
    log(json.dumps({"phase": "leaf_table_wrapper_turns", "a": "the loop over runs of 32 leaves",
                    "b": "the wrapper: one launch, arguments built at once", **row["wrapper_turns"]}))
    log(json.dumps(row))
    results["fedavg_reduce"] = [row]
    del groups, got, want

    # --- ragged fp32/bf16 sweeps (tests/test_kernels.py's shapes and tolerances) ---
    from repro_torch.kernels import vaoi_distance as kv

    def at_offset(x, off):  # a contiguous copy of x that starts `off` elements into its storage
        return torch.empty(x.numel() + off, dtype=x.dtype, device=dev)[off:].view(x.shape).copy_(x)

    # vaoi: mu between the rows' m, so both branches of Eq. 7 are taken and
    # the ages compared exactly
    n_checked, plans, vaoi_seconds = 0, set(), 0.0
    for dtype, tv, tf in ((torch.float32, 1e-5, 1e-5), (torch.bfloat16, 0.2, 0.05)):
        t0 = time.perf_counter()
        for n, f, v_off, h_off in [(n, f, 0, 0) for n, f in VAOI_SWEEP] + list(VAOI_OFFSETS):
            v = at_offset(torch.randn(n, f, generator=g).to(dtype), v_off)
            h = at_offset(torch.randn(n, f, generator=g).to(dtype), h_off)
            age = torch.randint(0, 9, (n,), generator=g).float().to(dev)
            q = (torch.rand(n, generator=g) < 0.4).float().to(dev)
            mu = vaoi_mu_between(torch, v, h)
            got, want = kern_vaoi(v, h, age, q, mu), ref.vaoi_distance_ref(v, h, age, q, mu)
            torch.testing.assert_close(got[0], want[0], rtol=tv, atol=tv)
            if not torch.equal(got[1], want[1]):
                raise AssertionError(f"vaoi_distance ({n}, {f}) {dtype}: ages differ from the plain version's")
            if f > kv.MAX_ROW_F and not all(torch.equal(a, b) for a, b in zip(got, kern_vaoi(v, h, age, q, mu))):
                raise AssertionError(f"vaoi_distance ({n}, {f}) {dtype}: two calls differ")
            plan = kv.plan_of(v)
            plans.add((plan["route"], plan["segments"]))
            n_checked += 1
        del v, h
        torch.cuda.synchronize()
        vaoi_seconds += time.perf_counter() - t0
        for k, p in ((1, 128), (10, 1000), (100, 4096), (7, 333), (64, 2048), (5, 77), (13, 100), (3, 2049), (65, 5)):
            msgs = torch.randn(k, p, generator=g).to(dtype).to(dev)
            w = torch.rand(k, generator=g)
            w = (w / w.sum()).to(dev)
            torch.testing.assert_close(kern_fedavg(msgs, w), ref.fedavg_reduce_ref(msgs, w), rtol=tf, atol=tf)
            n_checked += 1
    nan_columns = 0
    for groups, dtype, nan_cols in ragged_leaf_tables(torch, g, dev):
        got, want = kern_leaves(groups), ref.fedavg_reduce_leaves_ref(groups)
        nan = torch.isnan(want)
        if nan.sum().item() != nan_cols:
            raise AssertionError(f"the plain version has {nan.sum().item()} NaN columns, not {nan_cols}")
        if not torch.equal(torch.isnan(got), nan):
            raise AssertionError(f"leaf table {[t.shape[1] for t in groups[0][0]]} {dtype}: NaN columns differ")
        torch.testing.assert_close(got[~nan], want[~nan], rtol=LEAF_TOL, atol=LEAF_TOL)
        nan_columns += nan.sum().item()
        n_checked += 1
    # a fleet shard's table: its slab of min(k, N_loc) = 10 rows beside its
    # old-carrier stack of N_loc rows (25: N=100 over 4 ranks; 256: N=1024 over 4)
    for old_rows in (FLEET_SHARD_ROWS, 256):
        groups = cnn_leaf_table(torch, g, dev, rows=((SLAB_ROWS, SLAB_UP), (old_rows, 2)))
        torch.testing.assert_close(kern_leaves(groups), ref.fedavg_reduce_leaves_ref(groups), rtol=LEAF_TOL,
                                   atol=LEAF_TOL)
        n_checked += 1
        del groups
    torch.cuda.synchronize()
    want_plans = {("thread", 1)} | {("cluster", s) for s in kv.SEGMENTS}
    if kv.sm_count(torch.cuda.current_device()) == 132 and not want_plans <= plans:
        raise AssertionError(f"the vaoi sweep missed plans {sorted(want_plans - plans)}")
    log(json.dumps({"phase": "kernel_sweep", "cases": n_checked, "leaf_table_nan_columns": nan_columns,
                    "vaoi_plans": sorted(plans), "vaoi_seconds": vaoi_seconds,
                    "ehfl_kernels_seconds": time.perf_counter() - t_start, "ok": True}))
    return results

def ssd_inputs(torch, g, b, s, nh, hp, ds, dtype, dev, decay=1.0):
    """Inputs in ``ssd_forward``'s form: x, B and C are slices of one
    (b, s, nh*hp + 2*ds) silu output (strided views, as the model passes
    them), dt a softplus, A < 0 (``decay`` < 1 slows it, so state carries
    far across chunks)."""
    F = torch.nn.functional
    xbc = F.silu(torch.randn(b, s, nh * hp + 2 * ds, generator=g)).to(dtype).to(dev)
    x = xbc[..., : nh * hp].reshape(b, s, nh, hp)
    Bm, Cm = xbc[..., nh * hp : nh * hp + ds], xbc[..., nh * hp + ds :]
    dt = F.softplus(torch.randn(b, s, nh, generator=g)).to(dev)
    A = (-torch.exp(torch.randn(nh, generator=g) * 0.3) * decay).to(dev)
    return x, dt, A, Bm, Cm


def ssd_errors(got, want):
    """(max abs error, allowed) for y and for the final state (fp32 route)."""
    return [((a - b).abs().max().item(), SSD_RTOL * max(1.0, b.abs().max().item())) for a, b in zip(got, want)]


def ssd_limit_ratios(got, want, inputs):
    """Largest |got - want| / ssd_bf16_limit for y and for the final state
    (bf16 route)."""
    from repro_torch.kernels.ssd_scan import ssd_bf16_limit

    return [((a - b).abs() / lim).max().item() for a, b, lim in zip(got, want, ssd_bf16_limit(*inputs, *want))]


def ssd_no_decay_across_chunks(x, dt, A, Bm, Cm, chunk):
    """A wrong scan: the plain chunked form (``models.ssd.ssd_chunked``) with
    the state's decay across chunk edges dropped, S_c = S_{c-1} + (chunk c's
    update).  ssd_bf16_limit must catch it."""
    import torch

    from repro_torch.models.ssd import ssd_chunked

    state, ys = None, []
    for c0 in range(0, x.shape[1], chunk):
        part = [x[:, c0 : c0 + chunk], dt[:, c0 : c0 + chunk], A, Bm[:, c0 : c0 + chunk], Cm[:, c0 : c0 + chunk]]
        ys.append(ssd_chunked(*part, chunk, init_state=state)[0])
        update = ssd_chunked(*part, chunk)[1]
        state = update if state is None else state + update
    return torch.cat(ys, dim=1), state


def ssd_work(b, s, nh, hp, ds, L, elt):
    """Bytes and operations the chunked SSD needs: each input read once
    and each output written once; C.B^T once per (batch row, chunk) over
    the causal triangle, and per head the triangle times x*dt, C.S^T and
    the state update."""
    nbytes = b * s * (nh * hp + 2 * ds) * elt + b * s * nh * 4 + nh * 4 + b * s * nh * hp * 4 + b * nh * hp * ds * 4
    flops = 0
    for c0 in range(0, s, L):
        rows = min(L, s - c0)
        tri = rows * (rows + 1) // 2
        flops += b * 2 * tri * ds + b * nh * (2 * tri * hp + 4 * rows * ds * hp)
    return nbytes, flops


# conv_lanes at the paper CNN's six convolutions, (cin, cout, pixels a side),
# for each of CONV_LANES lanes of CONV_BATCH images: the SGD step of a
# 100-lane slab (fedavg's dense path, N = 1000's slab) and of a 10-lane one
# (the paper's k = 10: phase 4 and the n100.vaoi cell), whose weight
# gradients split over other cluster sizes
CONV_LANES_SHAPES = ((3, 32, 32), (32, 32, 32), (32, 64, 16), (64, 64, 16), (64, 128, 8), (128, 128, 8))
CONV_LANES, CONV_BATCH = (100, 10), 15


def conv_lanes_limit(want, terms: int) -> float:
    """The largest gap a direction may show from its plain version: 1e-5 of
    the largest output at 288 summed products, growing with the square root
    of the sum's length (the weight gradient sums 15,360 a lane at conv1).
    Both are strict fp32 sums in other orders.  Against a float64 reference
    on an H100 the kernel read at most 1.6e-6 of the largest output in every
    direction, cuDNN's grouped call up to 2.1e-5 (conv1's weight gradient),
    cuDNN in TF32 2e-4 to 9e-4."""
    return 1e-5 * want.abs().max().item() * math.sqrt(max(terms, 288) / 288)


def phase_conv_lanes(torch, ref, dev) -> dict:
    """Phase 3's conv_lanes rows, a pass for each lane count of CONV_LANES:
    each direction at each of the paper CNN's convolutions
    (CONV_LANES_SHAPES; conv0's input gradient is never asked for), against
    its plain version in strict fp32 within :func:`conv_lanes_limit`, then
    timed by CUDA events in turns with the plain version and the library
    call, ``F.conv2d`` with groups = lanes and its two gradients on NCHW
    copies (the grouped cuDNN convolution the port's vmapped lanes no longer
    call), beside the bound: operations over the fp32 peak or bytes over
    HBM, the larger.  Returns {lanes: rows}."""
    return {L: conv_lanes_pass(torch, ref, dev, L) for L in CONV_LANES}


def conv_lanes_pass(torch, ref, dev, L: int) -> list:
    """:func:`phase_conv_lanes`' rows at ``L`` lanes."""
    import torch.nn.functional as F
    from repro_torch.kernels import conv_lanes as kc

    B = CONV_BATCH
    rows = []
    for cin, cout, size in CONV_LANES_SHAPES:
        g = torch.Generator().manual_seed(0)
        x = torch.randn(L, B, size, size, cin, generator=g).to(dev).permute(0, 1, 4, 2, 3)
        w = (torch.randn(L, cout, cin, 3, 3, generator=g) / (3 * cin**0.5)).to(dev)
        b = torch.randn(L, cout, generator=g).to(dev)
        dy = torch.randn(L, B, size, size, cout, generator=g).to(dev).permute(0, 1, 4, 2, 3)
        xg = x.transpose(0, 1).reshape(B, L * cin, size, size)  # the library call's NCHW copies
        dyg = dy.transpose(0, 1).reshape(B, L * cout, size, size)
        wg = w.reshape(L * cout, cin, 3, 3)
        flops = 2 * L * B * size * size * cout * 9 * cin
        act_in, act_out, nw = x.numel(), dy.numel(), w.numel() + b.numel()
        directions = {
            "forward": (lambda: kc.forward(x, w, b), lambda: ref.conv_lanes_ref(x, w, b),
                        lambda: F.conv2d(xg, wg, b.reshape(-1), padding=1, groups=L),
                        4 * (act_in + nw + act_out), 9 * cin),
            "input_grad": (lambda: kc.input_grad(dy, w), lambda: ref.conv_lanes_input_grad_ref(dy, x, w),
                           lambda: torch.nn.grad.conv2d_input(xg.shape, wg, dyg, padding=1, groups=L),
                           4 * (act_out + nw + act_in), 9 * cout),
            "weight_grad": (lambda: kc.weight_grad(dy, x), lambda: ref.conv_lanes_weight_grad_ref(dy, x, w),
                            lambda: torch.nn.grad.conv2d_weight(xg, wg.shape, dyg, padding=1, groups=L),
                            4 * (act_out + act_in + nw), B * size * size),
        }
        for name, (kern, plain, library, nbytes, terms) in directions.items():
            if name == "input_grad" and (cin, cout, size) == CONV_LANES_SHAPES[0]:
                continue
            before = getattr(kc.conv_lanes, f"launches_{name}")
            got, want = kern(), plain()
            torch.cuda.synchronize()
            if getattr(kc.conv_lanes, f"launches_{name}") != before + 1:
                raise AssertionError(f"conv_lanes {name}: the launch was not counted")
            err, limit = 0.0, 0.0
            for k_out, p_out in zip(*((got, want) if isinstance(got, tuple) else ((got,), (want,)))):
                e, lim = (k_out - p_out).abs().max().item(), conv_lanes_limit(p_out, terms)
                if not e <= lim:  # each output (dw, db) within its own limit
                    raise AssertionError(f"conv_lanes {name} at {L} lanes, {(cin, cout, size)}: max gap {e} > {lim}")
                err, limit = max(err, e), max(limit, lim)
            del got, want
            t = interleaved_ms({"kernel": kern, "plain": plain, "library": library}, iters=20)
            bms, by = bound(nbytes, flops)
            rows.append({"shape": {"lanes": L, "batch": B, "cin": cin, "cout": cout, "pixels": size,
                                   "direction": name}, "plan": kc.plan(name, L, B, size, size, cin, cout,
                                                                       kc.sm_count(dev.index or 0)),
                         "max_abs_err": err, "limit": limit, "ms": t["kernel"], "plain_ms": t["plain"],
                         "library_ms": t["library"], "bound_ms": bms, "bound_by": by,
                         "bound_share": bms / t["kernel"], "tflops": flops / t["kernel"] / 1e9})
            log(json.dumps({"phase": "p3_conv_lanes", **rows[-1]}))
        del x, w, b, dy, xg, dyg, wg
        torch.cuda.empty_cache()
    total = {k: sum(r[k] for r in rows) for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
    log(json.dumps({"phase": "p3_conv_lanes_step", "lanes": L, "per_sgd_step_of": "the six layers' three directions",
                    **total, "bound_share": total["bound_ms"] / total["ms"]}))
    return rows


# mla_attention at the LM cell's shapes: 16 heads, q/k 192, v 128, S 2048;
# B 4 is a 2-lane x 2-sequence .grad / .feature call folded into the batch,
# B 16 the probe.  One cell epoch without eval launches it 5 layers x (4
# .grad + 4 .feature + 1 probe) times forward and 5 x 4 backward.
MLA_SHAPES, MLA_HEADS, MLA_DK, MLA_DV = ((4, 2048), (16, 2048)), 16, 192, 128
MLA_CELL = "deepseek-v2-lite-5l-ep8.n8.vaoi"
MLA_CELL_LAUNCHES = {"launches_forward": 45, "launches_backward": 20}
# the backward's needed products over the forward's: dV = P^T dO and dP = dO V^T
# over v's width, dK = dS^T Q and dQ = dS K over q/k's, against S = Q K^T and
# P V; the kernel's recomputation of S is its design's, not the function's
MLA_BACKWARD_FLOPS = (2 * MLA_DV + 2 * MLA_DK) / (MLA_DK + MLA_DV)


def mla_cell_epoch_launches(torch, dev, seed: int = 3300000001) -> dict:
    """mla_attention's launches by direction in one epoch of the LM cell
    after its settling epochs, through the benchmark's own set-up."""
    from repro_torch.kernels import mla_attention as kmla
    from repro_torch.kernels import ops

    root = Path(__file__).resolve().parent
    if str(root) not in sys.path:
        sys.path.insert(0, str(root))
    from ehfl_bench import run as bench_run
    from ehfl_bench import world

    w = bench_run.build(world.load_cell(MLA_CELL), seed, dev)
    t = bench_run.settle(w)
    if (t + 1) % w.cfg.eval_every == 0:
        raise AssertionError(f"epoch {t} of {MLA_CELL} evaluates; the count is of an epoch without eval")
    ops.reset_launch_counts()
    bench_run.run_epochs(w, t, lambda run: run == 1, [])
    torch.cuda.synchronize()
    counts = {d: getattr(kmla.mla_attention, d) for d in MLA_CELL_LAUNCHES}
    del w
    torch.cuda.empty_cache()
    return counts


def phase_mla_attention(torch, ref, dev) -> list:
    """Phase 3 (mla_attention): the kernel at MLA_SHAPES, forward and forward
    plus backward, each output held element by element to
    ``reference_and_limits`` (the plain bf16 path, scores rounded to bf16,
    must fail the forward's); timed on the event clock and by the kernels'
    own device time, beside its bound (the causal core's operations at the
    bf16 peak, MLA_BACKWARD_FLOPS times that backward), the plain version
    and SDPA (the yardstick only); then its launches in one epoch of the LM
    cell."""
    from repro_torch.kernels import mla_attention as kmla

    F = torch.nn.functional
    scale = MLA_DK**-0.5 * (0.1 * 0.707 * math.log(40) + 1) ** 2  # DeepSeek-V2-Lite's, YaRN's mscale included
    g = torch.Generator(device=dev).manual_seed(30)
    rows = []
    for b, s in MLA_SHAPES:
        def draw(*shape):
            return torch.randn(b, s, MLA_HEADS, *shape, generator=g, device=dev).to(torch.bfloat16)

        q, k, kv, do = draw(MLA_DK), draw(MLA_DK), draw(256), draw(MLA_DV)
        v = kv[..., 128:]  # as the model passes it: a strided view of the kv projection
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        o = kmla.mla_attention(*leaves, scale)
        o.backward(do.flatten(2))
        got = {"o": o.detach().unflatten(2, (MLA_HEADS, MLA_DV)), "dq": leaves[0].grad, "dk": leaves[1].grad,
               "dv": leaves[2].grad}
        want, lim = kmla.reference_and_limits(q, k, v, do, scale)
        ratios = {n: ((got[n].float() - want[n]).abs() / lim[n]).max().item() for n in want}
        gaps = {n: ((got[n].float() - want[n]).abs().max() / want[n].abs().max()).item() for n in want}
        plain = ref.mla_attention_ref(q, k, v, scale).unflatten(2, (MLA_HEADS, MLA_DV))
        plain_ratio = ((plain.float() - want["o"]).abs() / lim["o"]).max().item()
        del got, want, lim, plain, o
        if max(ratios.values()) > 1.0 or plain_ratio <= 1.0:
            raise AssertionError(f"mla_attention {(b, s)}: ratios to the limits {ratios} (each must be <= 1); the "
                                 f"plain bf16 path's {plain_ratio} must exceed 1")

        def fwd():
            return kmla.mla_attention(q, k, v, scale)

        def fwd_bwd(core=kmla.mla_attention):
            for t in leaves:
                t.grad = None
            core(*leaves, scale).backward(do.flatten(2))

        def lib_fwd(req=False):
            args = [t.detach().transpose(1, 2).requires_grad_(req) for t in (q, k, v)]
            return F.scaled_dot_product_attention(*args, is_causal=True, scale=scale), args

        def lib_fwd_bwd():
            out, _ = lib_fwd(True)
            out.backward(do.transpose(1, 2))

        flops = 2 * b * MLA_HEADS * (MLA_DK + MLA_DV) * s * (s + 1) // 2  # forward_flops' core term
        bound_fwd = flops / BF16_FLOPS * 1e3
        times = {"ms": time_ms(fwd, iters=20), "fwd_bwd_ms": time_ms(fwd_bwd, iters=10, warmup=2),
                 "plain_ms": time_ms(lambda: ref.mla_attention_ref(q, k, v, scale), iters=5, warmup=1),
                 "plain_fwd_bwd_ms": time_ms(lambda: fwd_bwd(ref.mla_attention_ref), iters=3, warmup=1)}
        try:  # the yardstick only: the port never calls SDPA
            times.update(library_ms=time_ms(lambda: lib_fwd()[0], iters=10, warmup=2),
                         library_fwd_bwd_ms=time_ms(lib_fwd_bwd, iters=10, warmup=2), library_failed=None)
        except (RuntimeError, TypeError) as e:
            times.update(library_ms=None, library_fwd_bwd_ms=None, library_failed=repr(e)[:300])
        row = {
            "kernel": "mla_attention", "shape": [b, s, MLA_HEADS, MLA_DK, MLA_DV], "dtype": "bfloat16, v strided",
            "max_ratio_to_limit": ratios, "max_gap_over_largest": gaps, "plain_bf16_o_ratio_to_limit": plain_ratio,
            "max_abs_err": max(gaps.values()), **times,
            "bound_ms": bound_fwd, "bound_fwd_bwd_ms": (1 + MLA_BACKWARD_FLOPS) * bound_fwd, "bound_by": "operations",
            "bound_peak": "bf16 tensor cores, 989 TFLOP/s", "gflop_forward": flops / 1e9,
            "library": "scaled_dot_product_attention(is_causal=True, scale=scale)",
        }
        row.update(bound_share=bound_fwd / row["ms"], fwd_bwd_bound_share=row["bound_fwd_bwd_ms"] / row["fwd_bwd_ms"])
        add_device_ms(row, fwd, lambda: lib_fwd()[0])
        # the three kernels' own time a forward plus backward: at B 4 the
        # event clock above also holds the autograd engine's host time
        row.update(fwd_bwd_device_ms=device_ms(fwd_bwd, iters=10, only="mla_")["ms"])
        row.update(fwd_bwd_device_bound_share=row["bound_fwd_bwd_ms"] / row["fwd_bwd_device_ms"])
        log(json.dumps({"phase": "p3_mla_attention", **row}))
        rows.append(row)
        del q, k, kv, v, do, leaves
        torch.cuda.empty_cache()

    counts = mla_cell_epoch_launches(torch, dev)
    log(json.dumps({"phase": "p3_mla_attention_cell_epoch", "cell": MLA_CELL, "launches": counts,
                    "expected": MLA_CELL_LAUNCHES}))
    if counts != MLA_CELL_LAUNCHES:
        raise AssertionError(f"mla_attention launches in one epoch of {MLA_CELL}: {counts} != {MLA_CELL_LAUNCHES}")
    return rows


def phase_ssd_kernel(torch, ref, kern_ssd, dev):
    """Phase 3 (ssd_scan): the prefill shape with bf16 strided inputs on the
    tensor-core route, each element within ssd_bf16_limit, beside a plain
    version without the state's decay across chunks (at decay 0.01) that
    must fail it; the same inputs in fp32 on the FMA route (SSD_RTOL);
    both routes timed; then a ragged sweep of both routes."""
    from repro_torch.kernels.ssd_scan import tc_blocks_per_sm

    g = torch.Generator().manual_seed(2)
    b, s, nh, hp, ds, L = PREFILL_B, PREFILL_P, 64, 64, 128, 256
    inputs = ssd_inputs(torch, g, b, s, nh, hp, ds, torch.bfloat16, dev)
    tc, fma = kern_ssd.launches_tc, kern_ssd.launches_fma
    got, want = kern_ssd(*inputs, chunk=L), ref.ssd_scan_ref(*inputs)
    ratios = ssd_limit_ratios(got, want, inputs)
    err = max((a - w).abs().max().item() for a, w in zip(got, want))
    del got, want
    # state carrying far: the kernel within the limit, the mutant beyond it
    slow = ssd_inputs(torch, g, b, s, nh, hp, ds, torch.bfloat16, dev, decay=0.01)
    want_slow = ref.ssd_scan_ref(*slow)
    slow_ratios = ssd_limit_ratios(kern_ssd(*slow, chunk=L), want_slow, slow)
    mutant_ratios = ssd_limit_ratios(ssd_no_decay_across_chunks(*slow, L), want_slow, slow)
    del slow, want_slow
    # the same inputs in fp32: the FMA route at SSD_RTOL
    in32 = [t.float() for t in inputs]
    errs32 = ssd_errors(kern_ssd(*in32, chunk=L), ref.ssd_scan_ref(*in32))
    routes = {"launches_tc": kern_ssd.launches_tc - tc, "launches_fma": kern_ssd.launches_fma - fma}
    fp32_ms = time_ms(lambda: kern_ssd(*in32, chunk=L), iters=10, warmup=2)
    del in32
    log(json.dumps({"phase": "ssd_bf16_limit", "shape": [b, s, nh, hp, ds, L], "kernel_max_ratio_y_state": ratios,
                    "kernel_max_ratio_y_state_decay_0.01": slow_ratios,
                    "mutant": "no decay across chunks, decay 0.01", "mutant_max_ratio_y_state": mutant_ratios,
                    "mutant_fails_limit": max(mutant_ratios) > 1.0, "fp32_err_y_state": errs32, "routes": routes}))
    if not (max(ratios) <= 1.0 and max(slow_ratios) <= 1.0 and all(e <= tol for e, tol in errs32)):
        raise AssertionError(f"ssd_scan at the prefill shape disagrees with its plain version: bf16 {ratios} and "
                             f"{slow_ratios} of ssd_bf16_limit, fp32 {errs32}")
    if not max(mutant_ratios) > 1.0:
        raise AssertionError(f"a scan without the decay across chunks passes ssd_bf16_limit ({mutant_ratios})")
    if routes != {"launches_tc": 2, "launches_fma": 1}:
        raise AssertionError(f"bf16 must run the tensor-core route and fp32 the FMA route: {routes}")
    blocks_per_sm = tc_blocks_per_sm(ds)
    if blocks_per_sm != 2:
        raise AssertionError(f"the bf16 route is sized for two blocks per SM; the card holds {blocks_per_sm}")
    nbytes, flops = ssd_work(b, s, nh, hp, ds, L, 2)
    b_ms, b_by = bound(nbytes, flops, BF16_FLOPS)
    ms = time_ms(lambda: kern_ssd(*inputs, chunk=L))
    row = {
        "kernel": "ssd_scan", "shape": [b, s, nh, hp, ds, L], "dtype": "bfloat16 x/B/C, strided",
        "route": "tensor cores (wgmma bf16, TMA two stages, 64-row tiles)", "tc_blocks_per_sm": blocks_per_sm,
        "max_abs_err": err, "max_ratio_to_ssd_bf16_limit": max(ratios),
        "mutant_max_ratio_to_ssd_bf16_limit": max(mutant_ratios),
        "max_abs_err_fp32": max(e for e, _ in errs32), "rtol_fp32": SSD_RTOL,
        "ms": ms, "bf16_bound_share": b_ms / ms,
        "plain_ms": time_ms(lambda: ref.ssd_scan_ref(*inputs), iters=3, warmup=1),
        "bound_ms": b_ms, "bound_by": b_by, "bound_peak": "bf16 tensor cores, 989 TFLOP/s",
        "fp32_route_ms": fp32_ms,
        "bound_fp32_route_ms": bound(ssd_work(b, s, nh, hp, ds, L, 4)[0], flops)[0],
        "gflop": flops / 1e9, "gbytes": nbytes / 1e9, "library_ms": None,
    }
    log(json.dumps(row))
    del inputs

    n_checked, worst = 0, {"float32": 0.0, "bfloat16_ratio_to_limit": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        for s, hp, ds, chunk, b, decay in itertools.product(
            (300, 64, 1), (32, 64), (16, 128), (64, 256), (1, 2), (1.0, 0.01)
        ):
            inputs = ssd_inputs(torch, g, b, s, 3, hp, ds, dtype, dev, decay)
            got, want = kern_ssd(*inputs, chunk=chunk), ref.ssd_scan_ref(*inputs)
            if dtype == torch.float32:
                errs = ssd_errors(got, want)
                ok = all(e <= tol for e, tol in errs)
                worst["float32"] = max(worst["float32"], *(e for e, _ in errs))
            else:
                errs = ssd_limit_ratios(got, want, inputs)
                ok = max(errs) <= 1.0
                worst["bfloat16_ratio_to_limit"] = max(worst["bfloat16_ratio_to_limit"], *errs)
            if not ok:
                raise AssertionError(f"ssd_scan {(b, s, 3, hp, ds, chunk, dtype, decay)} disagrees: {errs}")
            n_checked += 1
    torch.cuda.synchronize()
    log(json.dumps({"phase": "ssd_kernel_sweep", "cases": n_checked, "worst": worst, "ok": True}))
    return row


def compare_logits(torch, got, want):
    """max |got - want| over max |want|, and top-1 agreement, per (B, 1, V)."""
    a, b = got.float(), want.float()
    err = (a - b).abs().max().item()
    return {
        "max_abs_err": err, "rel_err": err / b.abs().max().item(),
        "top1_agree": (a.argmax(-1) == b.argmax(-1)).float().mean().item(),
        "min_cosine": torch.nn.functional.cosine_similarity(a[:, -1], b[:, -1], dim=-1).min().item(),
    }


def within(cmp, rtol, cos) -> bool:
    return cmp["rel_err"] <= rtol and cmp["min_cosine"] >= cos


def require_within(cmp, rtol, cos, what) -> None:
    if not within(cmp, rtol, cos):
        raise AssertionError(f"{what} disagree: {cmp}")


@dataclasses.dataclass(frozen=True)
class ServeSpec:
    """One serving path driven by ``phase_lm_serving``: ``arch`` at its
    published width, ``depth`` layers (0: the published depth), a prefill of
    ``prefill_b`` x ``prefill_p`` tokens (after ``prefix_tokens`` prefix
    embeddings a row; over encoder frames for an encoder-decoder) timed
    ``runs`` times, ``launches`` of each kernel per prefill, requests of
    ``req_p`` prompt tokens then ``req_g`` greedy ones, and the fp32 check
    on a copy of the weights (``fp32_layers`` 0) or on a fresh model of
    ``fp32_layers`` layers at full width.  ``mutants``: the kernels of the
    path whose wrong version (``MUTANTS``) must make the prefill fail
    LOGITS_LIMITS; the others' are run and printed.  Phase names start with
    ``prefix``."""

    arch: str
    prefix: str
    prefill_b: int
    prefill_p: int
    launches: dict
    plain_runs: int = 2
    runs: int = PREFILL_RUNS
    depth: int = 0
    prefix_tokens: int = 0
    req_p: int = REQ_P
    req_g: int = REQ_G
    fp32_layers: int = 0
    mutants: tuple = ()


# Phase 11: the rest of the zoo at published width, bf16, random weights.
# Two depth cuts, for memory on one 80 GB card: llama4-scout 12 of 48 layers
# (215.5 GB whole), jamba 16 of 32 (two super-blocks of 8, layer kinds and
# MoE placement unchanged; 102.9 GB whole).  Requests: 4 prompts of 32
# tokens (128 for the routed stacks, ZOO_MOE_REQ: PREFILL_DECODE_BF16 holds
# them at that length, and at 32 llama4-scout's top-1 routes part further,
# to 0.71 of the largest logit; the dense stacks read 0.019-0.022 at 32),
# then 8 greedy; the fp32 check on a 2-layer model at full width.
ZOO_REQ = dict(runs=3, plain_runs=1, req_p=32, req_g=8, fp32_layers=2)
ZOO_MOE_REQ = dict(ZOO_REQ, req_p=128)
ATTN = ("swa_attention",)
ZOO = (
    ServeSpec("qwen1.5-0.5b", "p11_qwen1.5-0.5b_", 4, 4096, {"swa_attention": 24}, mutants=ATTN, **ZOO_REQ),
    ServeSpec("codeqwen1.5-7b", "p11_codeqwen1.5-7b_", 1, 4096, {"swa_attention": 32}, mutants=ATTN, **ZOO_REQ),
    ServeSpec("command-r-35b", "p11_command-r-35b_", 1, 4096, {"swa_attention": 40}, mutants=ATTN, **ZOO_REQ),
    ServeSpec("deepseek-moe-16b", "p11_deepseek-moe-16b_", 1, 4096, {"swa_attention": 28}, mutants=ATTN,
              **ZOO_MOE_REQ),
    ServeSpec("llama4-scout-17b-a16e", "p11_llama4-scout-17b-a16e_", 1, 4096, {"swa_attention": 12}, depth=12,
              mutants=ATTN, **ZOO_MOE_REQ),
    ServeSpec("jamba-v0.1-52b", "p11_jamba-v0.1-52b_", 1, 4096, {"ssd_scan": 14, "swa_attention": 2}, depth=16,
              mutants=("ssd_scan",), **ZOO_MOE_REQ),
    ServeSpec("internvl2-2b", "p11_internvl2-2b_", 4, 1792, {"swa_attention": 24}, prefix_tokens=256,
              mutants=ATTN, **ZOO_REQ),
    ServeSpec("whisper-large-v3", "p11_whisper-large-v3_", 4, 448, {"swa_attention": 64}, mutants=ATTN, **ZOO_REQ),
)


def serve_config(spec: ServeSpec):
    """The spec's config: its depth cut, nothing else (a hybrid keeps its
    super-block of attn_period layers, so two blocks of 8 keep jamba's layer
    kinds and MoE placement)."""
    from repro_torch.configs import get_config

    cfg = get_config(spec.arch)
    return dataclasses.replace(cfg, num_layers=spec.depth) if spec.depth else cfg


def no_drop(cfg):
    """capacity_factor = E / k: capacity C = G, so a prefill drops nothing,
    as the decode step (one token a group) never does."""
    if not cfg.num_experts:
        return cfg
    return dataclasses.replace(cfg, capacity_factor=cfg.num_experts / cfg.experts_per_token)


def two_layer_config(torch, cfg):
    """The fp32 check's model: full width, 2 layers (a hybrid interleaved
    as reduced() does, SSM then attention with MoE; an encoder-decoder with
    2 encoder layers), capacity_factor E / k."""
    c = dataclasses.replace(no_drop(cfg), num_layers=2, dtype=torch.float32)
    if c.ssm_state and c.attn_period > 1:
        c = dataclasses.replace(c, attn_period=2, attn_offset=1, moe_period=min(c.moe_period, 2))
    if c.is_encoder_decoder:
        c = dataclasses.replace(c, num_encoder_layers=2)
    return c


def request_cache(torch, cfg, params, bsz, length, frames, dev, decoder):
    """A serve cache for ``bsz`` requests; an encoder-decoder's cross K/V
    planes filled from ``frames`` encoded on the kernel route."""
    cache = decoder.init_cache(cfg, bsz, length, device=dev, cross_cache=cfg.is_encoder_decoder)
    if cfg.is_encoder_decoder:
        with torch.inference_mode():
            enc = decoder.encode(cfg, params, frames, use_kernel=True)
            cache = decoder.prefill_cross_cache(cfg, params, cache, enc)
    return cache


def step_prompts(torch, cfg, params, prompts, dev, decoder, make_serve_step, frames=None, greedy=0):
    """Decode-based prefill as serve_demo runs it: (last logits, cache, s);
    the cache holds ``greedy`` more positions."""
    bsz, plen = prompts.shape
    step = make_serve_step(cfg)
    cache = request_cache(torch, cfg, params, bsz, plen + greedy, frames, dev, decoder)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(plen):
        logits, cache = step(params, cache, prompts[:, t : t + 1], torch.full((bsz,), t, device=dev))
    torch.cuda.synchronize()
    return logits, cache, time.perf_counter() - t0


def check_logits(torch, logits, shape, what):
    if tuple(logits.shape) != shape or not torch.isfinite(logits).all().item():
        raise AssertionError(f"{what}: logits of shape {tuple(logits.shape)} (want {shape}) or non-finite")


def moe_routings(run) -> list:
    """The routing (``models.moe.route``) of every MoE call one call of
    ``run`` makes, in call order (one call per MoE layer and step)."""
    from repro_torch.models import moe

    routings, inner = [], moe.apply_moe

    def recording(cfg, p, x):
        routings.append(moe.route(cfg, p, x))
        return inner(cfg, p, x)

    moe.apply_moe = recording
    try:
        run()
    finally:
        moe.apply_moe = inner
    return routings


def drop_shares(routings) -> dict:
    """Share of token-expert choices that found no slot, over all the
    layers' routings and per layer."""
    dropped = [(r.keep.numel() - int(r.keep.sum().item()), r.keep.numel()) for r in routings]
    shares = [d / n for d, n in dropped]
    return {"moe_layers": len(routings), "drop_share": sum(d for d, _ in dropped) / sum(n for _, n in dropped),
            "drop_share_min_layer": min(shares), "drop_share_max_layer": max(shares)}


def last_token_routes(torch, routings) -> list:
    """Each routing's experts for the last token, sorted: (B, k) each."""
    return [torch.sort(r.top_idx[:, -1, -1], dim=-1).values for r in routings]


@contextlib.contextmanager
def attention_without_causal_mask(ops):
    """A wrong kernel: swa_attention with its causal mask (and window) off."""
    inner = ops.swa_attention
    ops.swa_attention = lambda q, k, v, window=0, causal=True: inner(q, k, v, window=0, causal=False)
    try:
        yield
    finally:
        ops.swa_attention = inner


@contextlib.contextmanager
def scan_with_b_and_c_swapped(ops):
    """A wrong kernel: ssd_scan reading C where it reads B and B where it
    reads C (the state is written from C and read through B)."""
    inner = ops.ssd_scan
    ops.ssd_scan = lambda x, dt, A, Bm, Cm, chunk=128: inner(x, dt, A, Cm, Bm, chunk=chunk)
    try:
        yield
    finally:
        ops.ssd_scan = inner


# each mutant by the kernel whose place it takes
MUTANTS = {
    "swa_attention": ("swa_attention without its causal mask", attention_without_causal_mask),
    "ssd_scan": ("ssd_scan with B and C swapped", scan_with_b_and_c_swapped),
}


def phase_lm_serving(torch, dev, ops, smi, spec: ServeSpec):
    """Phases 6, 7 and 11: one arch served at full width on the card.
    (a) the prefill step through the kernels, timed, counted (exactly
    ``spec.launches`` per prefill, every launch on the tensor-core route)
    and profiled; (b) the plain route, logits compared (and, with
    ``spec.mutant``, a wrong kernel that must fail the same limit); (c)
    requests stepped through the serve step, then greedy tokens; (d)
    prefill against decode at req_p in bf16 (MoE at capacity_factor E / k)
    and in fp32; (e) peak memory.  Returns the launch counts of (a) and
    their split by route."""
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import decoder

    torch.cuda.empty_cache()
    cfg = serve_config(spec)
    prefix, vocab = spec.prefix, cfg.vocab_size
    bf16_rtol, bf16_cos, fp32_rtol = LOGITS_LIMITS[spec.arch]
    t0 = time.perf_counter()
    params = decoder.init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in flat_tensors(params))
    params_gb = sum(t.numel() * t.element_size() for t in flat_tensors(params)) / 1e9
    log(json.dumps({
        "phase": f"{prefix}serving_init", "arch": cfg.name, "layers": cfg.num_layers,
        "published_layers": serve_config(dataclasses.replace(spec, depth=0)).num_layers,
        "encoder_layers": cfg.num_encoder_layers, "d_model": cfg.d_model,
        "heads": cfg.num_heads, "kv_heads": cfg.num_kv_heads, "head_dim": cfg.head_dim, "d_ff": cfg.d_ff,
        "experts": cfg.num_experts, "top_k": cfg.experts_per_token, "shared_experts": cfg.num_shared_experts,
        "layer_kinds": "".join("a" if cfg.layer_kind(i) == "attn" else "s" for i in range(cfg.num_layers)),
        "moe_layers": [i for i in range(cfg.num_layers) if cfg.layer_moe(i)],
        "window": cfg.sliding_window, "vocab": vocab, "dtype": str(cfg.dtype), "params": n_params,
        "param_count_analytic": cfg.param_count(), "params_gb": params_gb, "init_s": time.perf_counter() - t0,
    }))
    g = torch.Generator(device=dev).manual_seed(1)

    def inputs(bsz, plen, prefix_tokens=0):
        batch = {"tokens": torch.randint(0, vocab, (bsz, plen), generator=g, device=dev)}
        if prefix_tokens:  # stand-ins for the stubbed vision frontend, at the embeddings' scale
            batch["prefix_embeddings"] = (
                torch.randn(bsz, prefix_tokens, cfg.d_model, generator=g, device=dev) * 0.02
            ).to(cfg.dtype)
        if cfg.is_encoder_decoder:  # stand-ins for the stubbed audio frontend
            batch["encoder_frames"] = torch.randn(bsz, cfg.encoder_seq, cfg.d_model, generator=g, device=dev).to(
                cfg.dtype
            )
        return batch

    batch = inputs(spec.prefill_b, spec.prefill_p, spec.prefix_tokens)
    shape = (spec.prefill_b, 1, vocab)

    # (a) the main path: the prefill step through the kernels
    prefill = make_prefill_step(cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prefill(params, batch)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    times = []
    for _ in range(spec.runs):
        t0 = time.perf_counter()
        logits = prefill(params, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    launches, routes = ops.launch_counts(), ops.route_launch_counts()
    peak_prefill = torch.cuda.max_memory_allocated() / 1e9
    want = {name: spec.launches.get(name, 0) * spec.runs for name in launches}
    if launches != want:
        raise AssertionError(f"{cfg.name} prefill launches {launches} != {want}: the main path missed a kernel")
    for name in spec.launches:
        if routes[name]["launches_tc"] != want[name]:
            raise AssertionError(f"{cfg.name} prefill {name} launches by route {routes[name]}: "
                                 f"all {want[name]} must be on the tensor cores")
    check_logits(torch, logits, shape, "prefill")
    median_ms = statistics.median(times)
    positions = spec.prefill_b * (spec.prefill_p + spec.prefix_tokens)
    row = {
        "phase": f"{prefix}serving_prefill", "batch": spec.prefill_b, "prompt_len": spec.prefill_p,
        "prefix_tokens": spec.prefix_tokens, "encoder_frames": cfg.encoder_seq if cfg.is_encoder_decoder else 0,
        "runs_ms": times, "median_ms": median_ms, "first_call_ms": first_ms,
        "prefill_tokens_per_s": spec.prefill_b * spec.prefill_p / (median_ms / 1e3),
        "prefill_positions_per_s": positions / (median_ms / 1e3),
        "launches": launches, "launches_per_prefill": {k: v / spec.runs for k, v in launches.items() if v},
        "route_launches": {k: routes[k] for k in spec.launches}, "power_limit": smi,
    }
    if cfg.is_encoder_decoder:
        row["encoder_frames_per_s"] = spec.prefill_b * cfg.encoder_seq / (median_ms / 1e3)
    log(json.dumps(row))
    log(json.dumps({"phase": f"{prefix}serving_prefill_profile",
                    **profile_run(torch, lambda: prefill(params, batch), dev, "lm.")}))
    if cfg.num_experts:
        log(json.dumps({"phase": f"{prefix}serving_moe_drops", "capacity_factor": cfg.capacity_factor,
                        **drop_shares(moe_routings(lambda: prefill(params, batch)))}))

    # (b) the same prefill through the plain route
    plain = make_prefill_step(cfg, use_kernel=False)
    plain(params, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    plain_times = []
    for _ in range(spec.plain_runs):
        t0 = time.perf_counter()
        logits_plain = plain(params, batch)
        torch.cuda.synchronize()
        plain_times.append((time.perf_counter() - t0) * 1e3)
    peak_plain = torch.cuda.max_memory_allocated() / 1e9
    check_logits(torch, logits_plain, shape, "plain prefill")
    cmp = compare_logits(torch, logits, logits_plain)
    log(json.dumps({"phase": f"{prefix}serving_prefill_plain", "median_ms": statistics.median(plain_times),
                    "runs_ms": plain_times, "rtol": bf16_rtol, "min_cosine_allowed": bf16_cos, **cmp}))
    require_within(cmp, bf16_rtol, bf16_cos, f"{cfg.name} prefill logits through the kernel and the plain route")
    for kernel in spec.launches if spec.mutants else ():
        name, mutant = MUTANTS[kernel]
        with mutant(ops):
            wrong = compare_logits(torch, prefill(params, batch), logits_plain)
        fails = not within(wrong, bf16_rtol, bf16_cos)
        log(json.dumps({"phase": f"{prefix}serving_prefill_mutant", "mutant": name,
                        "must_fail": kernel in spec.mutants, "fails_limit": fails, **wrong}))
        if kernel in spec.mutants and not fails:
            raise AssertionError(f"{cfg.name}: a wrong {kernel} passes LOGITS_LIMITS: {wrong}")
    del logits_plain, batch

    # (c) requests as serve_demo runs them, and (d) prefill against decode
    torch.cuda.reset_peak_memory_stats()
    req = inputs(REQ_B, spec.req_p)
    frames = req.get("encoder_frames")
    stepped = []  # the prompt steps, their MoE routings recorded for (d) (prompt_step_s includes that)
    decode_routings = moe_routings(lambda: stepped.append(step_prompts(
        torch, cfg, params, req["tokens"], dev, decoder, make_serve_step, frames, spec.req_g)))
    last, cache, prompt_s = stepped.pop()
    step = make_serve_step(cfg)
    tok = torch.argmax(last[:, -1], dim=-1)[:, None]
    generated = [tok]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(spec.req_p, spec.req_p + spec.req_g):
        logits, cache = step(params, cache, tok, torch.full((REQ_B,), t, device=dev))
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
        generated.append(tok)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    check_logits(torch, logits, (REQ_B, 1, vocab), "decode")
    pos = torch.full((REQ_B,), spec.req_p + spec.req_g, device=dev)
    log(json.dumps({"phase": f"{prefix}serving_decode_profile",
                    **profile_run(torch, lambda: step(params, cache, tok, pos), dev, "lm.")}))
    out = torch.cat(generated, dim=1)
    if out.shape != (REQ_B, spec.req_g + 1) or not bool(((out >= 0) & (out < vocab)).all()):
        raise AssertionError(f"greedy decode produced {tuple(out.shape)} tokens outside the vocab")
    kv = [c for c in cache if "k" in c]
    log(json.dumps({
        "phase": f"{prefix}serving_requests", "batch": REQ_B, "prompt_len": spec.req_p, "greedy_tokens": spec.req_g,
        "cache_width": kv[0]["k"].shape[1] if kv else None,
        "cross_planes": list(cache[0]["ck"].shape) if "ck" in cache[0] else None,
        "prompt_step_s": prompt_s, "prompt_tokens_per_s": REQ_B * spec.req_p / prompt_s,
        "decode_ms_per_step": decode_s / spec.req_g * 1e3, "decode_tokens_per_s": REQ_B * spec.req_g / decode_s,
        "peak_gpu_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "first_tokens": out[:, :8].tolist(),
        "power_limit": smi,
    }))
    del cache

    def prefill_vs_decode(c, p, decoded):
        name = str(c.dtype).replace("torch.", "")
        pre = make_prefill_step(c)(p, req)
        check_logits(torch, pre, (REQ_B, 1, vocab), f"{name} prefill at P={spec.req_p}")
        tol, cos = (fp32_rtol, 0.0) if c.dtype == torch.float32 else PREFILL_DECODE_BF16.get(
            spec.arch, (bf16_rtol, bf16_cos))
        row = {"phase": f"{prefix}serving_prefill_vs_decode", "dtype": name, "layers": c.num_layers,
               "prompt_len": spec.req_p, "capacity_factor": c.capacity_factor if c.num_experts else None,
               "rtol": tol, "min_cosine_allowed": cos, **compare_logits(torch, pre, decoded)}
        log(json.dumps(row))
        require_within(row, tol, cos, f"{cfg.name} {name}: prefill logits and the serve step's")

    # bf16 at the run's depth; the decode step never drops, so its logits
    # from (c) stand for capacity_factor E / k too
    prefill_vs_decode(no_drop(cfg), params, last)
    if cfg.num_experts:  # routing is discontinuous: where do the two routes part?
        pre = last_token_routes(torch, moe_routings(lambda: make_prefill_step(no_drop(cfg))(params, req)))
        dec = last_token_routes(torch, decode_routings)[-len(pre):]
        flips = [int((a != b).any(dim=-1).sum().item()) for a, b in zip(pre, dec)]
        log(json.dumps({"phase": f"{prefix}serving_prefill_vs_decode_routes", "dtype": "bfloat16",
                        "moe_layers": len(pre), "rows": REQ_B, "last_token_routes_differing_by_layer": flips,
                        "share": sum(flips) / (len(pre) * REQ_B)}))
    # (e) peak memory
    log(json.dumps({"phase": f"{prefix}serving_memory", "peak_prefill_gb": peak_prefill,
                    "peak_plain_prefill_gb": peak_plain, "params_gb": params_gb, "power_limit": smi}))
    if spec.fp32_layers:  # a fresh fp32 model at full width and fp32_layers layers
        del params, last
        torch.cuda.empty_cache()
        c32 = two_layer_config(torch, cfg)
        p32 = decoder.init_params(c32, seed=0, device=dev)
    else:  # the same weights in fp32
        c32, p32 = dataclasses.replace(cfg, dtype=torch.float32), map_tensors(params, lambda t: t.float())
        del params, last
    last32, _, _ = step_prompts(torch, c32, p32, req["tokens"], dev, decoder, make_serve_step,
                                None if frames is None else frames.float())
    if c32.is_encoder_decoder:
        req["encoder_frames"] = frames.float()
    prefill_vs_decode(c32, p32, last32)
    del p32, req
    torch.cuda.empty_cache()
    return launches, {k: routes[k] for k in spec.launches}


def swa_work(b, h, hkv, s, d, window, causal, elt):
    """Bytes and fp32 operations attention needs: q and o once, k and v
    once at their Hkv heads; 4·D operations (QKᵀ and PV) for every live
    (query, key) pair of this mask."""
    pairs = sum(
        (i if causal else s - 1) - (max(0, i - window + 1) if window > 0 else 0) + 1 for i in range(s)
    )
    return 2 * b * s * d * (h + hkv) * elt, b * h * pairs * 4 * d


def swa_inputs(torch, g, b, h, hkv, s, d, dtype, dev):
    """q (b, h, s, d) and k, v (b, hkv, s, d) as (B, H, S, D) views of
    (B, S, H, D) tensors, the layout ``attn_forward`` passes."""
    return tuple(
        torch.randn(b, s, n, d, generator=g).to(dtype).to(dev).transpose(1, 2) for n in (h, hkv, hkv)
    )


def library_attention_ms(torch, q, k, v, window, causal=True):
    """One PyTorch call computing the same function: SDPA with GQA and an
    (S, S) boolean band mask for a window, ``is_causal`` for full causal
    attention, no mask when not causal.  If it cannot run at this S, halve S
    until it can; returns (ms, S it ran at, why it could not run at the
    full S)."""
    F = torch.nn.functional
    s, why = q.shape[2], None
    while s >= 64:
        try:
            args = [t[:, :, :s] for t in (q, k, v)]
            kw = {"is_causal": causal}
            if causal and window > 0:
                i = torch.arange(s, device=q.device)
                kw = {"attn_mask": (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - window)}
            return time_ms(lambda: F.scaled_dot_product_attention(*args, enable_gqa=True, **kw),
                           iters=10, warmup=2), s, why
        except (RuntimeError, TypeError) as e:  # the yardstick only; the port never calls SDPA
            why = why or repr(e)[:300]
            s //= 2
    return None, None, why


def swa_error(got, want, q, k, v, window, causal):
    """(max |got - want|, in bf16 the largest ratio of |got - want| to
    bf16_limit (None in fp32), whether both are within their limits)."""
    from repro_torch.kernels.swa_attention import bf16_limit

    name = str(want.dtype).replace("torch.", "")
    diff = (got.float() - want.float()).abs()
    err, ratio = diff.max().item(), None
    ok = got.dtype == want.dtype and err <= SWA_TOL[name]
    if name == "bfloat16":
        ratio = (diff / bf16_limit(q, k, v, window=window, causal=causal, want=want)).max().item()
        ok = ok and ratio <= 1.0
    return err, ratio, ok


def phase_swa_kernel(torch, ref, kern_swa, dev):
    """Phase 3 (swa_attention): StarCoder2-3B's prefill shape in bf16 (the
    tensor-core route, held to bf16_limit, beside a plain version one key
    tile short of the window that must fail it) and on the same inputs in
    fp32 (the FMA route), timed; then a ragged sweep (S around the 64- and
    128-row tiles, GQA groups 1 to 12, windows below a tile, at it, past it
    and past S, causal or not, fp32 and bf16)."""
    g = torch.Generator().manual_seed(3)
    b, h, hkv, s, d, w = SC_PREFILL_B, 24, 2, SC_PREFILL_P, 128, 4096
    q, k, v = swa_inputs(torch, g, b, h, hkv, s, d, torch.bfloat16, dev)
    tc, fma = kern_swa.launches_tc, kern_swa.launches_fma
    got = kern_swa(q, k, v, window=w)
    want = ref.swa_attention_ref(q, k, v, window=w)
    err, ratio, ok = swa_error(got, want, q, k, v, w, True)
    # a kernel that dropped one tile of the window: the same limit must catch it
    mutant = ref.swa_attention_ref(q, k, v, window=w - SWA_MUTANT_SHORT)
    _, mutant_ratio, mutant_ok = swa_error(mutant, want, q, k, v, w, True)
    del got, want, mutant
    # the same inputs in fp32, still strided: the FMA route, its long key
    # loop and the 4096-wide mask held at 2e-5
    q32, k32, v32 = (t.float() for t in (q, k, v))
    err32, _, ok32 = swa_error(kern_swa(q32, k32, v32, window=w), ref.swa_attention_ref(q32, k32, v32, window=w),
                               q32, k32, v32, w, True)
    routes = {"launches_tc": kern_swa.launches_tc - tc, "launches_fma": kern_swa.launches_fma - fma}
    fp32_ms = time_ms(lambda: kern_swa(q32, k32, v32, window=w), iters=10, warmup=2)
    del q32, k32, v32
    log(json.dumps({"phase": "swa_bf16_limit", "shape": [b, h, hkv, s, d, w], "kernel_max_ratio": ratio,
                    "mutant_window": w - SWA_MUTANT_SHORT, "mutant_max_ratio": mutant_ratio,
                    "mutant_fails_limit": not mutant_ok, "routes": routes}))
    if not (ok and ok32):
        raise AssertionError(f"swa_attention at the prefill shape disagrees with its plain version: "
                             f"bf16 {err} ({ratio} of bf16_limit), fp32 {err32}")
    if mutant_ok:
        raise AssertionError(f"a window {SWA_MUTANT_SHORT} keys short passes bf16_limit ({mutant_ratio}): "
                             "the limit does not discriminate")
    if routes != {"launches_tc": 1, "launches_fma": 1}:
        raise AssertionError(f"bf16 must run the tensor-core route and fp32 the FMA route: {routes}")
    nbytes, flops = swa_work(b, h, hkv, s, d, w, True, 2)
    b_ms, b_by = bound(nbytes, flops, BF16_FLOPS)
    lib_ms, lib_s, lib_why = library_attention_ms(torch, q, k, v, w)
    ms = time_ms(lambda: kern_swa(q, k, v, window=w), iters=10, warmup=2)
    row = {
        "kernel": "swa_attention", "shape": [b, h, hkv, s, d, w], "dtype": "bfloat16, strided (B, S, H, D) views",
        "route": "tensor cores (wgmma bf16, TMA ring)",
        "max_abs_err": err, "tol": SWA_TOL["bfloat16"], "max_ratio_to_bf16_limit": ratio,
        "mutant_max_ratio_to_bf16_limit": mutant_ratio,
        "max_abs_err_fp32": err32, "tol_fp32": SWA_TOL["float32"],
        "ms": ms, "bf16_bound_share": b_ms / ms,
        "plain_ms": time_ms(lambda: ref.swa_attention_ref(q, k, v, window=w), iters=3, warmup=1),
        "bound_ms": b_ms, "bound_by": b_by, "bound_peak": "bf16 tensor cores, 989 TFLOP/s",
        "fp32_route_ms": fp32_ms,
        "bound_fp32_route_ms": bound(swa_work(b, h, hkv, s, d, w, True, 4)[0], flops)[0],
        "gflop": flops / 1e9, "gbytes": nbytes / 1e9,
        "library_ms": lib_ms, "library": "scaled_dot_product_attention(attn_mask=band, enable_gqa=True)",
        "library_seq": lib_s, "library_failed_at_full_seq": lib_why,
    }
    log(json.dumps(row))
    del q, k, v

    n_checked = 0
    worst = {"float32": 0.0, "bfloat16": 0.0, "bfloat16_ratio_to_limit": 0.0}
    shapes = ((1, 2, 2, 128, 64), (2, 4, 2, 200, 64), (1, 6, 2, 37, 32), (1, 3, 1, 1, 128), (2, 8, 2, 300, 128),
              (1, 4, 4, 65, 32), (1, 12, 1, 127, 128), (1, 24, 2, 129, 64), (2, 12, 1, 257, 128), (1, 2, 2, 255, 32))
    for (b, h, hkv, s, d), w, causal, dtype in itertools.product(
        shapes, (0, 5, 64, 100, 127, 128, 129, 1000), (True, False), (torch.float32, torch.bfloat16)
    ):
        name = str(dtype).replace("torch.", "")
        q, k, v = swa_inputs(torch, g, b, h, hkv, s, d, dtype, dev)
        e, r, ok = swa_error(kern_swa(q, k, v, window=w, causal=causal),
                             ref.swa_attention_ref(q, k, v, window=w, causal=causal), q, k, v, w, causal)
        if not ok:
            raise AssertionError(f"swa_attention {(b, h, hkv, s, d, w, causal, name)} disagrees: {e} ({r})")
        worst[name] = max(worst[name], e)
        if r is not None:
            worst["bfloat16_ratio_to_limit"] = max(worst["bfloat16_ratio_to_limit"], r)
        n_checked += 1
    torch.cuda.synchronize()
    log(json.dumps({"phase": "swa_kernel_sweep", "cases": n_checked, "max_abs_err": worst, "tol": SWA_TOL,
                    "ok": True}))
    return row


def swa_shape_rows(torch, ref, kern_swa, dev, g, shapes: dict) -> list:
    """swa_attention at each of ``shapes`` ({label: (B, H, Hkv, S, D,
    causal)}), bf16 on the tensor-core route, each element within bf16_limit
    of the plain version on the same inputs; kernel, plain version and SDPA
    timed, bounds from this run's shapes."""
    rows = []
    for arch, (b, h, hkv, s, d, causal) in shapes.items():
        q, k, v = swa_inputs(torch, g, b, h, hkv, s, d, torch.bfloat16, dev)
        tc = kern_swa.launches_tc
        got = kern_swa(q, k, v, causal=causal)
        if kern_swa.launches_tc != tc + 1:
            raise AssertionError(f"swa_attention at {arch}'s shape did not take the tensor-core route")
        want = ref.swa_attention_ref(q, k, v, causal=causal)
        err, ratio, ok = swa_error(got, want, q, k, v, 0, causal)
        del got, want
        if not ok:
            raise AssertionError(f"swa_attention at {arch}'s shape {(b, h, hkv, s, d, causal)} disagrees with its "
                                 f"plain version: {err} ({ratio} of bf16_limit)")
        nbytes, flops = swa_work(b, h, hkv, s, d, 0, causal, 2)
        b_ms, b_by = bound(nbytes, flops, BF16_FLOPS)
        ms = time_ms(lambda: kern_swa(q, k, v, causal=causal), iters=10, warmup=2)
        lib_ms, lib_s, lib_why = library_attention_ms(torch, q, k, v, 0, causal)
        row = {
            "kernel": "swa_attention", "arch": arch, "shape": [b, h, hkv, s, d, 0], "causal": causal,
            "group": h // hkv, "dtype": "bfloat16, strided (B, S, H, D) views", "route": "tensor cores",
            "max_abs_err": err, "max_ratio_to_bf16_limit": ratio, "ms": ms, "bf16_bound_share": b_ms / ms,
            "plain_ms": time_ms(lambda: ref.swa_attention_ref(q, k, v, causal=causal), iters=3, warmup=1),
            "bound_ms": b_ms, "bound_by": b_by, "gflop": flops / 1e9, "gbytes": nbytes / 1e9,
            "library_ms": lib_ms, "library": "scaled_dot_product_attention(is_causal, enable_gqa=True)",
            "library_seq": lib_s, "library_failed_at_full_seq": lib_why,
        }
        log(json.dumps({"phase": "zoo_kernel_shape", **row}))
        rows.append(row)
        del q, k, v
    return rows


def phase_zoo_kernels(torch, ref, kern_swa, kern_ssd, dev):
    """Phase 3 (phase 11's and phase 12's shapes): swa_attention at every
    attention shape the zoo's prefills and the training probe give it
    (``swa_shape_rows``), and ssd_scan at jamba's, bf16 on the tensor-core
    route, each element within ssd_bf16_limit of the plain version on the
    same inputs, timed beside it, its bound from this run's shape."""
    g = torch.Generator().manual_seed(5)
    rows = {"swa_attention": swa_shape_rows(torch, ref, kern_swa, dev, g,
                                            {**ZOO_SWA_SHAPES, **TRAIN_SWA_SHAPES, **ROUTED_SWA_SHAPES}),
            "ssd_scan": []}
    b, s, nh, hp, ds, L = ZOO_SSD_SHAPE
    inputs = ssd_inputs(torch, g, b, s, nh, hp, ds, torch.bfloat16, dev)
    tc = kern_ssd.launches_tc
    got, want = kern_ssd(*inputs, chunk=L), ref.ssd_scan_ref(*inputs)
    ratios = ssd_limit_ratios(got, want, inputs)
    err = max((a - w).abs().max().item() for a, w in zip(got, want))
    del got, want
    if kern_ssd.launches_tc != tc + 1 or max(ratios) > 1.0:
        raise AssertionError(f"ssd_scan at jamba's shape disagrees with its plain version ({ratios} of "
                             f"ssd_bf16_limit) or missed the tensor-core route")
    nbytes, flops = ssd_work(b, s, nh, hp, ds, L, 2)
    b_ms, b_by = bound(nbytes, flops, BF16_FLOPS)
    ms = time_ms(lambda: kern_ssd(*inputs, chunk=L))
    row = {
        "kernel": "ssd_scan", "arch": "jamba-v0.1-52b", "shape": [b, s, nh, hp, ds, L],
        "dtype": "bfloat16 x/B/C, strided", "route": "tensor cores", "max_abs_err": err,
        "max_ratio_to_ssd_bf16_limit_y_state": ratios, "ms": ms, "bf16_bound_share": b_ms / ms,
        "plain_ms": time_ms(lambda: ref.ssd_scan_ref(*inputs), iters=3, warmup=1),
        "bound_ms": b_ms, "bound_by": b_by, "gflop": flops / 1e9, "gbytes": nbytes / 1e9, "library_ms": None,
    }
    log(json.dumps({"phase": "zoo_kernel_shape", **row}))
    rows["ssd_scan"].append(row)
    return rows


def phase_rolling_wrap(torch, dev):
    """Phase 7 (f): starcoder2-3b's rolling KV cache past its wrap, at full
    width: 2 layers, window 256, fp32, every 50th of 600 steps' logits held
    against a kernel-route prefill of the same prefix."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import decoder

    cfg = get_config("starcoder2-3b")
    fp32_rtol = LOGITS_LIMITS["starcoder2-3b"][2]
    wcfg = dataclasses.replace(cfg, num_layers=WRAP_LAYERS, sliding_window=WRAP_WINDOW, dtype=torch.float32)
    wparams = decoder.init_params(wcfg, seed=0, device=dev)
    g = torch.Generator(device=dev).manual_seed(4)
    tokens = torch.randint(0, cfg.vocab_size, (WRAP_B, WRAP_STEPS), generator=g, device=dev)
    step, pre = make_serve_step(wcfg), make_prefill_step(wcfg)
    cache = decoder.init_cache(wcfg, WRAP_B, WRAP_STEPS, device=dev)
    rows = []
    for t in range(WRAP_STEPS):
        logits, cache = step(wparams, cache, tokens[:, t : t + 1], torch.full((WRAP_B,), t, device=dev))
        if (t + 1) % WRAP_EVERY == 0:
            rows.append({"t": t, **compare_logits(torch, pre(wparams, {"tokens": tokens[:, : t + 1]}), logits)})
    worst = max(r["rel_err"] for r in rows)
    log(json.dumps({
        "phase": "sc_rolling_wrap", "layers": WRAP_LAYERS, "window": WRAP_WINDOW,
        "cache_width": cache[0]["k"].shape[1], "steps": WRAP_STEPS, "checked_steps": [r["t"] for r in rows],
        "max_rel_err": worst, "min_cosine": min(r["min_cosine"] for r in rows), "rtol": fp32_rtol,
    }))
    if not (cache[0]["k"].shape[1] == WRAP_WINDOW and worst <= fp32_rtol):
        raise AssertionError(f"the rolling cache past its wrap disagrees with the prefill: {rows}")
    del wparams, cache
    torch.cuda.empty_cache()

def flat_tensors(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in flat_tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in flat_tensors(v)]
    return [tree]


def map_tensors(tree, fn):
    if isinstance(tree, dict):
        return {k: map_tensors(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tensors(v, fn) for v in tree)
    return fn(tree)


def to_device(tree, device):
    """An EpochCarry, a dict of tensors or a scenario state copied to
    ``device`` (None and Python numbers, the diurnal clock, as they are)."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, tuple):
        items = [to_device(v, device) for v in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)
    return tree.to(device) if hasattr(tree, "to") else tree


def same_state(torch, a, b) -> bool:
    """Two carries' or scenario states' leaves equal exactly (any device)."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same_state(torch, a[k], b[k]) for k in a)
    if isinstance(a, tuple):
        return len(a) == len(b) and all(same_state(torch, x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return torch.equal(a.cpu(), b.cpu())
    return a == b


def max_abs(a, b) -> float:
    if isinstance(a, dict):
        return max(max_abs(a[k], b[k]) for k in a)
    return (a.cpu().double() - b.cpu().double()).abs().max().item()


def view_mismatches(torch, stream, state_gpu, state_cpu, t, dg, dc, draws_gpu, draws_cpu):
    """The epoch's stream view on the card and on the CPU from the same
    state and draws: (number of view indices that differ, the distance of
    each such index's uniform to the nearest edge of the CPU's CDF)."""
    from repro_torch.data.stream import view_cdf

    idx_g, _ = stream.step(state_gpu, t, dg["labels"], draws_gpu.stream)
    idx_c, _ = stream.step(state_cpu, t, dc["labels"], draws_cpu.stream)
    diff = idx_g.cpu() != idx_c
    n = int(diff.sum())
    dist = []
    if n and stream.weights is not None:
        cdf = view_cdf(stream.weights(state_cpu, t, dc["labels"]))
        u = draws_cpu.stream
        for i, j in diff.nonzero().tolist()[:20]:
            dist.append(min(abs(u[i, j].item() - c) for c in cdf[i].tolist()))
    return n, dist


def rows_of(params, like):
    """The shared ``params`` expanded to the lanes of ``like`` (a step's
    per-client weights), as local training starts from them."""
    return {k: v.unsqueeze(0).expand_as(like[k]) for k, v in params.items()}


@contextlib.contextmanager
def wrapped_sgd_update(sim, wrap):
    """The simulator's ``sgd_update`` (the local training's step) replaced
    by ``wrap(real_sgd_update)`` inside the block."""
    real = sim.sgd_update
    sim.sgd_update = wrap(real)
    try:
        yield
    finally:
        sim.sgd_update = real


def phase_cpu_vs_gpu(torch, sim, cfg, backend, data, TorchDraws, dev, phase4_metrics=None,
                     epochs=None, exact=EXACT, exact_metrics=EXACT_METRICS, name="slice_cpu_vs_gpu",
                     forced=False):
    """Phase 5 (and 9a's first scenario run).  Drive the run again on the
    GPU for ``epochs`` (default all) epochs; before each GPU epoch, copy its
    input state to the CPU and run the same epoch there with the plain
    versions and the same draws.  Fields ``exact`` (carry) and
    ``exact_metrics`` must be equal, the stream's view indices too; params,
    h and M within the stated tolerances.  ``forced`` (9a): the CPU epoch's
    local training is teacher-forced by the GPU's, step by step (each CPU
    step within STEP_ATOL of the GPU's from the same weights), and the
    free-running spreads are reported beside it: the GPU epoch run twice,
    and the CPU epoch unforced.  The last GPU epoch runs under
    torch.profiler.  With ``phase4_metrics`` (phase 5), also the SGD
    sensitivity and whether the redrive matched phase 4."""
    from repro_torch.models.cnn import macro_f1

    cpu = torch.device("cpu")
    epochs = cfg.epochs if epochs is None else epochs
    dg, dc = sim.to_device_data(data, dev), sim.to_device_data(data, cpu)
    epoch_gpu, epoch_cpu = sim.make_epoch_fn(cfg, backend, dg), sim.make_epoch_fn(cfg, backend, dc)
    stream = cfg.data_stream(backend.num_classes)
    draws, n_samples = TorchDraws(seed=cfg.seed), dg["images"].shape[1]
    carry = sim.init_carry(cfg, backend, dev, draws=draws)
    worst = {"params": 0.0, "h": 0.0, "avg_m": 0.0, "avg_age": 0.0}
    redrive, views, per_epoch = [], [], []
    cpu_s = 0.0
    profile = None
    steps, step_errs = [], []

    def record(real):  # the GPU epoch keeps each step's weights
        def update(p, grads, lr):
            steps.append(real(p, grads, lr))
            return steps[-1]
        return update

    def force(real):  # the CPU steps from the GPU's weights and goes on from them
        def update(p, grads, lr):
            if len(step_errs) == len(steps):
                raise AssertionError("the CPU epoch takes more SGD steps than the GPU epoch")
            gpu = to_device(steps[len(step_errs)], cpu)
            step_errs.append(max_abs(real(p, grads, lr), gpu))
            return gpu
        return update

    for t in range(epochs):
        cin = to_device(carry, cpu)
        if t == epochs - 1:
            profile = profile_run(torch, lambda: epoch_gpu(carry, t, draws.epoch(t, cfg, n_samples, dev)), dev, "ehfl.",
                                  no_concat=("ehfl.fedavg",))
        draws_gpu, draws_cpu = draws.epoch(t, cfg, n_samples, dev), draws.epoch(t, cfg, n_samples, cpu)
        if stream.persistent:
            n_diff, dist = view_mismatches(torch, stream, carry.stream, cin.stream, t, dg, dc, draws_gpu, draws_cpu)
            views.append({"epoch": t, "indices": dg["labels"].numel(), "differ": n_diff, "edge_distance": dist})
            if n_diff:
                log(json.dumps({"phase": name, "view_mismatch": views[-1]}))
                raise AssertionError(f"epoch {t}: the stream view differs in {n_diff} indices on GPU and CPU")
        if forced:
            steps.clear()
            step_errs.clear()
            with wrapped_sgd_update(sim, record):
                nxt, mg = epoch_gpu(carry, t, draws_gpu)
            again, _ = epoch_gpu(carry, t, draws_gpu)
            free, _ = epoch_cpu(cin, t, draws_cpu)
            t0 = time.perf_counter()
            with wrapped_sgd_update(sim, force):
                out, mc = epoch_cpu(cin, t, draws_cpu)
            cpu_s += time.perf_counter() - t0
            if len(step_errs) != len(steps) or not max(step_errs, default=0.0) <= STEP_ATOL:
                raise AssertionError(f"epoch {t}: a CPU SGD step from the GPU's weights is more than {STEP_ATOL} "
                                     f"from the GPU's step ({len(step_errs)} of {len(steps)} steps): {step_errs}")
            updates = [max((b[k] - a[k]).abs().max().item() for k in a)
                       for a, b in zip([rows_of(carry.global_params, steps[0])] + steps[:-1], steps)]
            per_epoch.append({
                "epoch": t, "n_started": mg["n_started"].item(), "sgd_steps": len(steps),
                "step_max_abs_err": max(step_errs, default=0.0), "step_max_abs_update": max(updates, default=0.0),
                "free_running_h_gpu_vs_gpu": max_abs(nxt.h, again.h), "free_running_h_gpu_vs_cpu": max_abs(nxt.h, free.h),
                "free_running_client_params_gpu_vs_cpu": max_abs(nxt.msg_params, free.msg_params),
            })
            del again, free
        else:
            nxt, mg = epoch_gpu(carry, t, draws_gpu)
            t0 = time.perf_counter()
            out, mc = epoch_cpu(cin, t, draws_cpu)
            cpu_s += time.perf_counter() - t0
        for f in exact:
            if not same_state(torch, getattr(nxt, f), getattr(out, f)):
                raise AssertionError(f"epoch {t}: GPU and CPU differ in {f}")
        for k in exact_metrics:
            if not torch.equal(mg[k].cpu(), mc[k]):
                raise AssertionError(f"epoch {t}: GPU and CPU differ in {k}: {mg[k].tolist()} vs {mc[k].tolist()}")
        errs = {"params": max_abs(nxt.global_params, out.global_params), "h": max_abs(nxt.h, out.h),
                "avg_m": max_abs(mg["avg_m"], mc["avg_m"]), "avg_age": max_abs(mg["avg_age"], mc["avg_age"])}
        if not (errs["params"] <= PARAM_ATOL and errs["h"] <= PARAM_ATOL and errs["avg_m"] <= M_ATOL
                and errs["avg_age"] <= AGE_MEAN_ATOL):
            raise AssertionError(f"epoch {t}: GPU and CPU disagree beyond the tolerances: {errs}")
        worst = {k: max(worst[k], errs[k]) for k in worst}
        redrive.append(mg)
        carry = nxt
    f1_gpu, f1_cpu = (
        macro_f1(backend.predict(c.global_params, d["test_images"]), d["test_labels"], backend.num_classes).item()
        for c, d in ((carry, dg), (out, dc))
    )
    if not abs(f1_gpu - f1_cpu) <= F1_ATOL:
        raise AssertionError(f"final f1 differs: GPU {f1_gpu} vs CPU {f1_cpu}")
    row = {
        "phase": name, "epochs": epochs, "cpu_epoch_s_mean": cpu_s / epochs,
        "exact": list(exact + exact_metrics), "max_abs_err": worst,
        "atol": {"params": PARAM_ATOL, "h": PARAM_ATOL, "avg_m": M_ATOL, "avg_age": AGE_MEAN_ATOL, "f1": F1_ATOL},
        "f1_gpu": f1_gpu, "f1_cpu": f1_cpu, "profile": profile,
    }
    if views:
        row["view_indices_compared"] = sum(v["indices"] for v in views)
    if forced:
        row.update(step_atol=STEP_ATOL, step_max_abs_err=max(e["step_max_abs_err"] for e in per_epoch),
                   per_epoch=per_epoch)
    if phase4_metrics is not None:
        row["sgd_sensitivity"] = sgd_sensitivity(torch, sim, cfg, backend, dg, draws, dev)
        # the GPU run is not bitwise repeatable (cuDNN's backward passes sum
        # with atomics), so this is reported, not required
        row["redrive_matches_phase4"] = all(
            torch.equal(torch.stack([m[k] for m in redrive]).cpu(), phase4_metrics[k].cpu()) for k in exact_metrics
        )
    return row


def run_summary(torch, m, T, smi):
    """Epoch time (median of epochs 1..T-1), clients trained per second and
    the channel's totals of one run's metrics."""
    steady = statistics.median(m["epoch_s"][1:].tolist()) if T > 1 else m["epoch_s"][0].item()
    return {
        "steady_epoch_s_median": steady, "first_epoch_s": m["epoch_s"][0].item(),
        "started_clients_per_s": m["n_started"].sum().item() / m["epoch_s"].sum().item(),
        "f1": m["f1"][-1].item(), "n_started": m["n_started"].sum().item(),
        "n_uploaded": m["n_uploaded"].sum().item(), "n_delivered": m["n_delivered"].sum().item(),
        "n_failed": m["n_failed"].sum().item(), "n_dropped": m["n_dropped"].sum().item(),
        "n_retried": m["n_retried"].sum().item(), "n_resent": m["n_resent"].sum().item(), "power_limit": smi,
    }


def check_channel_run(torch, m, name):
    """9a's checks on one lossy run: every attempt lands or fails, some
    fail, and some epoch sends retrying carriers (messages that failed
    before) through fedavg_reduce's old-carrier pass; f1 finite.  Whether a
    retransmission lands is the channel's draw: phase_scenarios requires
    one over the runs together."""
    if not torch.equal(m["n_delivered"] + m["n_failed"], m["n_uploaded"]):
        raise AssertionError(f"{name}: n_delivered + n_failed != n_uploaded in some epoch")
    if not m["n_failed"].sum().item() > 0:
        raise AssertionError(f"{name}: the lossy channel failed no upload")
    if not m["n_retried"].sum().item() > 0:
        raise AssertionError(f"{name}: no retrying carrier went through the old-carrier pass")
    if not torch.isfinite(m["f1"]).all().item():
        raise AssertionError(f"{name}: f1 is not finite")


def phase_scenarios(torch, sim, cfg, backend, data, TorchDraws, ops, dev, smi):
    """Phase 9a: phase 4's paper-width run under three scenario
    combinations that cover every harvest, stream and channel scenario,
    each counted (T vaoi_distance and T fedavg_reduce launches, 2T row
    groups), checked
    (``check_channel_run``) and one further epoch profiled; the first is
    also held against the CPU epoch by epoch from shared state for 3
    epochs.  Returns the launch counts of the runs."""
    T = cfg.epochs
    counts, resent = [], 0
    dd = sim.to_device_data(data, dev)
    for name, kw in SCENARIO_RUNS:
        scfg = dataclasses.replace(cfg, **kw)
        want = {"vaoi_distance": T, "fedavg_reduce": T, "ssd_scan": 0, "swa_attention": 0, "mla_attention": 0,
                "conv_lanes": T * cnn_conv_launches(scfg.kappa, scfg.policy)}
        draws = TorchDraws(seed=scfg.seed)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        out = sim.run_simulation(scfg, backend, data, draws=draws, device=dev)
        wall = time.perf_counter() - t0
        launches = ops.launch_counts()
        row_groups = ops.row_group_count()
        counts.append(launches)
        m = out["metrics"]
        for t in range(T):
            log(json.dumps({"phase": f"scenario_{name}", "epoch": t, "epoch_s": m["epoch_s"][t].item(),
                            **{k: m[k][t].item() for k in ("n_started", "n_uploaded", "n_delivered", "n_failed",
                                                            "n_dropped", "n_retried", "n_resent", "avg_age",
                                                            "energy")}}))
        if launches != want or row_groups != 2 * T:
            raise AssertionError(f"{name}: kernel launches {launches} != {want} or fedavg_reduce row groups "
                                 f"{row_groups} != {2 * T}")
        check_channel_run(torch, m, name)
        resent += m["n_resent"].sum().item()
        if not all(torch.isfinite(v).all().item() for v in out["global_params"].values()):
            raise AssertionError(f"{name}: non-finite params")
        epoch_fn = sim.make_epoch_fn(scfg, backend, dd)
        profile = profile_run(torch, lambda: epoch_fn(out["carry"], T, draws.epoch(T, scfg, dd["images"].shape[1], dev)),
                              dev, "ehfl.", no_concat=("ehfl.fedavg",))
        log(json.dumps({"phase": f"scenario_{name}_summary", "config": kw, "epochs": T,
                        "wall_s": wall, "launches": launches, "fedavg_row_groups": row_groups,
                        **run_summary(torch, m, T, smi),
                        "profile_epoch": profile}))
    if not resent > 0:
        raise AssertionError("no retransmission of a failed message landed in any scenario run")
    name, kw = SCENARIO_RUNS[0]
    scen = dataclasses.replace(cfg, **kw)
    exact = EXACT + ("retries", "backoff", "harvest", "stream", "channel")
    log(json.dumps(phase_cpu_vs_gpu(torch, sim, scen, backend, data, TorchDraws, dev, epochs=SCENARIO_CPU_EPOCHS,
                                    exact=exact, exact_metrics=EXACT_METRICS + ("n_failed", "n_dropped"),
                                    name=f"scenario_{name}_cpu_vs_gpu", forced=True)))
    return counts


def phase_run_batch(torch, sim, cfg, backend, data, ops, dev, smi, solo_wall_s):
    """Phase 9b: ``run_batch`` at paper width over BATCH_SEEDS (3T launches
    of each kernel, 6T fedavg_reduce row groups, the output shapes, the
    shared eval schedule), timed; then,
    under cuDNN's deterministic algorithms (this check only), seed 1 of the
    batch against a solo ``run_simulation(seed=1)``: integer fields and
    selections exactly, params within phase 5's tolerance.  Returns the
    launch counts of the timed batch."""
    T, R, n = cfg.epochs, len(BATCH_SEEDS), cfg.num_clients
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = sim.run_batch(cfg, backend, data, BATCH_SEEDS, device=dev)
    wall = time.perf_counter() - t0
    launches, row_groups = ops.launch_counts(), ops.row_group_count()
    want = {"vaoi_distance": R * T, "fedavg_reduce": R * T, "ssd_scan": 0, "swa_attention": 0,
            "mla_attention": 0,
            "conv_lanes": R * T * cnn_conv_launches(cfg.kappa, cfg.policy)}
    if launches != want or row_groups != 2 * R * T:
        raise AssertionError(f"run_batch: kernel launches {launches} != {want} or fedavg_reduce row groups "
                             f"{row_groups} != {2 * R * T}")
    m = out["metrics"]
    n_evals = len(range(cfg.eval_every, T + 1, cfg.eval_every)) + (T % cfg.eval_every > 0)
    shapes_ok = (
        all(m[k].shape == (R, T) for k in ("energy", "avg_age", "n_started", "n_uploaded", "avg_m", "n_failed"))
        and m["selected"].shape == (R, T, n) and m["f1"].shape == (R, n_evals) and m["total_energy"].shape == (R,)
        and m["f1_epochs"].tolist() == sorted({*range(cfg.eval_every, T + 1, cfg.eval_every), T})
        and out["carry"].battery.shape == (R, n)
        and all(out["global_params"][k].shape[0] == R for k in out["global_params"])
    )
    if not (shapes_ok and torch.isfinite(m["f1"]).all().item()):
        raise AssertionError(f"run_batch output shapes or f1 wrong: f1 {m['f1'].tolist()}")
    per_seed = [statistics.median(m["epoch_s"][i, 1:].tolist()) for i in range(R)]
    steady = statistics.median(m["epoch_s"][:, 1:].flatten().tolist())
    log(json.dumps({
        "phase": "run_batch", "seeds": list(BATCH_SEEDS), "epochs": T, "wall_s": wall, "launches": launches,
        "fedavg_row_groups": row_groups,
        "per_seed_steady_epoch_s": per_seed, "f1": m["f1"][:, -1].tolist(),
        "n_started": m["n_started"].sum(1).tolist(), "total_energy": m["total_energy"].tolist(),
        "seeds_per_hour_at_T500": 3600.0 / (500 * steady), "solo_wall_s_phase4": solo_wall_s,
        "wall_over_R_solo": wall / (R * solo_wall_s), "power_limit": smi,
    }))

    # seed 1 of the batch against its solo run, bit-repeatable cuDNN
    with deterministic_cudnn(torch):
        batch = sim.run_batch(cfg, backend, data, BATCH_SEEDS, device=dev)
        solo = sim.run_simulation(dataclasses.replace(cfg, seed=1), backend, data, device=dev)
    i = BATCH_SEEDS.index(1)
    exact_fields = EXACT + ("retries", "backoff")
    diff_metrics = [k for k in EXACT_METRICS + ("n_delivered", "n_failed", "n_dropped")
                    if not torch.equal(batch["metrics"][k][i], solo["metrics"][k])]
    diff_fields = [f for f in exact_fields if not torch.equal(getattr(batch["carry"], f)[i], getattr(solo["carry"], f))]
    err = max_abs({k: v[i] for k, v in batch["global_params"].items()}, solo["global_params"])
    f1_err = max_abs(batch["metrics"]["f1"][i], solo["metrics"]["f1"])
    row = {"phase": "run_batch_seed_vs_solo", "seed": 1, "cudnn_deterministic": True,
           "differing_exact_metrics": diff_metrics, "differing_exact_fields": diff_fields,
           "params_max_abs_err": err, "f1_abs_err": f1_err, "atol": {"params": PARAM_ATOL, "f1": F1_ATOL}}
    log(json.dumps(row))
    if diff_fields or diff_metrics or not (err <= PARAM_ATOL and f1_err <= F1_ATOL):
        raise AssertionError(f"seed 1 of run_batch differs from its solo run: {row}")
    return launches


@contextlib.contextmanager
def deterministic_cudnn(torch):
    """cuDNN's deterministic algorithms inside the block: a run repeats bit
    for bit, so two paths through the same arithmetic can be compared."""
    prev = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = prev


# Phase 10: the client-sharded fleet (core/fleet.py).  10a: one NCCL rank in
# this process; 10b and 10c: FLEET_RANKS gloo ranks on this one card (NCCL
# refuses two ranks on one GPU; gloo all-reduces CUDA tensors through the
# host), one spawn for both.  A collective that waits FLEET_TIMEOUT_S fails
# its rank, and the spawn fails if it runs that long.  10b compares the last
# FLEET_COMPARE_EPOCHS epochs of T: at p_bc = 0.1 a battery holds the
# kappa = 20 units a training run needs only after about 7 epochs, so the
# first epochs train nobody.  For the same reason 10c runs T epochs too
# (at T = 3 no client of the N = 1024 fleet trained).
FLEET_COMPARE_EPOCHS = 3
FLEET_SCALE_N = 1024
FLEET_TIMEOUT_S = 600.0
FLEET_EXACT_METRICS = EXACT_METRICS + ("n_delivered", "n_failed", "n_dropped", "n_retried", "n_resent", "avg_age")
FLEET_EXACT_FIELDS = EXACT + ("retries", "backoff")


def fleet_vs_solo(torch, fleet_carry, fleet_m, solo_carry, solo_m, what) -> dict:
    """A fleet's carry and metrics against a solo run's from the same state
    (phase 5's rule): the slot dynamics, ages, selections and retry counters
    exactly; params and h within PARAM_ATOL, avg_m within M_ATOL."""
    row = {
        "differing_exact_metrics": [k for k in FLEET_EXACT_METRICS if not torch.equal(fleet_m[k].cpu(), solo_m[k].cpu())],
        "differing_exact_fields": [f for f in FLEET_EXACT_FIELDS
                                   if not same_state(torch, getattr(fleet_carry, f), getattr(solo_carry, f))],
        "max_abs_err": {"params": max_abs(fleet_carry.global_params, solo_carry.global_params),
                        "h": max_abs(fleet_carry.h, solo_carry.h), "avg_m": max_abs(fleet_m["avg_m"], solo_m["avg_m"])},
        "atol": {"params": PARAM_ATOL, "h": PARAM_ATOL, "avg_m": M_ATOL},
    }
    errs = row["max_abs_err"]
    if (row["differing_exact_metrics"] or row["differing_exact_fields"]
            or not (errs["params"] <= PARAM_ATOL and errs["h"] <= PARAM_ATOL and errs["avg_m"] <= M_ATOL)):
        raise AssertionError(f"{what}: the fleet differs from the solo run: {row}")
    return row


def fleet_range_times(profile) -> dict:
    """The ``ehfl.fleet.*`` ranges (the collectives) of a profiled epoch."""
    return {k: {"host_ms": v["host_ms"], "device_ms": v["device_ms"], "calls": v["calls"]}
            for k, v in profile["layers"].items() if k.startswith("ehfl.fleet.")}


def phase_fleet_nccl(torch, sim, fleet, cfg, backend, data, TorchDraws, ops, dev, smi, solo_steady_s):
    """Phase 10a: ``run_fleet`` on one NCCL rank at phase 4's width and depth
    (the solo path plus collectives over one rank): T vaoi_distance and T
    fedavg_reduce launches over 2T row groups, its epoch time beside phase
    4's, one profiled epoch; then, under cuDNN's deterministic algorithms,
    against a solo run (``fleet_vs_solo``).  Returns the launch counts."""
    import datetime
    import tempfile

    import torch.distributed as dist

    T = cfg.epochs
    want = {"vaoi_distance": T, "fedavg_reduce": T, "ssd_scan": 0, "swa_attention": 0, "mla_attention": 0,
            "conv_lanes": T * cnn_conv_launches(cfg.kappa, cfg.policy)}
    with tempfile.TemporaryDirectory(prefix="fleet-") as tmp:
        backend_name = "nccl" if dev.type == "cuda" else "gloo"  # gloo: a rehearsal on the CPU
        dist.init_process_group(backend_name, init_method=f"file://{tmp}/store", world_size=1, rank=0,
                                timeout=datetime.timedelta(seconds=FLEET_TIMEOUT_S))
        try:
            ops.reset_launch_counts()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            out = fleet.run_fleet(cfg, backend, data, draws=TorchDraws(seed=cfg.seed), device=dev)
            wall = time.perf_counter() - t0
            launches, row_groups = ops.launch_counts(), ops.row_group_count()
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            if launches != want or row_groups != 2 * T:
                raise AssertionError(f"10a: kernel launches {launches} != {want} or fedavg_reduce row groups "
                                     f"{row_groups} != {2 * T}")
            dd = sim.to_device_data(data, dev)
            epoch_fn = fleet.make_fleet_epoch_fn(cfg, backend, dd)
            draws = TorchDraws(seed=cfg.seed)
            profile = profile_run(torch, lambda: epoch_fn(out["carry"], T, draws.epoch(T, cfg, dd["images"].shape[1], dev)),
                                  dev, "ehfl.", no_concat=("ehfl.fedavg",))
            del dd, epoch_fn
            with deterministic_cudnn(torch):
                f = fleet.run_fleet(cfg, backend, data, draws=TorchDraws(seed=cfg.seed), device=dev)
                s = sim.run_simulation(cfg, backend, data, draws=TorchDraws(seed=cfg.seed), device=dev)
            cmp = fleet_vs_solo(torch, f["carry"], f["metrics"], s["carry"], s["metrics"], "10a")
        finally:
            dist.destroy_process_group()
    log(json.dumps({
        "phase": "fleet_nccl_one_rank", "backend": backend_name, "num_shards": out["num_shards"], "epochs": T,
        "wall_s": wall, "launches": launches, "fedavg_row_groups": row_groups, **run_summary(torch, out["metrics"], T, smi),
        "phase4_steady_epoch_s_median": solo_steady_s, "peak_gpu_mem_gb": peak_gb,
        "vs_solo_cudnn_deterministic": {"epochs": T, **cmp}, "fleet_ranges": fleet_range_times(profile),
        "profile_epoch": profile,
    }))
    return launches


def save_pools(data, prefix: Path) -> None:
    """Client pools and test set as .npy files, which the ranks map."""
    import numpy as np

    for k, v in data.items():
        np.save(f"{prefix}_{k}.npy", v.cpu().numpy())


def load_pools(prefix: Path) -> dict:
    """The saved pools, memory-mapped: ``run_fleet`` reads only a rank's rows."""
    import numpy as np

    return {k: np.load(f"{prefix}_{k}.npy", mmap_mode="r") for k in ("images", "labels", "test_images", "test_labels")}


def fleet_rank(rank: int, workdir: str, cfg, device: str) -> None:
    """Phases 10b and 10c on one gloo rank of FLEET_RANKS, all on this card:
    (b) FLEET_COMPARE_EPOCHS epochs from the solo run's state (this rank's
    shard of it), under cuDNN's deterministic algorithms; a T-epoch
    ``run_fleet``, counted and timed; one profiled epoch; (c) ``run_fleet``
    at N=FLEET_SCALE_N for T epochs, with its peak memory.
    Writes ``rank<r>.pt`` for the parent."""
    import torch
    import torch.distributed as dist

    from repro_torch.configs import CONFIG
    from repro_torch.core import fleet
    from repro_torch.core import simulator as sim
    from repro_torch.core.draws import TorchDraws
    from repro_torch.fl import cnn_backend
    from repro_torch.kernels import ops

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev, cpu, work = torch.device(device), torch.device("cpu"), Path(workdir)
    backend, draws = cnn_backend(CONFIG), TorchDraws(seed=cfg.seed)
    T = cfg.epochs
    out = {"rank": rank, "compare": []}

    # 10b: epoch by epoch from the solo run's state
    pools = load_pools(work / "b")
    n_loc = cfg.num_clients // dist.get_world_size()
    rows = slice(rank * n_loc, (rank + 1) * n_loc)
    local = sim.to_device_data({k: v[rows] if k in ("images", "labels") else v for k, v in pools.items()}, dev)
    epoch_fn = fleet.make_fleet_epoch_fn(cfg, backend, local)
    n_samples = local["images"].shape[1]
    with deterministic_cudnn(torch):
        for t in range(T - FLEET_COMPARE_EPOCHS, T):
            carry = to_device(torch.load(work / f"b_carry{t}_rank{rank}.pt", weights_only=False), dev)
            ops.reset_launch_counts()
            nxt, m = epoch_fn(carry, t, draws.epoch(t, cfg, n_samples, dev))
            torch.cuda.synchronize()
            out["compare"].append({"carry": to_device(nxt, cpu), "metrics": {k: v.cpu() for k, v in m.items()},
                                   "launches": ops.launch_counts(), "row_groups": ops.row_group_count()})
    # 10b: a T-epoch run, counted and timed, then one profiled epoch
    ops.reset_launch_counts()
    run = fleet.run_fleet(cfg, backend, pools, draws=draws, device=dev)
    m = run["metrics"]
    out["run_b"] = {
        "launches": ops.launch_counts(), "row_groups": ops.row_group_count(), "num_shards": run["num_shards"],
        "epoch_s": m["epoch_s"].tolist(), "n_started": m["n_started"].sum().item(), "f1": m["f1"][-1].item(),
        "finite": all(torch.isfinite(v).all().item() for v in run["global_params"].values()),
    }
    out["profile_b"] = profile_run(torch, lambda: epoch_fn(run["carry"], T, draws.epoch(T, cfg, n_samples, dev)), dev,
                                   "ehfl.", no_concat=("ehfl.fedavg",))
    # the epoch's all-reduces alone, each started together on every rank (a
    # barrier first), so that no rank's wait for a slower one counts: the
    # (P,) FedAvg partial and the (10 + N,) float64 metrics vector
    partial = torch.zeros(sum(v.numel() for v in run["global_params"].values()), device=dev)
    metrics_vec = torch.zeros(len(m) + cfg.num_clients, dtype=torch.float64, device=dev)
    out["allreduce_ms"] = {}
    for name, x in (("fedavg_partial", partial), ("metrics_vector", metrics_vec)):
        times = []
        for _ in range(12):
            dist.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            dist.all_reduce(x)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        out["allreduce_ms"][name] = {"numel": x.numel(), "dtype": str(x.dtype), "median_ms": statistics.median(times[2:])}
    del run, local, epoch_fn, carry, nxt, partial
    torch.cuda.empty_cache()

    # 10c: fleet scale
    cfg_c = dataclasses.replace(cfg, num_clients=FLEET_SCALE_N)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    run = fleet.run_fleet(cfg_c, backend, load_pools(work / "c"), draws=draws, device=dev)
    wall = time.perf_counter() - t0
    m = run["metrics"]
    out["run_c"] = {
        "launches": ops.launch_counts(), "row_groups": ops.row_group_count(), "num_shards": run["num_shards"],
        "wall_s": wall, "epoch_s": m["epoch_s"].tolist(), "n_started": m["n_started"].tolist(),
        "n_uploaded": m["n_uploaded"].tolist(), "energy": m["energy"].tolist(), "f1": m["f1"][-1].item(),
        "finite": all(torch.isfinite(v).all().item() for v in run["global_params"].values()),
        "peak_gpu_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "msg_params_gb": sum(
            v.numel() * v.element_size() for v in run["carry"].msg_params.values()) / 1e9,
    }
    torch.save(out, work / f"rank{rank}.pt")


def phase_fleet_gloo(torch, sim, fleet, cfg, backend, data, TorchDraws, ops, dev, smi, make_federated_dataset):
    """Phases 10b and 10c: FLEET_RANKS gloo ranks on this card
    (``fleet_rank``).  10b holds the fleet to the solo run on the card epoch
    by epoch from shared state (``fleet_vs_solo``) and counts each rank's T
    vaoi_distance launches at its (N/4, 10) and T fedavg_reduce launches over
    2T row groups; 10c runs N=FLEET_SCALE_N.  Returns each rank's launch
    counts of 10b's and 10c's runs."""
    import tempfile

    from repro_torch.launch.mesh import spawn_fleet

    cpu, R, E, T = torch.device("cpu"), FLEET_RANKS, FLEET_COMPARE_EPOCHS, cfg.epochs
    with tempfile.TemporaryDirectory(prefix="fleet-") as tmp:
        work = Path(tmp)
        save_pools(data, work / "b")
        # the solo run on the card, epoch by epoch, with each rank's shard of each epoch's input state
        dd = sim.to_device_data(data, dev)
        epoch_fn, draws = sim.make_epoch_fn(cfg, backend, dd), TorchDraws(seed=cfg.seed)
        carry, solo = sim.init_carry(cfg, backend, dev, draws=draws), []
        with deterministic_cudnn(torch):
            for t in range(T):
                if t >= T - E:
                    for r in range(R):
                        torch.save(to_device(fleet.shard_carry(cfg, carry, r, R), cpu), work / f"b_carry{t}_rank{r}.pt")
                carry, m = epoch_fn(carry, t, draws.epoch(t, cfg, dd["images"].shape[1], dev))
                if t >= T - E:
                    solo.append((to_device(carry, cpu), {k: v.cpu() for k, v in m.items()}))
        del carry, dd, epoch_fn
        t0 = time.perf_counter()
        scale = make_federated_dataset(0, num_clients=FLEET_SCALE_N, samples_per_client=300, test_size=500, device="cpu")
        save_pools(scale, work / "c")
        del scale
        pools_s = time.perf_counter() - t0
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        spawn_fleet(fleet_rank, R, "gloo", args=(tmp, cfg, str(dev)), timeout_s=FLEET_TIMEOUT_S)
        spawn_s = time.perf_counter() - t0
        ranks = [torch.load(work / f"rank{r}.pt", weights_only=False) for r in range(R)]

    # 10b: the fleet against the solo run, epoch by epoch
    per_epoch = []
    for i, (solo_carry, solo_m) in enumerate(solo):
        t, outs = T - E + i, [rk["compare"][i] for rk in ranks]
        for o in outs[1:]:
            if not all(torch.equal(o["metrics"][k], outs[0]["metrics"][k]) for k in FLEET_EXACT_METRICS):
                raise AssertionError(f"10b epoch {t}: the ranks' fleet-wide metrics differ")
        counted = [(o["launches"]["vaoi_distance"], o["launches"]["fedavg_reduce"], o["row_groups"]) for o in outs]
        if counted != [(1, 1, 2)] * R:
            raise AssertionError(f"10b epoch {t}: per-rank launches (vaoi, fedavg, row groups) {counted} != (1, 1, 2)")
        cmp = fleet_vs_solo(torch, fleet.gather_carry(cfg, [o["carry"] for o in outs]), outs[0]["metrics"],
                            solo_carry, solo_m, f"10b epoch {t}")
        per_epoch.append({"epoch": t, "n_started": solo_m["n_started"].item(),
                          "n_delivered": solo_m["n_delivered"].item(), **cmp})
    if not sum(e["n_started"] for e in per_epoch) > 0:
        raise AssertionError(f"10b: no client trained in the compared epochs {[e['epoch'] for e in per_epoch]}")
    want = {"vaoi_distance": T, "fedavg_reduce": T, "ssd_scan": 0, "swa_attention": 0, "mla_attention": 0,
            "conv_lanes": T * cnn_conv_launches(cfg.kappa, cfg.policy)}
    runs_b = [rk["run_b"] for rk in ranks]
    for r, rb in enumerate(runs_b):
        if rb["launches"] != want or rb["row_groups"] != 2 * T or rb["num_shards"] != R or not rb["finite"]:
            raise AssertionError(f"10b rank {r}: launches {rb['launches']} != {want}, row groups {rb['row_groups']} "
                                 f"!= {2 * T}, shards {rb['num_shards']} or non-finite params")
    steady = [statistics.median(rb["epoch_s"][1:]) for rb in runs_b]
    log(json.dumps({
        "phase": "fleet_gloo_4ranks_one_card", "backend": "gloo (CUDA tensors, one card)", "ranks": R,
        "clients_per_rank": cfg.num_clients // R, "epochs": T, "spawn_s": spawn_s,
        "vs_solo_epoch_by_epoch": {"epochs": E, "cudnn_deterministic": True, "per_epoch": per_epoch},
        "per_rank": [{"rank": r, "launches": rb["launches"], "fedavg_row_groups": rb["row_groups"],
                      "steady_epoch_s_median": steady[r], "first_epoch_s": rb["epoch_s"][0],
                      "fleet_ranges": fleet_range_times(ranks[r]["profile_b"]),
                      "allreduce_alone_ms": ranks[r]["allreduce_ms"],
                      "profile_wall_ms": ranks[r]["profile_b"]["wall_ms"],
                      "device_idle_share": ranks[r]["profile_b"]["device_idle_share"],
                      "port_kernels": ranks[r]["profile_b"]["port_kernels"]} for r, rb in enumerate(runs_b)],
        "started_clients_per_s": runs_b[0]["n_started"] / sum(runs_b[0]["epoch_s"]), "f1": runs_b[0]["f1"],
        "power_limit": smi,
    }))
    log(json.dumps({"phase": "fleet_gloo_profile_rank0", "profile_epoch": ranks[0]["profile_b"]}))

    # 10c: fleet scale
    Tc = T
    want_c = {"vaoi_distance": Tc, "fedavg_reduce": Tc, "ssd_scan": 0, "swa_attention": 0,
              "mla_attention": 0,
              "conv_lanes": Tc * cnn_conv_launches(cfg.kappa, cfg.policy)}
    runs_c = [rk["run_c"] for rk in ranks]
    for r, rc in enumerate(runs_c):
        if rc["launches"] != want_c or rc["row_groups"] != 2 * Tc or rc["num_shards"] != R or not rc["finite"]:
            raise AssertionError(f"10c rank {r}: launches {rc['launches']} != {want_c}, row groups {rc['row_groups']}, "
                                 f"shards {rc['num_shards']} or non-finite params")
    if not 0.0 <= runs_c[0]["f1"] <= 1.0:
        raise AssertionError(f"10c: f1 out of range: {runs_c[0]['f1']}")
    log(json.dumps({
        "phase": "fleet_scale", "backend": "gloo (CUDA tensors, one card), not NCCL across cards", "ranks": R,
        "num_clients": FLEET_SCALE_N, "clients_per_rank": FLEET_SCALE_N // R, "epochs": Tc, "pools_setup_s": pools_s,
        "per_rank": [{"rank": r, "wall_s": rc["wall_s"], "epoch_s": rc["epoch_s"], "peak_gpu_mem_gb": rc["peak_gpu_mem_gb"],
                      "msg_params_gb": rc["msg_params_gb"], "launches": rc["launches"], "fedavg_row_groups": rc["row_groups"]}
                     for r, rc in enumerate(runs_c)],
        "steady_epoch_s_median": statistics.median(runs_c[0]["epoch_s"][1:]),
        "per_epoch_n_started": runs_c[0]["n_started"],
        "started_clients_per_s": sum(runs_c[0]["n_started"]) / sum(runs_c[0]["epoch_s"]),
        "n_started": runs_c[0]["n_started"], "n_uploaded": runs_c[0]["n_uploaded"], "energy": runs_c[0]["energy"],
        "f1": runs_c[0]["f1"], "power_limit": smi,
    }))
    return {"10b_per_rank": [rb["launches"] for rb in runs_b], "10c_per_rank": [rc["launches"] for rc in runs_c]}


def sgd_sensitivity(torch, sim, cfg, backend, data, draws, dev) -> float:
    """Max |change| of one client's weights after kappa SGD steps on the GPU
    when its initial weights are scaled by (1 + 1e-7·noise): how much the
    local training amplifies rounding-sized differences."""
    params = sim.init_carry(cfg, backend, dev).global_params
    g = torch.Generator().manual_seed(1)
    nudged = {k: v * (1 + 1e-7 * torch.randn(v.shape, generator=g).to(dev)) for k, v in params.items()}
    perms = draws.epoch(0, cfg, data["images"].shape[1], dev).perms[:1]
    imgs, lbls = data["images"][:1], data["labels"][:1]
    a, _ = sim._local_train(params, imgs, lbls, perms, cfg, backend, with_feature=False)
    b, _ = sim._local_train(nudged, imgs, lbls, perms, cfg, backend, with_feature=False)
    return max_abs(a, b)


# the port's kernel functions (csrc/*.cu), as the profiler names them
PORT_KERNEL_NAMES = ("fedavg_leaves_kernel", "vaoi_distance", "ssd_", "swa_")


def subtree(event):
    """A profiler event and every CPU event under it."""
    yield event
    for child in event.cpu_children:
        yield from subtree(child)


def profile_run(torch, run, dev, prefix, no_concat=()):
    """One call of ``run`` under torch.profiler: its wall time, the device's
    busy time (the CUDA kernels' time summed), each ``prefix*`` range's host
    time, the device time of the kernels it launched, its ``aten::cat`` ops
    and concatenation kernels (``CatArrayBatchedCopy*``) and the names of its
    kernels; and the top kernels.  Each range named in ``no_concat`` must
    run and hold no concatenation (the FedAvg layer reads leaves in place)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize(dev)
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA and not e.name.startswith(prefix)]
    layers = {}
    for e in events:
        if e.device_type == DeviceType.CPU and e.name.startswith(prefix):
            row = layers.setdefault(e.name, {"host_ms": 0.0, "device_ms": 0.0, "calls": 0, "cat_ops": 0,
                                             "cat_kernels": 0, "kernel_names": []})
            row["host_ms"] += e.cpu_time_total / 1e3
            row["device_ms"] += e.device_time_total / 1e3
            row["calls"] += 1
            under = list(subtree(e))
            names = [k.name for x in under for k in x.kernels]
            row["cat_ops"] += sum(x.name == "aten::cat" for x in under)
            row["cat_kernels"] += sum("CatArrayBatchedCopy" in k for k in names)
            row["kernel_names"] = sorted({*row["kernel_names"], *(k[:60] for k in names)})
    by_name = {}
    for e in kernels:
        row = by_name.setdefault(e.name[:80], {"name": e.name[:80], "device_ms": 0.0, "calls": 0})
        row["device_ms"] += e.time_range.elapsed_us() / 1e3
        row["calls"] += 1
    for name in no_concat:
        layer = layers.get(name)
        if layer is None or layer["cat_ops"] or layer["cat_kernels"]:
            raise AssertionError(f"{name} did not run or concatenates: {layer}")
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    return {
        "wall_ms": wall_ms, "device_busy_ms": busy_ms, "device_idle_share": 1.0 - busy_ms / wall_ms,
        "kernel_launches": len(kernels), "layers": layers,
        # the profiler does not attribute the ctypes launches to a range: the port's kernels by name
        "port_kernels": [r for r in by_name.values() if any(k in r["name"] for k in PORT_KERNEL_NAMES)],
        "top": sorted(by_name.values(), key=lambda r: r["device_ms"], reverse=True)[:10],
    }


def feature_gap(torch, a, b) -> float:
    """max_i ||a_i - b_i||_2 over max_i ||b_i||_2: two routes' probe features."""
    return (torch.linalg.vector_norm(a - b, dim=-1).max() / torch.linalg.vector_norm(b, dim=-1).max()).item()


def ulps_apart(torch, got, want) -> float:
    """max |got - want| in units of want's fp32 spacing (0 where they are equal)."""
    spacing = torch.nextafter(want.abs(), torch.tensor(float("inf"), device=want.device)) - want.abs()
    return ((got - want).abs() / spacing).max().item()


def train_step_timed(torch, step, params, batch, runs):
    """A warm-up step from ``params`` on ``batch``, then ``runs`` more, each
    from the last one's params on the same batch, on the host clock ended by
    synchronize.  Returns (losses of all the steps, the timed steps' ms)."""
    loss, p = step(params, batch)
    torch.cuda.synchronize()
    losses, times = [loss.item()], []
    for _ in range(runs):
        t0 = time.perf_counter()
        loss, p = step(p, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss.item())
    return losses, times


def leaf_launches(leaves) -> int:
    """fedavg_reduce launches of one FedAvg over ``leaves`` ((shape, dtype)
    each): one call a dtype (``simulator.leaf_mean``), runs of MAX_LEAVES."""
    from repro_torch.kernels.fedavg_reduce import MAX_LEAVES

    per_dtype = {}
    for _, dtype in leaves:
        per_dtype[dtype] = per_dtype.get(dtype, 0) + 1
    return sum(math.ceil(n / MAX_LEAVES) for n in per_dtype.values())


def lm_kernel_rows(torch, ops, ref, kern_fedavg, feats, leaves, groups, mu, seed) -> dict:
    """The EHFL kernels at an LM client's shapes, each against its plain
    version on the same inputs and timed beside it and the library call
    that computes the same function; bounds from this run's shapes.
    vaoi_distance over the probe's (N, V) ``feats`` against moments drawn
    from ``seed``; the FedAvg leaf table over stacked leaves of ``leaves``
    ((shape, dtype) each, in sorted-name order), one group per (rows,
    (rows,) weights) of ``groups``, drawn from ``seed`` + 1, one call a leaf
    dtype as the simulator makes them (within one fp32 ulp: both read the
    leaves exactly into fp32 and reduce in the same order).  Returns
    {kernel: row}."""
    from repro_torch.kernels.vaoi_distance import plan_of as vaoi_plan_of

    dev = feats.device
    rows = {}
    N, V = feats.shape
    h = torch.softmax(torch.randn(N, V, generator=torch.Generator(device=dev).manual_seed(seed), device=dev), dim=-1)
    age, q = torch.arange(N, dtype=torch.float32, device=dev), (torch.arange(N, device=dev) % 4 == 0).float()
    m, new_age = ops.vaoi_distance(feats, h, age, q, mu)
    m_ref, age_ref = ref.vaoi_distance_ref(feats, h, age, q, mu)
    err = (m - m_ref).abs().max().item()
    if err > 1e-6 * max(1.0, m_ref.abs().max().item()) or not torch.equal(new_age, age_ref):
        raise AssertionError(f"vaoi_distance at ({N}, {V}) disagrees with its plain version: {err}")
    t = interleaved_ms({
        "kernel": lambda: ops.vaoi_distance(feats, h, age, q, mu),
        "plain": lambda: ref.vaoi_distance_ref(feats, h, age, q, mu),
        "library": lambda: torch.linalg.vector_norm(feats - h, dim=-1),
    }, EHFL_ITERS)
    b_ms, b_by = bound(2 * N * V * 4 + 4 * N * 4, 3 * N * V)
    plan = vaoi_plan_of(feats)
    rows["vaoi_distance"] = {"shape": [N, V], "max_abs_err": err, "ms": t["kernel"], "plain_ms": t["plain"],
                             "bound_ms": b_ms, "bound_by": b_by, "library_ms": t["library"],
                             "library": "linalg.vector_norm(v - h, dim=-1)", "plan": plan,
                             "design": f"{plan['route']} route, {plan['segments']} segment(s) a row"}
    del h
    gl = torch.Generator(device=dev).manual_seed(seed + 1)
    drawn = [([torch.randn((k,) + s, generator=gl, device=dev).to(dt) for s, dt in leaves], w) for k, w in groups]
    tables = [[([x for x, (_, dt) in zip(xs, leaves) if dt == dtype], w) for xs, w in drawn]
              for dtype in dict.fromkeys(dt for _, dt in leaves)]
    del drawn
    n_params = sum(math.prod(s) for s, _ in leaves)
    before = kern_fedavg.launches
    ulps = 0.0
    for table in tables:
        ulps = max(ulps, ulps_apart(torch, ops.fedavg_reduce_leaves(table), ref.fedavg_reduce_leaves_ref(table)))
    launches = kern_fedavg.launches - before
    if ulps > 1.0 or launches != leaf_launches(leaves):
        raise AssertionError(f"the leaf table over {len(leaves)} leaves is {ulps} fp32 ulps from its plain version, "
                             f"in {launches} launches")

    def library():
        for table in tables:
            out = None
            for xs, w in table:
                part = torch.mv(torch.cat([x.reshape(x.shape[0], -1) for x in xs], 1).T.float(), w)
                out = part if out is None else out + part

    t = {"kernel": time_ms(lambda: [ops.fedavg_reduce_leaves(table) for table in tables], iters=10, warmup=2),
         "plain": time_ms(lambda: [ref.fedavg_reduce_leaves_ref(table) for table in tables], iters=3, warmup=1),
         "library": time_ms(library, iters=5, warmup=1)}
    k_all = sum(k for k, _ in groups)
    nbytes = sum(k_all * math.prod(s) * torch.empty((), dtype=dt).element_size() for s, dt in leaves)
    b_ms, b_by = bound(nbytes + 4 * k_all * len(tables) + 4 * n_params, 2 * k_all * n_params)
    rows["fedavg_reduce"] = {"shape": [[k for k, _ in groups], len(leaves), n_params],
                             "dtypes": {str(dt): sum(d == dt for _, d in leaves) for dt in dict.fromkeys(
                                 d for _, d in leaves)},
                             "max_ulps": ulps, "launches_per_call": launches, "ms": t["kernel"],
                             "plain_ms": t["plain"], "bound_ms": b_ms, "bound_by": b_by, "library_ms": t["library"],
                             "library": "mv(cat(leaves).T.float(), w) per dtype and row group, added"}
    del tables
    torch.cuda.empty_cache()
    return rows


def phase_lm_training(torch, dev, ops, ref, kern_fedavg, smi):
    """Phase 12: LM training at full width on the card.  12a the training
    round function, counted and timed, with its probe, its mean and its
    Eq. 5 + Eq. 7 held to their plain versions; 12b the train step at width;
    12c a Mamba2 step; a 2-layer fp32 step held to the CPU's.  Returns the
    launch counts of 12a and the kernel rows at its shapes."""
    from repro_torch.configs import get_config
    from repro_torch.data import make_token_dataset
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import run_rounds
    from repro_torch.models import decoder

    torch.cuda.empty_cache()
    cfg, d = get_config(TRAIN_ARCH), TRAIN_ROUNDS
    g = torch.Generator().manual_seed(0)
    data = make_token_dataset(g, d["clients"], d["batch"] * d["steps_per_round"], d["seq"], cfg.vocab_size)
    data = data["tokens"].to(dev)
    noise = torch.rand(d["rounds"], d["clients"], generator=g).mul_(1e-3).to(dev)
    params = decoder.init_params(cfg, seed=0, device=dev, max_seq=d["seq"])
    flat = decoder.flat_params(params)
    n_params, n_leaves = sum(t.numel() for t in flat.values()), len(flat)
    n_attn = sum(cfg.layer_kind(i) == "attn" for i in range(cfg.num_layers))
    per_round = {"vaoi_distance": 1, "fedavg_reduce": leaf_launches([(t.shape, t.dtype) for t in flat.values()]),
                 "ssd_scan": 0,
                 "swa_attention": n_attn * (1 + d["k"]), "conv_lanes": 0,
                 "mla_attention": 0}  # the probe, then each client's refresh

    # 12a: the training rounds, the main path of this phase
    counts = []

    def record(line):
        counts.append(ops.launch_counts())
        log(json.dumps({"phase": "p12a_round", "line": line}))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    final, history = run_rounds(cfg, params, data, noise, k=d["k"], mu=d["mu"], lr=d["lr"],
                                steps_per_round=d["steps_per_round"], batch=d["batch"], log=record)
    wall_s = time.perf_counter() - t0
    launches, routes = ops.launch_counts(), ops.route_launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    deltas = [{k: c[k] - (counts[r - 1][k] if r else 0) for k in c} for r, c in enumerate(counts)]
    off_tc = routes["swa_attention"]["launches_tc"] != launches["swa_attention"]
    if any(delta != per_round for delta in deltas) or off_tc:
        raise AssertionError(f"phase 12a launches per round {deltas} != {per_round}, or swa_attention off the "
                             f"tensor cores ({routes['swa_attention']})")
    if not (all(torch.isfinite(t).all().item() for t in decoder.flat_params(final).values())
            and all(math.isfinite(h["loss"]) for h in history)):
        raise AssertionError("phase 12a: non-finite params or losses")
    tokens_per_round = d["k"] * d["steps_per_round"] * d["batch"] * d["seq"]
    round_s = statistics.median(h["round_s"] for h in history[1:])
    probe_toks = data[:, : d["batch"]].long()
    probe_ms = time_ms(lambda: decoder.feature_vectors(cfg, final, probe_toks, use_kernel=True), iters=5, warmup=1)
    round_profile = profile_run(torch, lambda: run_rounds(
        cfg, final, data, noise[:1], k=d["k"], mu=d["mu"], lr=d["lr"], steps_per_round=d["steps_per_round"],
        batch=d["batch"], log=lambda line: None), dev, "lm.")
    log(json.dumps({
        "phase": "p12a_rounds", "arch": cfg.name, "layers": cfg.num_layers, "d_model": cfg.d_model,
        "vocab": cfg.vocab_size, "dtype": str(cfg.dtype), "params": n_params, "leaves": n_leaves, **d,
        "rounds_s": [h["round_s"] for h in history], "round_s_median_1_2": round_s, "wall_s": wall_s,
        "tokens_trained_per_round": tokens_per_round, "tokens_trained_per_s": tokens_per_round / round_s,
        "probe_ms": probe_ms, "peak_gpu_mem_gb": peak_gb, "launches": launches, "launches_per_round": per_round,
        "history": history, "power_limit": smi,
    }))
    log(json.dumps({"phase": "p12a_round_profile", **round_profile}))

    # the probe's features through the kernel against the plain route
    inner, calls = ops.swa_attention, []

    def checked(q, k, v, window=0, causal=True):
        out = inner(q, k, v, window=window, causal=causal)
        calls.append(swa_error(out, ref.swa_attention_ref(q, k, v, window=window, causal=causal), q, k, v, window,
                               causal))
        return out

    ops.swa_attention = checked
    try:
        v_kernel = decoder.feature_vectors(cfg, final, probe_toks, use_kernel=True)
    finally:
        ops.swa_attention = inner
    v_plain = decoder.feature_vectors(cfg, final, probe_toks, use_kernel=False)
    with attention_without_causal_mask(ops):
        v_wrong = decoder.feature_vectors(cfg, final, probe_toks, use_kernel=True)
    probe = {"phase": "p12a_probe_routes", "attention_calls": len(calls),
             "max_ratio_to_bf16_limit": max(c[1] or 0.0 for c in calls), "max_abs_err": max(c[0] for c in calls),
             "feature_gap": feature_gap(torch, v_kernel, v_plain), "feature_norm_max":
             torch.linalg.vector_norm(v_plain, dim=-1).max().item(), "limit": PROBE_FEATURE_RTOL,
             "mutant_feature_gap": feature_gap(torch, v_wrong, v_plain), "mu": d["mu"]}
    log(json.dumps(probe))
    if len(calls) != n_attn or not all(c[2] for c in calls) or probe["feature_gap"] > PROBE_FEATURE_RTOL:
        raise AssertionError(f"phase 12a probe: the kernel route disagrees with the plain route: {probe}")
    if probe["mutant_feature_gap"] <= PROBE_FEATURE_RTOL:
        raise AssertionError(f"phase 12a probe: attention without its causal mask passes the limit: {probe}")

    # the kernels at this phase's shapes: Eq. 5 + Eq. 7 over (8, V), the
    # round's mean over 290 leaves in runs of 32
    del v_plain, v_wrong
    leaves = [(tuple(x.shape), x.dtype) for _, x in sorted(decoder.flat_params(final).items())]
    w = torch.full((d["k"],), 1.0 / d["k"], device=dev)
    rows = lm_kernel_rows(torch, ops, ref, kern_fedavg, v_kernel, leaves, [(d["k"], w)], d["mu"], 4)
    if rows["fedavg_reduce"]["launches_per_call"] != per_round["fedavg_reduce"]:
        raise AssertionError(f"the leaf table over {n_leaves} leaves took {rows['fedavg_reduce']['launches_per_call']}"
                             f" launches")
    for name, row in rows.items():
        log(json.dumps({"phase": "p12a_kernel_shape", "kernel": name, **row, "power_limit": smi}))
    del final, params, flat, data, v_kernel
    torch.cuda.empty_cache()

    # 12b: the train step at width, remat and the chunked CE
    params = decoder.init_params(cfg, seed=0, device=dev)
    gb = torch.Generator(device=dev).manual_seed(6)
    toks = torch.randint(0, cfg.vocab_size, (STEP_B, STEP_S), generator=gb, device=dev)
    batch = {"tokens": toks, "labels": toks}
    step = make_train_step(cfg, lr=d["lr"], remat=True, ce_chunk=STEP_CHUNK)
    torch.cuda.reset_peak_memory_stats()
    losses, times = train_step_timed(torch, step, params, batch, STEP_RUNS)
    peak_step = torch.cuda.max_memory_allocated() / 1e9
    step_ms = statistics.median(times)
    tokens = STEP_B * STEP_S
    with torch.no_grad():
        full, _ = decoder.loss_fn(cfg, params, batch, ce_chunk=0)
        chunked, _ = decoder.loss_fn(cfg, params, batch, ce_chunk=STEP_CHUNK)
    ce_gap = abs(full.item() - chunked.item()) / abs(full.item())
    row = {"phase": "p12b_train_step", "arch": cfg.name, "batch": STEP_B, "seq": STEP_S, "ce_chunk": STEP_CHUNK,
           "remat": True, "lr": d["lr"], "runs_ms": times, "median_ms": step_ms, "tokens_per_s": tokens / step_ms * 1e3,
           "params": n_params, "bf16_peak_share_6ND": 6 * n_params * tokens / (step_ms / 1e3) / BF16_FLOPS,
           "losses": losses, "loss_full_logits": full.item(), "loss_chunked": chunked.item(),
           "ce_chunk_rel_gap": ce_gap, "limit": CE_CHUNK_RTOL, "peak_gpu_mem_gb": peak_step, "power_limit": smi}
    log(json.dumps(row))
    if not (all(math.isfinite(x) for x in losses) and losses[1] < losses[0]) or ce_gap > CE_CHUNK_RTOL:
        raise AssertionError(f"phase 12b: the loss did not fall, is not finite, or the chunked CE parts from the "
                             f"full logits: {row}")
    log(json.dumps({"phase": "p12b_train_step_profile", **profile_run(torch, lambda: step(params, batch), dev, "lm.")}))
    del params, batch, step
    torch.cuda.empty_cache()

    # 12c: one Mamba2 step at width
    scfg = get_config(SSM_TRAIN_ARCH)
    sparams = decoder.init_params(scfg, seed=0, device=dev)
    stoks = torch.randint(0, scfg.vocab_size, (SSM_STEP_B, SSM_STEP_S), generator=gb, device=dev)
    torch.cuda.reset_peak_memory_stats()
    losses, times = train_step_timed(torch, make_train_step(scfg, lr=d["lr"], remat=True), sparams,
                                     {"tokens": stoks, "labels": stoks}, SSM_STEP_RUNS)
    row = {"phase": "p12c_ssm_train_step", "arch": scfg.name, "batch": SSM_STEP_B, "seq": SSM_STEP_S, "remat": True,
           "lr": d["lr"], "runs_ms": times, "median_ms": statistics.median(times), "losses": losses,
           "params": sum(t.numel() for t in flat_tensors(sparams)),
           "peak_gpu_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "power_limit": smi}
    log(json.dumps(row))
    if not (all(math.isfinite(x) for x in losses) and losses[1] < losses[0]):
        raise AssertionError(f"phase 12c: the Mamba2 loss did not fall or is not finite: {row}")
    del sparams
    torch.cuda.empty_cache()

    # one fp32 step of a 2-layer cut at full width, card against CPU
    c2 = two_layer_config(torch, cfg)
    p_cpu = decoder.init_params(c2, seed=0, device="cpu")
    t2 = torch.randint(0, c2.vocab_size, (2, d["seq"]), generator=torch.Generator().manual_seed(7))
    step = make_train_step(c2, lr=d["lr"], remat=False)
    l_gpu, n_gpu = step(map_tensors(p_cpu, lambda x: x.to(dev)), {"tokens": t2.to(dev), "labels": t2.to(dev)})
    l_cpu, n_cpu = step(p_cpu, {"tokens": t2, "labels": t2})
    a, b = decoder.flat_params(n_gpu), decoder.flat_params(n_cpu)
    param_err = max((a[k].cpu() - b[k]).abs().max().item() for k in b)
    moved = max((b[k] - x).abs().max().item() for k, x in decoder.flat_params(p_cpu).items())
    row = {"phase": "p12_gpu_vs_cpu_step", "layers": c2.num_layers, "dtype": "float32", "batch": 2, "seq": d["seq"],
           "loss_gpu": l_gpu.item(), "loss_cpu": l_cpu.item(),
           "loss_rel_err": abs(l_gpu.item() - l_cpu.item()) / abs(l_cpu.item()), "param_max_abs_err": param_err,
           "param_largest_move": moved, "limits": [TRAIN_LOSS_RTOL, TRAIN_PARAM_ATOL]}
    log(json.dumps(row))
    if row["loss_rel_err"] > TRAIN_LOSS_RTOL or param_err > TRAIN_PARAM_ATOL:
        raise AssertionError(f"phase 12: the GPU train step parts from the CPU's: {row}")
    return launches, rows


def token_clients(torch, vocab, clients, seqs, seq_len, seed=0):
    """LM clients' data as the simulator takes it: each client's token
    sequences (``make_token_dataset`` from ``seed``, on the CPU) as its
    'images', zero labels, client 0's sequences as the test set."""
    from repro_torch.data import make_token_dataset

    toks = make_token_dataset(torch.Generator().manual_seed(seed), clients, seqs, seq_len, vocab)["tokens"]
    return {"images": toks, "labels": torch.zeros(clients, seqs, dtype=torch.long), "test_images": toks[0],
            "test_labels": torch.zeros(seqs, dtype=torch.long)}


def counted_lm_run(torch, ops, sim, cfg, mcfg, data, dev):
    """``run_simulation`` with ``lm_backend(mcfg)`` on the card from random
    weights seed 0, the kernel counters set to 0 just before and read just
    after: per epoch exactly one vaoi_distance launch, the leaf table in
    runs of 32 leaves, and the probe's one swa_attention (ssd_scan) launch
    per attention (SSM) layer, on the tensor-core routes in bf16 and the
    FMA routes in fp32.  Returns (the run, its backend, the launches per
    epoch, the counts, their routes, wall seconds, peak GB)."""
    from repro_torch.fl import lm_backend
    from repro_torch.models import decoder

    params = decoder.flat_params(decoder.init_params(mcfg, seed=0, device=dev))
    kinds = [mcfg.layer_kind(i) for i in range(mcfg.num_layers)]
    per_epoch = {"vaoi_distance": 1, "fedavg_reduce": leaf_launches([(t.shape, t.dtype) for t in params.values()]),
                 "ssd_scan": kinds.count("ssm"), "swa_attention": kinds.count("attn"), "conv_lanes": 0,
                 "mla_attention": 0}
    backend = lm_backend(mcfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = sim.run_simulation(cfg, backend, data, params=params, device=dev)
    wall = time.perf_counter() - t0
    launches, routes = ops.launch_counts(), ops.route_launch_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    del params
    want = {k: v * cfg.epochs for k, v in per_epoch.items()}
    route = "launches_tc" if mcfg.dtype == torch.bfloat16 else "launches_fma"
    if launches != want or any(routes[k][route] != launches[k] for k in routes):
        raise AssertionError(f"{mcfg.name} under lm_backend: launches {launches} != {want}, or off the {route} "
                             f"routes ({routes})")
    m = out["metrics"]
    if not (all(torch.isfinite(v).all().item() for v in out["global_params"].values())
            and torch.isfinite(m["avg_m"]).all().item() and m["n_started"].sum().item() > 0):
        raise AssertionError(f"{mcfg.name} under lm_backend: non-finite params or avg_m, or nobody trained")
    return out, backend, per_epoch, launches, routes, wall, peak


def tree_lane(tree, i):
    return {k: tree_lane(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


def routed_dispatch_check(torch, mcfg, dev) -> dict:
    """13a's dispatch at published width in fp32: one MoE layer's params in
    two lanes (the second perturbed), each lane a client's step batch,
    through vmap against a per-lane loop and against the call the prefill
    step makes (inference mode, no vmap); see DISPATCH_Y_RTOL."""
    from torch.func import grad, vmap

    from repro_torch.core.draws import sgd_batch_size
    from repro_torch.models import moe

    c = dataclasses.replace(mcfg, dtype=torch.float32)
    g = torch.Generator(device=dev).manual_seed(8)
    p = moe.init_moe(g, c, torch.float32)
    lanes = {k: map_tensors(v, lambda t: t.unsqueeze(0).expand((2,) + t.shape).contiguous()) for k, v in p.items()}
    lanes["router"][1] += 0.1 * torch.randn(lanes["router"][1].shape, generator=g, device=dev) / math.sqrt(c.d_model)
    del p
    bs = sgd_batch_size(ROUTED_SIM["kappa"], ROUTED_SEQS)
    xs = torch.randn(2, bs, ROUTED_SEQ_LEN, c.d_model, generator=g, device=dev)

    def outputs(p, x):
        r = moe.route(c, p, x)
        return moe.apply_moe(c, p, x)[0], r.top_idx, r.keep

    def loss(p, x):
        y, aux = moe.apply_moe(c, p, x)
        return (y ** 2).mean() + aux

    y_b, idx_b, keep_b = vmap(outputs)(lanes, xs)
    g_b = vmap(grad(loss))(lanes, xs)
    row = {"phase": "p13a_dispatch", "dtype": "float32", "lanes": 2, "tokens_per_lane": bs * ROUTED_SEQ_LEN,
           "capacity_factor": c.capacity_factor, "y_rtol": DISPATCH_Y_RTOL, "grad_rtol": DISPATCH_GRAD_RTOL,
           "near_ties": 0, "routing_mismatches": 0, "dropped_choices": 0}
    y_err, g_err = {"loop": 0.0, "prefill": 0.0}, 0.0
    for i in range(2):
        lane = tree_lane(lanes, i)
        y_l, idx_l, keep_l = outputs(lane, xs[i])
        g_l = grad(loss)(lane, xs[i])
        with torch.inference_mode():
            r_p = moe.route(c, lane, xs[i])
            y_p, _ = moe.apply_moe(c, lane, xs[i])
        probs = torch.softmax(xs[i].reshape(bs, r_p.ng, r_p.G, c.d_model).float() @ lane["router"], dim=-1)
        top = torch.sort(probs, dim=-1, descending=True).values[..., : c.experts_per_token + 1]
        tie = (top[..., :-1] - top[..., 1:]).min(dim=-1).values < NEAR_TIE
        row["near_ties"] += int(tie.sum())
        for idx, keep in ((idx_l, keep_l), (r_p.top_idx, r_p.keep)):
            row["routing_mismatches"] += int(((idx != idx_b[i]) | (keep != keep_b[i])).any(dim=-1)[~tie].sum())
        row["dropped_choices"] += int((~keep_l).sum())
        scale = y_l.abs().max().item()
        y_err["loop"] = max(y_err["loop"], (y_b[i] - y_l).abs().max().item() / scale)
        y_err["prefill"] = max(y_err["prefill"], (y_p - y_l).abs().max().item() / scale)
        big = max(t.abs().max().item() for t in flat_tensors(g_l))
        g_err = max(g_err, max((a - b[i]).abs().max().item() for a, b in zip(flat_tensors(g_l), flat_tensors(g_b)))
                    / big)
    row.update(y_rel_err_vmap_vs_loop=y_err["loop"], y_rel_err_prefill_vs_loop=y_err["prefill"],
               grad_rel_err_vmap_vs_loop=g_err)
    log(json.dumps(row))
    if row["routing_mismatches"] or max(y_err.values()) > DISPATCH_Y_RTOL or g_err > DISPATCH_GRAD_RTOL:
        raise AssertionError(f"phase 13a: the dispatch under vmap parts from the per-lane loop or the prefill's: {row}")
    return row


def forced_local_sgd(torch, cfg, backend, params, images, labels, perms, dev) -> tuple:
    """The simulator's local SGD (``_local_train``'s steps, without the
    feature tap) for the clients of ``images`` on the card, each step also
    taken on the CPU from the card's weights of the step before: per step,
    the CPU step's largest distance from the card's and the card's largest
    update."""
    from torch.func import vmap

    from repro_torch.core.draws import sgd_batch_size
    from repro_torch.optim import sgd_update

    cpu = torch.device("cpu")
    b, n = images.shape[:2]
    bs = sgd_batch_size(cfg.kappa, n)
    rows = torch.arange(b, device=dev).unsqueeze(1)
    grad_fn = vmap(backend.grad_loss)
    p = {k: v.unsqueeze(0).expand((b,) + v.shape).contiguous() for k, v in params.items()}
    errs, moves = [], []
    for j in range(cfg.kappa):
        idx = perms[:, j * bs : (j + 1) * bs]
        imgs, lbls = images[rows, idx], labels[rows, idx]
        nxt = sgd_update(p, grad_fn(p, imgs, lbls)[1], cfg.lr)
        pc = to_device(p, cpu)
        nc = sgd_update(pc, grad_fn(pc, imgs.cpu(), lbls.cpu())[1], cfg.lr)
        del pc
        errs.append(max_abs(nc, nxt))
        moves.append(max_abs(nxt, p))
        del nc
        p = nxt
    return errs, moves


def routed_cpu_vs_gpu(torch, sim, mcfg, data, dev) -> dict:
    """One fp32 epoch of a 2-layer cut at published width on the card
    against the same epoch on the CPU (ROUTED_CHECK_SIM), from the same
    state and draws; the local SGD teacher-forced step by step where the
    free run parts (see ROUTED_PARAM_ATOL)."""
    from repro_torch.core.draws import TorchDraws
    from repro_torch.fl import lm_backend
    from repro_torch.models import decoder

    t0 = time.perf_counter()
    cpu = torch.device("cpu")
    c2 = dataclasses.replace(mcfg, num_layers=2, dtype=torch.float32)
    cfg = sim.EHFLConfig(**ROUTED_CHECK_SIM)
    n = cfg.num_clients
    d = {"images": data["images"][:n], "labels": data["labels"][:n], "test_images": data["test_images"],
         "test_labels": data["test_labels"]}
    dg, dc = sim.to_device_data(d, dev), sim.to_device_data(d, cpu)
    backend, draws = lm_backend(c2), TorchDraws(cfg.seed)
    params = decoder.flat_params(decoder.init_params(c2, seed=0, device=dev))
    carry = sim.init_carry(cfg, backend, dev, params=params, draws=draws)
    cin = to_device(carry, cpu)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    nxt, mg = sim.make_epoch_fn(cfg, backend, dg)(carry, 0, draws.epoch(0, cfg, ROUTED_SEQS, dev))
    torch.cuda.synchronize()
    gpu_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    out, mc = sim.make_epoch_fn(cfg, backend, dc)(cin, 0, draws.epoch(0, cfg, ROUTED_SEQS, cpu))
    cpu_s = time.perf_counter() - t1
    differ = [f for f in EXACT if not same_state(torch, getattr(nxt, f), getattr(out, f))]
    differ += [k for k in EXACT_METRICS if not torch.equal(mg[k].cpu(), mc[k])]
    row = {"phase": "p13a_gpu_vs_cpu_epoch", "layers": c2.num_layers, "dtype": "float32", "sim": ROUTED_CHECK_SIM,
           "params": sum(v.numel() for v in params.values()), "gpu_epoch_s": gpu_s, "cpu_epoch_s": cpu_s,
           "exact": list(EXACT + EXACT_METRICS), "differ": differ, "n_started": mg["n_started"].item(),
           "param_max_abs_err": max_abs(nxt.global_params, out.global_params), "h_max_abs_err": max_abs(nxt.h, out.h),
           "avg_m_abs_err": max_abs(mg["avg_m"], mc["avg_m"]), "param_atol": ROUTED_PARAM_ATOL}
    del nxt, out, cin, carry
    errs = []
    if row["param_max_abs_err"] > ROUTED_PARAM_ATOL:  # a routing flip: force the local SGD step by step
        perms = draws.epoch(0, cfg, ROUTED_SEQS, dev).perms[: cfg.k]
        errs, moves = forced_local_sgd(torch, cfg, backend, params, dg["images"][: cfg.k], dg["labels"][: cfg.k],
                                       perms, dev)
        row.update(step_max_abs_err=errs, step_max_abs_update=moves, step_atol=ROUTED_STEP_ATOL)
    row["s"] = time.perf_counter() - t0
    log(json.dumps(row))
    del params
    torch.cuda.empty_cache()
    if differ or row["n_started"] < 1 or (errs and max(errs) > ROUTED_STEP_ATOL):
        raise AssertionError(f"phase 13a: the card's fp32 epoch parts from the CPU's: {row}")
    return row


def phase_routed_ehfl(torch, dev, ops, ref, kern_fedavg, smi):
    """Phase 13: EHFL with routed LM clients.  13a deepseek-moe-16b at
    published width through ``run_simulation`` with ``lm_backend``, counted,
    timed and profiled, its EHFL kernels at its shapes, its dispatch held to
    a per-lane loop and the prefill's call, and a 2-layer fp32 epoch held to
    the CPU's; 13b llama4-scout and jamba at reduced() through the same
    entry point.  Returns 13a's launches, 13b's and 13a's kernel rows."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.core import simulator as sim
    from repro_torch.core.draws import TorchDraws, sgd_batch_size
    from repro_torch.models import decoder

    torch.cuda.empty_cache()
    seconds, t0 = {}, time.perf_counter()

    def lap(name):
        nonlocal t0
        seconds[name], t0 = time.perf_counter() - t0, time.perf_counter()

    mcfg = dataclasses.replace(get_config(ROUTED_ARCH), num_layers=ROUTED_DEPTH)
    cfg = sim.EHFLConfig(**ROUTED_SIM)
    data = token_clients(torch, mcfg.vocab_size, cfg.num_clients, ROUTED_SEQS, ROUTED_SEQ_LEN)
    out, backend, per_epoch, launches, routes, wall, peak = counted_lm_run(torch, ops, sim, cfg, mcfg, data, dev)
    lap("13a_run")
    m = out["metrics"]
    epoch_s, trained = m["epoch_s"].tolist(), m["n_started"].tolist()
    bs = sgd_batch_size(cfg.kappa, ROUTED_SEQS)
    tokens_per_client = cfg.kappa * bs * ROUTED_SEQ_LEN
    dg = sim.to_device_data(data, dev)
    gp = out["global_params"]
    probe_in = dg["images"][:, : cfg.probe_size]
    probe_ms = time_ms(lambda: backend.probe(gp, probe_in), iters=5, warmup=1)

    def train_forward():
        with torch.no_grad():
            toks = dg["images"][0, :bs].long()
            decoder.loss_fn(mcfg, decoder.nest_params(gp), {"tokens": toks, "labels": toks})

    drops = {"probe": drop_shares(moe_routings(lambda: backend.probe(gp, probe_in))),
             "train_batch": drop_shares(moe_routings(train_forward))}
    row = {
        "phase": "p13a_routed_ehfl", "arch": mcfg.name, "layers": mcfg.num_layers,
        "published_layers": get_config(ROUTED_ARCH).num_layers, "d_model": mcfg.d_model, "experts": mcfg.num_experts,
        "top_k": mcfg.experts_per_token, "shared_experts": mcfg.num_shared_experts, "vocab": mcfg.vocab_size,
        "dtype": str(mcfg.dtype), "params": sum(v.numel() for v in gp.values()), "leaves": len(gp),
        "sim": ROUTED_SIM, "seqs_per_client": ROUTED_SEQS, "seq_len": ROUTED_SEQ_LEN, "wall_s": wall,
        "epoch_s": epoch_s, "steady_epoch_s_median": statistics.median(epoch_s[1:]), "clients_trained": trained,
        "clients_trained_per_s": sum(trained[1:]) / sum(epoch_s[1:]),
        "tokens_trained_per_s": sum(trained[1:]) * tokens_per_client / sum(epoch_s[1:]),
        "probe_ms": probe_ms, "moe_drops": drops, "capacity_factor": mcfg.capacity_factor, "peak_gpu_mem_gb": peak,
        "launches": launches, "launches_per_epoch": per_epoch, "route_launches": routes,
        "avg_m": m["avg_m"].tolist(), "avg_age": m["avg_age"].tolist(), "f1": m["f1"].tolist(), "power_limit": smi,
    }
    log(json.dumps(row))
    t = cfg.epochs
    epoch_fn = sim.make_epoch_fn(cfg, backend, dg)
    draws = TorchDraws(cfg.seed)
    prof = profile_run(torch, lambda: epoch_fn(out["carry"], t, draws.epoch(t, cfg, ROUTED_SEQS, dev)), dev, "ehfl.",
                       no_concat=("ehfl.fedavg",))
    largest = sorted(prof["layers"].items(), key=lambda kv: kv[1]["host_ms"], reverse=True)
    log(json.dumps({"phase": "p13a_epoch_profile", "largest_ranges_by_host_ms": [
        {"range": k, "host_ms": v["host_ms"], "device_ms": v["device_ms"]} for k, v in largest[:6]], **prof}))
    feats = backend.probe(gp, probe_in)
    leaves = [(tuple(x.shape), x.dtype) for _, x in sorted(gp.items())]
    lap("13a_probe_drops_profile")
    del out, gp, m, epoch_fn
    torch.cuda.empty_cache()
    k, n = cfg.k, cfg.num_clients
    groups = [(k, torch.full((k,), 1.0 / k, device=dev)), (n, torch.zeros(n, device=dev))]
    rows = lm_kernel_rows(torch, ops, ref, kern_fedavg, feats, leaves, groups, cfg.mu, 9)
    for name, r in rows.items():
        log(json.dumps({"phase": "p13a_kernel_shape", "kernel": name, **r, "launches_per_epoch": per_epoch[name],
                        "power_limit": smi}))
    del feats, dg
    torch.cuda.empty_cache()
    lap("13a_kernel_rows")
    routed_dispatch_check(torch, mcfg, dev)
    torch.cuda.empty_cache()
    lap("13a_dispatch")
    routed_cpu_vs_gpu(torch, sim, mcfg, data, dev)
    lap("13a_gpu_vs_cpu")

    # 13b: llama4-scout and jamba at reduced() through the same entry point
    reduced_launches = {}
    for arch in ROUTED_REDUCED:
        rc = reduced(get_config(arch))
        rcfg = sim.EHFLConfig(**dict(ROUTED_SIM, epochs=1, eval_every=1))
        rdata = token_clients(torch, rc.vocab_size, rcfg.num_clients, ROUTED_SEQS, ROUTED_SEQ_LEN)
        rout, _, rper, rl, rroutes, rwall, rpeak = counted_lm_run(torch, ops, sim, rcfg, rc, rdata, dev)
        log(json.dumps({
            "phase": "p13b_routed_ehfl_reduced", "arch": arch, "layers": rc.num_layers, "d_model": rc.d_model,
            "layer_kinds": [rc.layer_kind(i) for i in range(rc.num_layers)], "dtype": str(rc.dtype),
            "epochs": rcfg.epochs, "wall_s": rwall, "clients_trained": rout["metrics"]["n_started"].tolist(),
            "launches": rl, "launches_per_epoch": rper, "route_launches": rroutes, "peak_gpu_mem_gb": rpeak,
            "avg_m": rout["metrics"]["avg_m"].tolist(), "power_limit": smi,
        }))
        reduced_launches[arch] = rl
        del rout
    lap("13b")
    log(json.dumps({"phase": "p13_seconds", **seconds}))
    return launches, reduced_launches, rows


def phase_drivers(torch, dev, ops, smi):
    """Phase 14: the drivers beside the package on the card.
    examples/quickstart_torch.py cut to QUICK_EPOCHS, then one cell of
    benchmarks/ehfl_grid_torch.py's quick protocol (DRIVER_CELL) with its
    cache in a temp directory; each counted (one vaoi_distance launch per
    epoch of a VAoI run, one leaf-table launch per epoch of every run) and
    timed.  Returns the launches of each."""
    import tempfile

    root = Path(__file__).resolve().parent
    sys.path[:0] = [str(root), str(root / "examples")]
    import quickstart_torch
    from benchmarks import ehfl_grid_torch as grid

    q = quickstart_torch
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    rows = q.main(["--device", str(dev), "--epochs", str(QUICK_EPOCHS), "--gallery-epochs", str(QUICK_GALLERY_EPOCHS)])
    quick_s = time.perf_counter() - t0
    q_launches = ops.launch_counts()
    gallery = len(q.GALLERY_SEEDS) * QUICK_GALLERY_EPOCHS * len(rows["scenarios"])
    want = {"vaoi_distance": QUICK_EPOCHS * ("vaoi" in [r["policy"] for r in rows["policies"]]) + gallery,
            "fedavg_reduce": QUICK_EPOCHS * len(rows["policies"]) + gallery, "ssd_scan": 0, "swa_attention": 0,
            "mla_attention": 0,
            "conv_lanes": sum(QUICK_EPOCHS * cnn_conv_launches(QUICK_KAPPA, r["policy"]) for r in rows["policies"])
            + gallery * cnn_conv_launches(QUICK_KAPPA, "vaoi")}
    f1s = [r["f1"] for r in rows["policies"]] + [r["f1_mean"] for r in rows["scenarios"]]
    log(json.dumps({"phase": "p14_quickstart", "epochs": QUICK_EPOCHS, "gallery_epochs": QUICK_GALLERY_EPOCHS,
                    "wall_s": quick_s, "rows": rows, "launches": q_launches,
                    "expected": want, "power_limit": smi}))
    if q_launches != want or not all(0.0 <= f <= 1.0 for f in f1s):
        raise AssertionError(f"phase 14: the quickstart launched {q_launches} (want {want}) or an f1 is out of range")

    st = grid.grid_settings(True)
    cache = grid.CACHE
    with tempfile.TemporaryDirectory() as tmp:
        grid.CACHE = Path(tmp)
        try:
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            rec = grid.run_cell(*DRIVER_CELL, st, device=dev)
            cell_s = time.perf_counter() - t0
            g_launches = ops.launch_counts()
            cached = [p.name for p in Path(tmp).iterdir()]
        finally:
            grid.CACHE = cache
    runs = len(st["seeds"]) * st["epochs"]
    want = {"vaoi_distance": runs, "fedavg_reduce": runs, "ssd_scan": 0, "swa_attention": 0,
            "mla_attention": 0,
            "conv_lanes": runs * cnn_conv_launches(QUICK_KAPPA, DRIVER_CELL[0])}
    log(json.dumps({"phase": "p14_grid_cell", "cell": DRIVER_CELL, "settings": st, "wall_s": cell_s,
                    "seeds_per_hour_at_T500": 3600.0 / (cell_s / runs * 500), "final_f1": rec["f1"][-1],
                    "f1_per_seed": [f[-1] for f in rec["f1_per_seed"]], "total_energy": rec["total_energy"],
                    "launches": g_launches, "expected": want, "cached": cached, "power_limit": smi}))
    if g_launches != want or len(cached) != 1 or not 0.0 <= rec["f1"][-1] <= 1.0:
        raise AssertionError(f"phase 14: the grid cell launched {g_launches} (want {want}), cached {cached}, or its "
                             f"f1 is out of range")
    return {"quickstart": q_launches, "grid_cell": g_launches}


def bench_row_launches(cfg, launches, row_groups) -> dict | None:
    """What one stream or channel row of the bench suite must launch: one
    vaoi_distance an epoch under a VAoI policy, one fedavg_reduce an epoch
    over two row groups when compacted (the slab and the old-carrier stack)
    or one when dense; the expectation, where the row missed it."""
    want = {"vaoi_distance": cfg.epochs * cfg.policy.startswith("vaoi"), "fedavg_reduce": cfg.epochs,
            "ssd_scan": 0, "swa_attention": 0, "mla_attention": 0,
            "conv_lanes": cfg.epochs * cnn_conv_launches(cfg.kappa, cfg.policy)}
    groups = cfg.epochs * (2 if cfg.compact == "auto" else 1)
    return None if launches == want and row_groups == groups else {"launches": want, "row_groups": groups}


def phase_bench_suite(torch, dev, ops, smi):
    """Phase 15: the bench suite on the card.  The BENCH_SUITES of
    benchmarks/run_torch.py at their quick protocols through its suite
    functions, their files written to a temp directory; each stream and
    channel row's launches counted (``bench_row_launches``); every file
    held to tools/check_bench.py's schema and the channel file to the
    stream file (``check_ideal_bitmatch``); then the fleet bench over
    BENCH_GLOO_RANKS gloo ranks on the card.  Returns the kernels suite's
    rows and the launches summed over the stream and channel rows."""
    import importlib.util
    import tempfile

    root = Path(__file__).resolve().parent
    if str(root) not in sys.path:
        sys.path.insert(0, str(root))
    from benchmarks import channel_bench_torch as channel_bench
    from benchmarks import fleet_bench_torch as fleet_bench
    from benchmarks import run_torch
    from benchmarks import stream_bench_torch as stream_bench

    spec = importlib.util.spec_from_file_location("check_bench", root / "tools" / "check_bench.py")
    check_bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(check_bench)

    counted, run_cell = [], stream_bench.run_cell

    def counted_cell(cfg, *args, **kw):
        ops.reset_launch_counts()
        out = run_cell(cfg, *args, **kw)
        counted.append((cfg, ops.launch_counts(), ops.row_group_count()))
        return out

    seconds, rows = {}, {}
    mods = {"stream": stream_bench, "channel": channel_bench, "fleet": fleet_bench}
    with tempfile.TemporaryDirectory(prefix="bench-suite-") as tmp:
        outs = {name: mod.OUT for name, mod in mods.items()}
        stream_bench.run_cell = counted_cell
        for name, mod in mods.items():
            mod.OUT = Path(tmp) / outs[name].name
        try:
            for name in BENCH_SUITES:
                t0 = time.perf_counter()
                rows[name] = run_torch.SUITES[name](True, dev)
                seconds[name] = time.perf_counter() - t0
                log(json.dumps({"phase": f"p15_{name}", "wall_s": seconds[name], "rows": rows[name],
                                "power_limit": smi}))
            docs = {name: json.loads(mod.OUT.read_text()) for name, mod in mods.items()}
            errors = []
            for name, mod in mods.items():
                check_bench.check_schema(mod.OUT, docs[name], errors)
        finally:
            stream_bench.run_cell = run_cell
            for name, mod in mods.items():
                mod.OUT = outs[name]
    for name, doc in docs.items():
        log(json.dumps({"phase": f"p15_{name}_file", "header": {k: v for k, v in doc.items() if k != "rows"},
                        "rows": doc["rows"]}))
    grid_rows = len(docs["stream"]["rows"]) + len(docs["channel"]["rows"])
    missed = [(dataclasses.asdict(cfg), n, g, want) for cfg, n, g in counted
              if (want := bench_row_launches(cfg, n, g))]
    errors += channel_bench.check_ideal_bitmatch(docs["stream"], docs["channel"])
    fleet_rows = docs["fleet"]["rows"]
    t0 = time.perf_counter()
    gloo_rows, _, ranks = fleet_bench.bench((BENCH_GLOO_N,), shards=BENCH_GLOO_RANKS, backend="gloo", device=dev)
    seconds["fleet_gloo"] = time.perf_counter() - t0
    totals = {k: sum(n[k] for _, n, _ in counted) for k in ops.launch_counts()}
    log(json.dumps({
        "phase": "p15_bench_suite", "suites": list(BENCH_SUITES), "suite_wall_s": seconds,
        "grid_rows": grid_rows, "counted_rows": len(counted), "rows_per_s": {
            name: len(docs[name]["rows"]) / seconds[name] for name in ("stream", "channel", "fleet")},
        "launches_stream_channel": totals, "rows_with_wrong_launches": missed,
        "fleet_nccl": {"dist_backend": docs["fleet"]["dist_backend"], "ranks": docs["fleet"]["ranks"],
                       "rows": fleet_rows},
        "fleet_gloo": {"ranks": ranks, "rows": gloo_rows}, "file_errors": errors, "power_limit": smi,
    }))
    if (errors or missed or len(counted) != grid_rows or docs["fleet"]["dist_backend"] != "nccl"
            or {r["shards"] for r in gloo_rows} != {BENCH_GLOO_RANKS} or len(gloo_rows) != 2):
        raise AssertionError(f"phase 15: file errors {errors}, rows with wrong launches {missed}, "
                             f"{len(counted)} counted rows of {grid_rows}, or the fleet rows are wrong")
    return rows["kernels"], totals


def phase_launch_layer(torch, dev, smi):
    """Phase 16: the launch layer (``LAUNCH_*``).  16a: the dry-run at full
    shape in a child process, its record printed and held (256 chips,
    per-device FLOPs near the model's share, collectives of every kind
    counted), then ``run_torch --only roofline``'s row for it.  16b: the
    DTensor train step on one NCCL rank against the plain step, and the
    (1, 1) dry-run's FLOPs over the plain step's time.  Returns the phase's
    summary row."""
    import datetime
    import os
    import socket
    import tempfile

    import torch.distributed as dist

    root = Path(__file__).resolve().parent
    if str(root) not in sys.path:
        sys.path.insert(0, str(root))
    from benchmarks import roofline_torch, run_torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.launch import dryrun, sharding
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import decoder

    # 16a: the production dry-run, in its own process (it starts a fake group)
    with tempfile.TemporaryDirectory(prefix="dryrun-") as tmp:
        rec_path = Path(tmp) / f"{LAUNCH_ARCH}__train_4k__sp__fsdp.json"
        env = dict(os.environ, PYTHONPATH=str(root / "src"))
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", LAUNCH_ARCH, "--shape",
                            "train_4k", "--out", str(rec_path)], capture_output=True, text=True, env=env,
                           timeout=LAUNCH_DRYRUN_TIMEOUT_S, cwd=root)
        child_s = time.perf_counter() - t0
        if r.returncode != 0:
            raise AssertionError(f"phase 16a: the dry-run failed: {r.stdout[-2000:]} {r.stderr[-3000:]}")
        rec = json.loads(rec_path.read_text())
        saved = roofline_torch.DRYRUN
        roofline_torch.DRYRUN = Path(tmp)
        try:
            roof = run_torch.SUITES["roofline"](True, dev)
        finally:
            roofline_torch.DRYRUN = saved
    coll = rec["collectives"]
    row_a = {"phase": "p16a_dryrun", "arch": LAUNCH_ARCH, "shape": "train_4k", "mesh": rec["mesh"],
             "n_chips": rec["n_chips"], "device_type": rec["device_type"], "tflop_per_device": rec["cost"]["flops"] / 1e12,
             "unfused_gb_per_device": rec["cost"]["unfused_bytes"] / 1e9,
             "collective_gb": {k: v / 1e9 for k, v in coll.items()}, "collective_counts": rec["collective_counts"],
             "roofline": rec["roofline"], "useful_flop_ratio": rec["useful_flop_ratio"],
             "model_flops_per_chip": rec["model_flops_per_chip"], "memory": rec["memory"], "lower_s": rec["lower_s"],
             "child_wall_s": child_s, "roofline_rows": roof}
    log(json.dumps(row_a))
    ratio = rec["useful_flop_ratio"]
    if (rec["n_chips"] != 256 or rec["device_type"] != "cuda" or not 0.5 <= ratio <= 1.0
            or coll["all-gather"] <= 0 or coll["reduce-scatter"] <= 0 or coll["all-reduce"] <= 0
            or len(roof) != 1 or roof[0]["name"] != f"roofline/{LAUNCH_ARCH}/train_4k/16x16/sp+fsdp"):
        raise AssertionError(f"phase 16a: the dry-run's record is off: {row_a}")

    # 16b: the DTensor step on one NCCL rank against the plain step
    from torch.distributed.tensor.experimental import implicit_replication

    cfg = get_config(LAUNCH_ARCH)
    with socket.socket() as sock:  # a free port for the rank's TCP store
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", world_size=1, rank=0,
                            timeout=datetime.timedelta(seconds=FLEET_TIMEOUT_S))
    try:
        mesh = make_host_mesh(1, device_type="cuda")
        params = decoder.init_params(cfg, seed=0, device=dev)
        gb = torch.Generator(device=dev).manual_seed(6)
        toks = torch.randint(0, cfg.vocab_size, (STEP_B, STEP_S), generator=gb, device=dev)
        batch = {"tokens": toks, "labels": toks}
        step = make_train_step(cfg, lr=TRAIN_ROUNDS["lr"], remat=True, ce_chunk=STEP_CHUNK)
        dparams = sharding.distribute_params(params, mesh)
        dbatch = sharding.distribute_inputs(batch, mesh)
        loss_p, new_p = step(params, batch)
        with implicit_replication():
            loss_d, new_d = step(dparams, dbatch)
            loss_d = loss_d.full_tensor()
            new_d = {k: v.full_tensor() for k, v in decoder.flat_params(new_d).items()}
        new_p = decoder.flat_params(new_p)
        leaf_gap, exact = {}, 0
        for k, v in new_p.items():
            diff = (new_d[k].float() - v.float()).abs().max().item()
            leaf_gap[k] = diff / max(v.float().abs().max().item(), 1e-30)
            exact += bool(torch.equal(new_d[k], v))
        loss_gap = abs(loss_d.item() - loss_p.item()) / abs(loss_p.item())
        del new_d, new_p
        _, plain_ms = train_step_timed(torch, step, params, batch, LAUNCH_RUNS)
        with implicit_replication():
            _, dtensor_ms = train_step_timed(torch, step, dparams, dbatch, LAUNCH_RUNS)
        flops = dryrun.trace_step(cfg, InputShape("train", STEP_S, STEP_B, "train"), mesh, ce_chunk=STEP_CHUNK)[0]
    finally:
        dist.destroy_process_group()
    worst = max(leaf_gap, key=leaf_gap.get)
    top = sorted(leaf_gap.items(), key=lambda kv: -kv[1])[:6]
    plain_med, dt_med = statistics.median(plain_ms), statistics.median(dtensor_ms)
    row_b = {"phase": "p16b_dtensor_step", "arch": LAUNCH_ARCH, "mesh": "1x1", "batch": STEP_B, "seq": STEP_S,
             "ce_chunk": STEP_CHUNK, "loss_plain": loss_p.item(), "loss_dtensor": loss_d.item(),
             "loss_rel_gap": loss_gap, "loss_limit": LAUNCH_LOSS_RTOL, "leaves": len(leaf_gap),
             "leaves_bit_equal": exact, "worst_leaf": worst, "worst_leaf_rel_gap": leaf_gap[worst], "worst_leaves": top,
             "leaf_limit": LAUNCH_LEAF_RTOL, "plain_ms": plain_ms, "dtensor_ms": dtensor_ms,
             "plain_median_ms": plain_med, "dtensor_median_ms": dt_med, "dtensor_host_cost_ms": dt_med - plain_med,
             "dryrun_flops_1x1": flops["flops"], "dryrun_lower_s": flops["lower_s"],
             "bf16_peak_share": flops["flops"] / (plain_med / 1e3) / BF16_FLOPS, "power_limit": smi}
    log(json.dumps(row_b))
    if not (math.isfinite(row_b["loss_dtensor"]) and loss_gap <= LAUNCH_LOSS_RTOL
            and leaf_gap[worst] <= LAUNCH_LEAF_RTOL and flops["flops"] > 0):
        raise AssertionError(f"phase 16b: the DTensor step parts from the plain step: {row_b}")
    return {"dryrun": row_a, "dtensor_step": row_b}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--epochs", type=int, default=10, help="depth T of the paper-width run (paper: 500)")
    args = ap.parse_args()

    start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from repro_torch.configs import CONFIG
    from repro_torch.core.draws import TorchDraws
    from repro_torch.core import fleet
    from repro_torch.core import simulator as sim
    from repro_torch.data import make_federated_dataset
    from repro_torch.fl import cnn_backend
    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels.fedavg_reduce import fedavg_reduce as kern_fedavg
    from repro_torch.kernels.fedavg_reduce import fedavg_reduce_leaves as kern_leaves
    from repro_torch.kernels.ssd_scan import ssd_scan as kern_ssd
    from repro_torch.kernels.swa_attention import swa_attention as kern_swa
    from repro_torch.kernels.vaoi_distance import launch_floor as vaoi_floor
    from repro_torch.kernels.vaoi_distance import vaoi_distance as kern_vaoi

    # --- phase 1: device ---
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(smi)
    kind = torch.cuda.get_device_name(0)
    log(f"device: {kind}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log("TF32 off: torch.backends.cudnn.allow_tf32 = False, torch.backends.cuda.matmul.allow_tf32 = False")
    dev = torch.device("cuda")

    # --- phase 2: build ---
    seconds = {}  # each phase's wall seconds
    t0 = time.perf_counter()
    build.build(verbose=True)
    log(f"build: {time.perf_counter() - t0:.2f} s for {list(build.KERNELS)}")
    for r in build.ptxas_report("mla_attention"):
        log(json.dumps({"phase": "ptxas", "kernel": "mla_attention", **r}))
    # the bf16 tensor-core instances the prefills run must not spill
    for name, prefill_instance in (("ssd_scan", "ssd_tc_kernelILi2E"), ("swa_attention", "swa_tc_kernelILi128E")):
        report = build.ptxas_report(name)
        for r in report:
            log(json.dumps({"phase": "ptxas", "kernel": name, **r}))
        tc = [r for r in report if prefill_instance in r["function"]]
        if len(tc) != 1 or tc[0]["spill_stores"] or tc[0]["spill_loads"]:
            raise AssertionError(f"{name}'s bf16 tensor-core instance {prefill_instance} is missing or spills: {tc}")
    seconds["2"] = time.perf_counter() - t0

    # --- phase 3: kernels against their plain versions ---
    t0 = time.perf_counter()
    kresults = phase_kernels(torch, ref, kern_vaoi, vaoi_floor, kern_fedavg, kern_leaves, dev)
    kresults["ssd_scan"] = [phase_ssd_kernel(torch, ref, kern_ssd, dev)]
    kresults["swa_attention"] = [phase_swa_kernel(torch, ref, kern_swa, dev)]
    kresults["mla_attention"] = phase_mla_attention(torch, ref, dev)
    conv_passes = phase_conv_lanes(torch, ref, dev)
    kresults["conv_lanes"] = conv_passes[CONV_LANES[0]]
    zoo_rows = phase_zoo_kernels(torch, ref, kern_swa, kern_ssd, dev)
    seconds["3"] = time.perf_counter() - t0

    # --- phase 4: the slice on the card ---
    T = args.epochs
    cfg = sim.EHFLConfig(
        num_clients=100, epochs=T, slots_per_epoch=30, kappa=20, p_bc=0.1, k=10, mu=0.5,
        lr=0.01, probe_size=20, e_max=25, policy="vaoi", eval_every=T, seed=0,
    )
    backend = cnn_backend(CONFIG)
    data = make_federated_dataset(0, num_clients=100, samples_per_client=300, test_size=500, device="cpu")
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    gpu = sim.run_simulation(cfg, backend, data, draws=TorchDraws(seed=0), device=dev)
    gpu_s = time.perf_counter() - t0
    launches, row_groups, conv_dirs = ops.launch_counts(), ops.row_group_count(), conv_direction_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want = {"vaoi_distance": T, "fedavg_reduce": T, "ssd_scan": 0, "swa_attention": 0, "mla_attention": 0,
            "conv_lanes": T * cnn_conv_launches(cfg.kappa, cfg.policy)}
    want_dirs = {k: T * v for k, v in cnn_conv_directions(cfg.kappa, cfg.policy).items()}
    log(json.dumps({"phase": "slice_gpu", "launches": launches, "expected": want, "fedavg_row_groups": row_groups,
                    "expected_fedavg_row_groups": 2 * T, "conv_lanes_directions": conv_dirs,
                    "expected_conv_lanes_directions": want_dirs}))
    if launches != want or row_groups != 2 * T or conv_dirs != want_dirs:
        raise AssertionError(f"kernel launches {launches} != {want}, fedavg_reduce row groups {row_groups} != "
                             f"{2 * T} or conv_lanes directions {conv_dirs} != {want_dirs} on the main path")
    gm = gpu["metrics"]
    for t in range(T):
        log(json.dumps({
            "epoch": t, "epoch_s": gm["epoch_s"][t].item(), "avg_age": gm["avg_age"][t].item(),
            "n_started": gm["n_started"][t].item(), "n_uploaded": gm["n_uploaded"][t].item(),
            "energy": gm["energy"][t].item(), "avg_m": gm["avg_m"][t].item(),
        }))
    f1 = gm["f1"][-1].item()
    steady = statistics.median(gm["epoch_s"][1:].tolist()) if T > 1 else gm["epoch_s"][0].item()
    params_ok = all(torch.isfinite(v).all().item() for v in gpu["global_params"].values())
    if not (params_ok and 0.0 <= f1 <= 1.0):
        raise AssertionError(f"non-finite params or f1 out of range on the GPU: f1={f1}")
    log(json.dumps({
        "phase": "slice_gpu_summary", "epochs": T, "wall_s": gpu_s, "f1": f1,
        "steady_epoch_s_median": steady, "first_epoch_s": gm["epoch_s"][0].item(),
        "started_clients_per_s": gm["n_started"].sum().item() / gm["epoch_s"].sum().item(),
        "slab_lanes_per_s": 10 * T / gm["epoch_s"].sum().item(),
        "peak_gpu_mem_gb": peak_gb, "power_limit": smi,
    }))

    seconds["4"] = gpu_s

    # --- phase 5: the same run on the CPU, epoch by epoch from shared state ---
    t0 = time.perf_counter()
    cmp = phase_cpu_vs_gpu(torch, sim, cfg, backend, data, TorchDraws, dev, gm)
    log(json.dumps(cmp))
    seconds["5"] = time.perf_counter() - t0

    # --- phase 6: the serving slice, mamba2-1.3b at full width ---
    t0 = time.perf_counter()
    serve_launches, serve_routes = phase_lm_serving(torch, dev, ops, smi, ServeSpec(
        "mamba2-1.3b", "", PREFILL_B, PREFILL_P, {"ssd_scan": 48}, plain_runs=3))

    seconds["6"] = time.perf_counter() - t0

    # --- phase 7: the attention slice, starcoder2-3b at full width ---
    t0 = time.perf_counter()
    sc_launches, sc_routes = phase_lm_serving(torch, dev, ops, smi, ServeSpec(
        "starcoder2-3b", "sc_", SC_PREFILL_B, SC_PREFILL_P, {"swa_attention": 30}))
    phase_rolling_wrap(torch, dev)
    seconds["7"] = time.perf_counter() - t0

    # --- phase 11: the rest of the zoo at published width ---
    t0 = time.perf_counter()
    zoo_launches = {spec.arch: phase_lm_serving(torch, dev, ops, smi, spec)[0] for spec in ZOO}
    seconds["11"] = time.perf_counter() - t0

    # --- phase 12: LM training at full width ---
    t0 = time.perf_counter()
    train_launches, train_rows = phase_lm_training(torch, dev, ops, ref, kern_fedavg, smi)
    seconds["12"] = time.perf_counter() - t0

    # --- phase 13: EHFL with routed LM clients ---
    t0 = time.perf_counter()
    routed_launches, routed_reduced_launches, routed_rows = phase_routed_ehfl(torch, dev, ops, ref, kern_fedavg, smi)
    seconds["13"] = time.perf_counter() - t0

    # --- phase 14: the drivers beside the package ---
    t0 = time.perf_counter()
    driver_launches = phase_drivers(torch, dev, ops, smi)
    seconds["14"] = time.perf_counter() - t0

    # --- phase 9a: the scenario axes at paper width ---
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    scenario_launches = phase_scenarios(torch, sim, cfg, backend, data, TorchDraws, ops, dev, smi)
    seconds["9a"] = time.perf_counter() - t0

    # --- phase 9b: run_batch at paper width ---
    t0 = time.perf_counter()
    batch_launches = phase_run_batch(torch, sim, cfg, backend, data, ops, dev, smi, gpu_s)
    seconds["9b"] = time.perf_counter() - t0

    # --- phase 10: the client-sharded fleet ---
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    fleet_launches = {"10a": phase_fleet_nccl(torch, sim, fleet, cfg, backend, data, TorchDraws, ops, dev, smi, steady)}
    fleet_launches.update(phase_fleet_gloo(torch, sim, fleet, cfg, backend, data, TorchDraws, ops, dev, smi,
                                           make_federated_dataset))
    seconds["10"] = time.perf_counter() - t0

    # --- phase 15: the bench suite ---
    t0 = time.perf_counter()
    bench_kernel_rows, bench_launches = phase_bench_suite(torch, dev, ops, smi)
    seconds["15"] = time.perf_counter() - t0

    # --- phase 16: the launch layer ---
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    phase_launch_layer(torch, dev, smi)
    seconds["16"] = time.perf_counter() - t0

    # --- phase 8: every ported kernel, then the result ---
    def entry(name, source, replaces, rows, count):
        out = {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": count[name],
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            # per pass of the main path: the sum over the kernel's calls
            "ms": sum(r["ms"] for r in rows), "plain_ms": sum(r["plain_ms"] for r in rows),
            "bound_ms": sum(r["bound_ms"] for r in rows), "bound_by": rows[0]["bound_by"],
            "library_ms": None if rows[0]["library_ms"] is None else sum(r["library_ms"] for r in rows),
            "calls_per_pass": len(rows), "shapes": [r["shape"] for r in rows],
        }
        if "device_ms" in rows[0]:  # the kernels' own time, without the wrapper's host time
            out.update(device_ms=sum(r["device_ms"] for r in rows),
                       library_device_ms=sum(r["library_device_ms"] for r in rows))
        return out

    ssd = entry("ssd_scan", "src/repro_torch/csrc/ssd_scan.cu", "src/repro/kernels/ssd_scan.py:73",
                kresults["ssd_scan"], serve_launches)
    ssd_row = kresults["ssd_scan"][0]
    ssd.update(launches_per_prefill=serve_launches["ssd_scan"] // PREFILL_RUNS, route_launches=serve_routes["ssd_scan"],
               bf16_bound_share=ssd_row["bf16_bound_share"], fp32_route_ms=ssd_row["fp32_route_ms"],
               bound_fp32_route_ms=ssd_row["bound_fp32_route_ms"])
    swa = entry("swa_attention", "src/repro_torch/csrc/swa_attention.cu", "src/repro/kernels/swa_attention.py:79",
                kresults["swa_attention"], sc_launches)
    swa_row = kresults["swa_attention"][0]
    swa.update(launches_per_prefill=sc_launches["swa_attention"] // PREFILL_RUNS,
               route_launches=sc_routes["swa_attention"],
               bf16_bound_share=swa_row["bf16_bound_share"], fp32_route_ms=swa_row["fp32_route_ms"],
               bound_fp32_route_ms=swa_row["bound_fp32_route_ms"])
    for e in (ssd, swa):  # phases 11, 12 and 13: their launches, and phase 3's rows at their shapes
        e.update(launches_phase11={arch: n[e["name"]] for arch, n in zoo_launches.items() if n[e["name"]]},
                 phase11_shapes=[r for r in zoo_rows[e["name"]]
                                 if r["arch"] not in TRAIN_SWA_SHAPES and r["arch"] not in ROUTED_SWA_SHAPES],
                 launches_phase12=train_launches[e["name"]],
                 phase12_shapes=[r for r in zoo_rows[e["name"]] if r["arch"] in TRAIN_SWA_SHAPES],
                 phase13_shapes=[r for r in zoo_rows[e["name"]] if r["arch"] in ROUTED_SWA_SHAPES])
    def driver_launches_of(name):
        return {k: v[name] for k, v in driver_launches.items()}

    ehfl = [
        entry("vaoi_distance", "src/repro_torch/csrc/vaoi_distance.cu",
              "src/repro/kernels/vaoi_distance.py:49", kresults["vaoi_distance"], launches),
        entry("fedavg_reduce", "src/repro_torch/csrc/fedavg_reduce.cu",
              "src/repro/kernels/fedavg_reduce.py:36", kresults["fedavg_reduce"], launches),
    ]
    # per pass: one SGD step of a 100-lane slab (the six layers' three directions); the
    # directions' launches are phase 4's, each as cnn_conv_directions predicts
    conv = entry("conv_lanes", "src/repro_torch/csrc/conv_lanes.cu",
                 "none (the JAX package leaves its convolutions to XLA)", kresults["conv_lanes"], launches)
    conv.update(route_launches=conv_dirs,
                step_by_lanes={L: {k: sum(r[k] for r in rows) for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
                               for L, rows in conv_passes.items()},
                launches_scenarios=[c["conv_lanes"] for c in scenario_launches],
                launches_run_batch=batch_launches["conv_lanes"], launches_phase14=driver_launches_of("conv_lanes"),
                launches_phase15=bench_launches["conv_lanes"],
                launches_fleet={k: [c["conv_lanes"] for c in v] if isinstance(v, list) else v["conv_lanes"]
                                for k, v in fleet_launches.items()})
    for e in ehfl:  # the launches of phase 9a's runs, 9b's batch, phase 10's fleets (per rank) and phase 12
        e.update(launches_phase12=train_launches[e["name"]], phase12_shape=train_rows[e["name"]],
                 phase13_shape=routed_rows[e["name"]], launches_phase14=driver_launches_of(e["name"]),
                 launches_scenarios=[c[e["name"]] for c in scenario_launches],
                 launches_run_batch=batch_launches[e["name"]],
                 launches_fleet={k: [c[e["name"]] for c in v] if isinstance(v, list) else v[e["name"]]
                                 for k, v in fleet_launches.items()})
    vaoi_row, leaf_row = kresults["vaoi_distance"][0], kresults["fedavg_reduce"][0]
    ehfl[0].update(design=vaoi_row["design"], **{k: vaoi_row[k] for k in (
        "launch_floor_ms", "launch_floor_device_ms", "bound_with_launch_floor_ms", "device_over_launch_floor",
        "host_clock_ms")})
    ehfl[0]["wide_rows"] = [{k: r[k] for k in (
        "shape", "plan", "max_abs_err", "ms", "device_ms", "launch_floor_ms", "launch_floor_device_ms", "bound_ms",
        "device_bound_share", "plain_ms", "library_ms", "library_device_ms")} for r in kresults["vaoi_distance_wide"]]
    ehfl[0]["fleet_shard"] = {k: kresults["vaoi_distance_shard"][k] for k in (
        "shape", "max_abs_err", "ms", "device_ms", "launch_floor_ms", "launch_floor_device_ms", "bound_ms",
        "bound_with_launch_floor_ms", "plain_ms", "library_ms", "library_device_ms")}
    ehfl[1].update(row_groups=row_groups, role=leaf_row["role"], library=leaf_row["library"],
                   plain_device_ms=leaf_row["plain_device_ms"], device_bound_share=leaf_row["device_bound_share"],
                   single_matrix=leaf_row["single_matrix"])
    for e in (*ehfl, ssd, swa):  # phase 13: 13a at published width, 13b at reduced() per arch
        e.update(launches_phase13=routed_launches[e["name"]],
                 launches_phase13b={arch: n[e["name"]] for arch, n in routed_reduced_launches.items()})
    for e in (*ehfl, ssd, swa):  # phase 15: the kernels bench's rows, the stream and channel rows' launches
        e.update(phase15_bench_rows=[r for r in bench_kernel_rows if r["name"].startswith(f"kernel/{e['name']}/")],
                 launches_phase15=bench_launches[e["name"]])
    mla = entry("mla_attention", "src/repro_torch/csrc/mla_attention.cu", "none (the JAX package has no MLA)",
                kresults["mla_attention"], launches)
    mla.update(rows=kresults["mla_attention"], cell_epoch_launches=MLA_CELL_LAUNCHES)
    log(json.dumps({"phase_seconds": seconds, "total_s": time.perf_counter() - start}))
    log(json.dumps({"kernels": [
        *ehfl,
        conv,
        mla,
        ssd,
        swa,
    ]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
