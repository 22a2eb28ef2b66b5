#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--epochs T]

Phases, each of which must pass (any failure exits non-zero and prints no
result line):

1. Device: the card's name and power limit as nvidia-smi reports them.
2. Build: both Hopper kernels from ``src/repro_torch/csrc`` with nvcc (sm_90a).
3. Kernels against their plain PyTorch versions on the card, at the main
   path's shapes (timed with CUDA events) and over a ragged fp32/bf16 sweep.
4. The slice: ``run_simulation`` at the paper's width (the 845,738-parameter
   CNN, N=100 clients x 300 samples, k=10, S=30, kappa=20, a 500-image test
   set) for T epochs on the GPU, with ``TorchDraws(seed=0)``.  Only the depth
   T is cut (the paper runs 500 epochs).  The kernel launch counters must
   read T for vaoi_distance and 2T for fedavg_reduce.
5. The same run on the CPU (plain versions, same data, init and draws):
   integer dynamics, ages and selections equal exactly; params and f1
   within the stated fp32 tolerances.
6. One JSON line listing every ported kernel, then the result line.

TF32 is switched off for cuDNN convolutions and matmuls, so the GPU run
computes in full fp32 like the CPU run it is compared with.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

# H100 SXM published peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12

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


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int = 25, warmup: int = 5) -> float:
    """Median device time of ``fn`` over ``iters`` runs, after ``warmup``."""
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
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def phase_kernels(torch, ref, kern_vaoi, kern_fedavg, dev):
    """Phase 3.  Returns per-kernel main-path numbers for the final line."""
    g = torch.Generator().manual_seed(0)
    results = {}

    # --- vaoi_distance at the main path's (N, F) = (100, 10) ---
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
    row = {
        "kernel": "vaoi_distance", "shape": [n, f], "dtype": "float32", "max_abs_err": err, "tol": 1e-5,
        "ms": time_ms(lambda: kern_vaoi(v, h, age, q, 0.5)),
        "plain_ms": time_ms(lambda: ref.vaoi_distance_ref(v, h, age, q, 0.5)),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": time_ms(lambda: torch.linalg.vector_norm(v - h, dim=1)),
    }
    log(json.dumps(row))
    results["vaoi_distance"] = [row]

    # --- fedavg_reduce: the k-slab (10, P) and the old-carrier pass (100, P) ---
    p = 845_738
    results["fedavg_reduce"] = []
    for k, role in ((10, "slab"), (100, "old_carrier")):
        msgs = torch.randn(k, p, generator=g).to(dev)
        w = (torch.rand(k, generator=g) < (0.5 if role == "slab" else 0.05)).float().to(dev)
        out_k = kern_fedavg(msgs, w)
        out_r = ref.fedavg_reduce_ref(msgs, w)
        err = (out_k - out_r).abs().max().item()
        if not err <= 1e-5:
            raise AssertionError(f"fedavg_reduce ({k}, {p}) disagrees with its plain version: {err}")
        b_ms, b_by = bound(k * p * 4 + k * 4 + p * 4, 2 * k * p)
        row = {
            "kernel": "fedavg_reduce", "role": role, "shape": [k, p], "dtype": "float32",
            "max_abs_err": err, "tol": 1e-5,
            "ms": time_ms(lambda: kern_fedavg(msgs, w)),
            "plain_ms": time_ms(lambda: ref.fedavg_reduce_ref(msgs, w)),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": time_ms(lambda: torch.mv(msgs.T, w)),
        }
        log(json.dumps(row))
        results["fedavg_reduce"].append(row)
        del msgs, out_k, out_r

    # --- ragged fp32/bf16 sweep (tests/test_kernels.py's shapes and tolerances) ---
    n_checked = 0
    for dtype, tv, tf in ((torch.float32, 1e-5, 1e-5), (torch.bfloat16, 0.2, 0.05)):
        for n, f in ((10, 10), (100, 10), (128, 512), (257, 300), (33, 1025), (100, 130), (10, 700), (5, 1025)):
            v = torch.randn(n, f, generator=g).to(dtype).to(dev)
            h = torch.randn(n, f, generator=g).to(dtype).to(dev)
            age = torch.randint(0, 9, (n,), generator=g).float().to(dev)
            q = (torch.rand(n, generator=g) < 0.4).float().to(dev)
            got, want = kern_vaoi(v, h, age, q, 0.7), ref.vaoi_distance_ref(v, h, age, q, 0.7)
            for a, b in zip(got, want):
                torch.testing.assert_close(a, b, rtol=tv, atol=tv)
            n_checked += 1
        for k, p in ((1, 128), (10, 1000), (100, 4096), (7, 333), (64, 2048), (5, 77), (13, 100), (3, 2049), (65, 5)):
            msgs = torch.randn(k, p, generator=g).to(dtype).to(dev)
            w = torch.rand(k, generator=g)
            w = (w / w.sum()).to(dev)
            torch.testing.assert_close(kern_fedavg(msgs, w), ref.fedavg_reduce_ref(msgs, w), rtol=tf, atol=tf)
            n_checked += 1
    torch.cuda.synchronize()
    log(json.dumps({"phase": "kernel_sweep", "cases": n_checked, "ok": True}))
    return results


def to_device(tree, device):
    """An EpochCarry (or dict of tensors) copied to ``device``."""
    if isinstance(tree, dict):
        return {k: v.to(device) for k, v in tree.items()}
    return tree._replace(**{
        f: to_device(x, device) if isinstance(x, dict) else x.to(device)
        for f, x in tree._asdict().items() if x is not None
    })


def max_abs(a, b) -> float:
    if isinstance(a, dict):
        return max(max_abs(a[k], b[k]) for k in a)
    return (a.cpu().double() - b.cpu().double()).abs().max().item()


def phase_cpu_vs_gpu(torch, sim, cfg, backend, data, TorchDraws, dev, phase4_metrics):
    """Phase 5.  Drive the phase-4 run again on the GPU; before each GPU
    epoch, copy its input state to the CPU and run the same epoch there with
    the plain versions and the same draws.  Integer state, ages and
    selections must be equal; params, h and M within the stated tolerances.
    One GPU epoch near the end runs under torch.profiler."""
    from repro_torch.models.cnn import macro_f1

    cpu = torch.device("cpu")
    dg, dc = sim.to_device_data(data, dev), sim.to_device_data(data, cpu)
    epoch_gpu, epoch_cpu = sim.make_epoch_fn(cfg, backend, dg), sim.make_epoch_fn(cfg, backend, dc)
    draws, n_samples = TorchDraws(seed=0), dg["images"].shape[1]
    carry = sim.init_carry(cfg, backend, dev)
    worst = {"params": 0.0, "h": 0.0, "avg_m": 0.0, "avg_age": 0.0}
    redrive = []
    cpu_s = 0.0
    profile = None
    for t in range(cfg.epochs):
        cin = to_device(carry, cpu)
        if t == cfg.epochs - 1:
            profile = profile_epoch(torch, lambda: epoch_gpu(carry, t, draws.epoch(t, cfg, n_samples, dev)), dev)
        nxt, mg = epoch_gpu(carry, t, draws.epoch(t, cfg, n_samples, dev))
        t0 = time.perf_counter()
        out, mc = epoch_cpu(cin, t, draws.epoch(t, cfg, n_samples, cpu))
        cpu_s += time.perf_counter() - t0
        for f in EXACT:
            if not torch.equal(getattr(nxt, f).cpu(), getattr(out, f)):
                raise AssertionError(f"epoch {t}: GPU and CPU differ in {f}")
        for k in EXACT_METRICS:
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
    sensitivity = sgd_sensitivity(torch, sim, cfg, backend, dg, draws, dev)
    # the GPU run is not bitwise repeatable (cuDNN's backward passes sum with
    # atomics), so this is reported, not required
    same_as_phase4 = all(
        torch.equal(torch.stack([m[k] for m in redrive]).cpu(), phase4_metrics[k].cpu()) for k in EXACT_METRICS
    )
    return {
        "phase": "slice_cpu_vs_gpu", "epochs": cfg.epochs, "cpu_epoch_s_mean": cpu_s / cfg.epochs,
        "exact": list(EXACT + EXACT_METRICS), "max_abs_err": worst,
        "atol": {"params": PARAM_ATOL, "h": PARAM_ATOL, "avg_m": M_ATOL, "avg_age": AGE_MEAN_ATOL, "f1": F1_ATOL},
        "f1_gpu": f1_gpu, "f1_cpu": f1_cpu, "redrive_matches_phase4": same_as_phase4,
        "sgd_sensitivity": sensitivity, "profile": profile,
    }


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


def profile_epoch(torch, run_epoch, dev):
    """One epoch under torch.profiler: its wall time, the device's busy time
    (the CUDA kernels' time summed), each ``ehfl.*`` layer's host time and
    the device time of the kernels it launched, and the top kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_epoch()
        torch.cuda.synchronize(dev)
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA and not e.name.startswith("ehfl.")]
    layers = {}
    for e in events:
        if e.device_type == DeviceType.CPU and e.name.startswith("ehfl."):
            row = layers.setdefault(e.name, {"host_ms": 0.0, "device_ms": 0.0, "calls": 0})
            row["host_ms"] += e.cpu_time_total / 1e3
            row["device_ms"] += e.device_time_total / 1e3
            row["calls"] += 1
    by_name = {}
    for e in kernels:
        row = by_name.setdefault(e.name[:80], {"name": e.name[:80], "device_ms": 0.0, "calls": 0})
        row["device_ms"] += e.time_range.elapsed_us() / 1e3
        row["calls"] += 1
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    return {
        "wall_ms": wall_ms, "device_busy_ms": busy_ms, "device_idle_share": 1.0 - busy_ms / wall_ms,
        "kernel_launches": len(kernels), "layers": layers,
        "top": sorted(by_name.values(), key=lambda r: r["device_ms"], reverse=True)[:10],
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--epochs", type=int, default=10, help="depth T of the paper-width run (paper: 500)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.configs import CONFIG
    from repro_torch.core.draws import TorchDraws
    from repro_torch.core import simulator as sim
    from repro_torch.data import make_federated_dataset
    from repro_torch.fl import cnn_backend
    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels.fedavg_reduce import fedavg_reduce as kern_fedavg
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
    t0 = time.perf_counter()
    build.build(verbose=True)
    log(f"build: {time.perf_counter() - t0:.2f} s for {list(build.KERNELS)}")

    # --- phase 3: kernels against their plain versions ---
    kresults = phase_kernels(torch, ref, kern_vaoi, kern_fedavg, dev)

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
    launches = ops.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want = {"vaoi_distance": T, "fedavg_reduce": 2 * T}
    log(json.dumps({"phase": "slice_gpu", "launches": launches, "expected": want}))
    if launches != want:
        raise AssertionError(f"kernel launches {launches} != {want} on the main path")
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

    # --- phase 5: the same run on the CPU, epoch by epoch from shared state ---
    cmp = phase_cpu_vs_gpu(torch, sim, cfg, backend, data, TorchDraws, dev, gm)
    log(json.dumps(cmp))

    # --- phase 6: every ported kernel, then the result ---
    def entry(name, source, replaces, rows):
        return {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            # per epoch of the main path: the sum over the kernel's calls
            "ms": sum(r["ms"] for r in rows), "plain_ms": sum(r["plain_ms"] for r in rows),
            "bound_ms": sum(r["bound_ms"] for r in rows), "bound_by": rows[0]["bound_by"],
            "library_ms": sum(r["library_ms"] for r in rows),
            "calls_per_epoch": len(rows), "shapes": [r["shape"] for r in rows],
        }

    log(json.dumps({"kernels": [
        entry("vaoi_distance", "src/repro_torch/csrc/vaoi_distance.cu",
              "src/repro/kernels/vaoi_distance.py:49", kresults["vaoi_distance"]),
        entry("fedavg_reduce", "src/repro_torch/csrc/fedavg_reduce.cu",
              "src/repro/kernels/fedavg_reduce.py:36", kresults["fedavg_reduce"]),
    ]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
