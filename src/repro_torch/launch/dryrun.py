"""The dry-run: lay every (architecture x input shape) out over a
production mesh of H100s by the sharding rules, trace one step, and record
its per-device cost and collectives for the roofline.  The port of
``repro.launch.dryrun``.

The reference lowers and compiles on 512 placeholder CPU devices and reads
XLA's post-SPMD analyses.  Here a ``fake`` process group of 256 (or 512)
ranks stands for the cluster: the params and inputs are DTensors on a
``DeviceMesh`` over it, their local shards are fake tensors (shapes and
dtypes, no data: nothing is allocated on any device), and the step runs
once as rank 0 runs it, under ``cost_analysis.StepCost``.  The fake
tensors carry device type ``cuda`` (the cluster it models) unless
``--device cpu`` asks for the CPU; a mesh that cannot be built raises.
There is no compile step, so the record has ``lower_s`` (the trace) and no
``compile_s``.  ``--unroll`` is accepted and recorded: the port's layer
loop is Python, unrolled already.  Prefill lowers the plain forms
(``use_kernel=False``), as the reference's prefill step does; the Hopper
kernels have no sharding rule.

It starts the fake group itself, so run it as its own process:

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen1.5-0.5b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--mode fsdp|tp] [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
import traceback
from pathlib import Path
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist

from repro_torch.configs.base import INPUT_SHAPES, InputShape, ModelConfig, get_config, input_specs, list_configs
from repro_torch.launch import cost_analysis, sharding, steps
from repro_torch.launch.mesh import HBM_BW, NET_BW, PEAK_FLOPS_BF16, data_axes, make_production_mesh
from repro_torch.models import decoder, spmd

RESULTS_DIR = Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"


def skip_reason(cfg: ModelConfig, shape: InputShape) -> str | None:
    if shape.name == "long_500k" and cfg.is_encoder_decoder:
        # enc-dec: no sub-quadratic analogue for a 524k decoder context
        return "enc-dec: 524k decoder context has no sliding-window analogue"
    return None


def decode_cache_plan(cfg: ModelConfig, shape: InputShape) -> tuple[int, bool]:
    """(cache length, rolling?) for decode shapes."""
    if shape.name == "long_500k":
        if cfg.family in ("ssm", "hybrid"):
            # SSM layers are O(1); jamba's sparse attn layers keep full KV at B=1
            return shape.seq_len, False
        return cfg.long_context_window, True  # dense/MoE: rolling window
    if cfg.sliding_window:
        return min(shape.seq_len, cfg.sliding_window), True
    return shape.seq_len, False


def start_fake_group(world: int) -> None:
    """A ``fake`` process group of ``world`` ranks, this process rank 0:
    collectives return at once and move nothing."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)


def _fake_like(t: torch.Tensor, device_type: str) -> torch.Tensor:
    return torch.empty(t.shape, dtype=t.dtype, device=device_type)


def _layout(tree: Dict[str, torch.Tensor], placements: Dict[str, tuple], mesh) -> Dict[str, torch.Tensor]:
    return {k: v.redistribute(mesh, placements[k]) for k, v in tree.items()}


def trace_step(
    cfg: ModelConfig,
    shape: InputShape,
    mesh,
    mode: str = "fsdp",
    remat: bool = True,
    ce_impl: str = "gather",
    embed_mode: str | None = None,
    act_sharding: bool = False,
    ce_chunk: int = 0,
    cross_cache: bool = False,
    cache_batch_only: bool = False,
    record_collectives: bool = False,
) -> tuple[Dict[str, Any], cost_analysis.StepCost]:
    """One step of ``shape.kind`` for ``cfg`` on fake DTensors over
    ``mesh``, under a :class:`cost_analysis.StepCost`.  Returns
    ({"lower_s": ...} | the cost's summary, the cost)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.experimental import implicit_replication

    device_type = mesh.device_type
    dp = data_axes(mesh)
    if act_sharding:
        decoder.set_activation_shardings(
            act=sharding.to_placements((dp, None, None), mesh),
            logits=sharding.to_placements((dp, None, "model"), mesh),
        )
    else:
        decoder.set_activation_shardings()
    B = shape.global_batch
    try:
        with FakeTensorMode():
            max_seq = shape.seq_len + cfg.num_prefix_tokens
            shapes = decoder.flat_params(decoder.init_params(cfg, device="cpu", max_seq=max_seq))
            p_shard = sharding.params_shardings(decoder.nest_params(shapes), mesh, mode, embed_mode)
            flat = {k: sharding.distribute(_fake_like(v, device_type), mesh, p_shard[k]) for k, v in shapes.items()}
            params = decoder.nest_params(flat)
            specs = input_specs(cfg, shape)
            batch = sharding.distribute_inputs({k: _fake_like(v, device_type) for k, v in specs.items()}, mesh)
            cost = cost_analysis.StepCost(record_collectives)
            t0 = time.time()
            with implicit_replication():
                if shape.kind == "train":
                    cost.track_arguments(params, batch)
                    step = steps.make_train_step(cfg, remat=remat, ce_impl=ce_impl, ce_chunk=ce_chunk)
                    with cost:
                        loss, new = step(params, batch)
                        # the reference's out_shardings: a replicated loss, params in their layout
                        loss = spmd.replicate(loss)
                        new = _layout(decoder.flat_params(new), p_shard, mesh)
                    cost.track_outputs(loss, new)
                elif shape.kind == "prefill":
                    cost.track_arguments(params, batch)
                    step = steps.make_prefill_step(cfg, use_kernel=False)
                    with cost:
                        logits = step(params, batch)
                    cost.track_outputs(logits)
                else:
                    cache_len, rolling = decode_cache_plan(cfg, shape)
                    plain = decoder.init_cache(cfg, B, cache_len, rolling, device="cpu", cross_cache=cross_cache)
                    cache = sharding.distribute_cache(
                        [{k: _fake_like(v, device_type) for k, v in c.items()} for c in plain], mesh, cache_batch_only
                    )
                    args = [params, cache, batch["tokens"], batch["positions"]]
                    with_encoder = cfg.is_encoder_decoder and not cross_cache
                    if with_encoder:
                        # no cross K/V planes: the step projects encoder_out per token
                        enc = torch.empty((B, cfg.encoder_seq, cfg.d_model), dtype=cfg.dtype, device=device_type)
                        args.append(sharding.distribute_inputs({"e": enc}, mesh)["e"])
                    cost.track_arguments(*args)
                    step = steps.make_serve_step(cfg, rolling, with_encoder=with_encoder)
                    with cost:
                        logits, new_cache = step(*args)
                    cost.track_outputs(logits, new_cache)
            lower_s = time.time() - t0
    finally:
        decoder.set_activation_shardings()
    return {"lower_s": round(lower_s, 1), **cost.summary()}, cost


def run_one(
    arch: str,
    shape_name: str,
    multi_pod: bool = False,
    mode: str = "fsdp",
    remat: bool = True,
    seq_override: int | None = None,
    unroll: bool = False,
    ce_impl: str = "gather",
    embed_mode: str | None = None,
    act_sharding: bool = False,
    ce_chunk: int = 0,
    cross_cache: bool = False,
    ssm_chunk: int = 0,
    cache_batch_only: bool = False,
    device_type: str = "cuda",
) -> dict:
    """The record of one (arch, shape) pair on the production mesh, with
    the reference's keys.  Starts a fake group of 256 (512 multi-pod)
    ranks when none is initialized, and destroys it after."""
    cfg = get_config(arch)
    shape = INPUT_SHAPES[shape_name]
    if seq_override:
        shape = dataclasses.replace(shape, seq_len=seq_override)
    if ssm_chunk:
        cfg = dataclasses.replace(cfg, ssm_chunk=ssm_chunk)
    rec: dict = {
        "arch": arch,
        "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "mode": mode,
        "unroll": unroll,
        "ce_impl": ce_impl,
        "embed_mode": embed_mode or "fsdp",
        "act_sharding": act_sharding,
        "device_type": device_type,
    }
    reason = skip_reason(cfg, shape)
    if reason:
        rec["skipped"] = reason
        return rec
    own_group = not dist.is_initialized()
    if own_group:
        start_fake_group(512 if multi_pod else 256)
    try:
        mesh = make_production_mesh(multi_pod=multi_pod, device_type=device_type)
        n_chips = mesh.size()
        got, _ = trace_step(
            cfg, shape, mesh, mode, remat, ce_impl, embed_mode, act_sharding, ce_chunk, cross_cache, cache_batch_only
        )
    finally:
        if own_group:
            dist.destroy_process_group()
    flops = got["flops"]
    rec["lower_s"] = got["lower_s"]
    rec["memory"] = got["memory"]
    rec["cost"] = {"flops": flops, "unfused_bytes": got["unfused_bytes"]}
    rec["collectives"] = got["collectives"]
    rec["collective_counts"] = got["collective_counts"]
    rec["roofline"] = cost_analysis.roofline_terms(
        flops, got["unfused_bytes"], got["collectives"]["total"], PEAK_FLOPS_BF16, HBM_BW, NET_BW
    )
    rec["model_flops_per_chip"], rec["useful_flop_ratio"] = model_flops(cfg, shape, n_chips, flops)
    rec["n_chips"] = n_chips
    return rec


def model_flops(cfg: ModelConfig, shape: InputShape, n_chips: int, flops: float) -> tuple[float, Optional[float]]:
    """The reference's model FLOPs per chip, 6 N_active D for train and
    2 N_active D for inference, and its share of the counted FLOPs."""
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    factor = 6 if shape.kind == "train" else 2
    per_chip = factor * cfg.active_param_count() * tokens / n_chips
    return per_chip, (per_chip / flops if flops else None)


def record_path(arch: str, shape: str, args) -> Path:
    """The reference's file name: arch__shape__sp|mp__mode + the variant."""
    suffix = ""
    if args.unroll:
        suffix += "__unroll"
    if args.ce != "gather":
        suffix += f"__ce-{args.ce}"
    if args.embed_mode and args.embed_mode != "fsdp":
        suffix += f"__emb-{args.embed_mode}"
    if args.act_sharding:
        suffix += "__act"
    if args.ce_chunk:
        suffix += f"__cechunk{args.ce_chunk}"
    if args.cross_cache:
        suffix += "__xcache"
    return RESULTS_DIR / f"{arch}__{shape}__{'mp' if args.multi_pod else 'sp'}__{args.mode}{suffix}.json"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--mode", default="fsdp", choices=["fsdp", "tp"])
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--unroll", action="store_true", help="recorded only: the port's layer loop is unrolled")
    ap.add_argument("--ce", default="gather", choices=["gather", "onehot"])
    ap.add_argument("--embed-mode", default=None, choices=[None, "fsdp", "vocab_only"])
    ap.add_argument("--act-sharding", action="store_true", help="pin activations to the batch-sharded layout")
    ap.add_argument("--ce-chunk", type=int, default=0, help="chunked LM head + CE over the sequence")
    ap.add_argument("--cross-cache", action="store_true", help="enc-dec decode with cached cross K/V")
    ap.add_argument("--ssm-chunk", type=int, default=0, help="override the SSD chunk length")
    ap.add_argument("--cache-batch-only", action="store_true", help="KV cache sharded on batch only")
    ap.add_argument("--seq", type=int, default=None, help="override seq_len (debug)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"], help="the fake tensors' device type")
    args = ap.parse_args(argv)

    if args.all:
        pairs = [(a, s) for a in list_configs() for s in INPUT_SHAPES]
    elif args.arch and args.shape:
        pairs = [(args.arch, args.shape)]
    else:
        ap.error("--arch and --shape, or --all")
    RESULTS_DIR.mkdir(parents=True, exist_ok=True)
    mesh_name = "2x16x16" if args.multi_pod else "16x16"
    start_fake_group(512 if args.multi_pod else 256)
    results = []
    try:
        for arch, shape in pairs:
            tag = f"{arch}|{shape}|{mesh_name}|{args.mode}"
            try:
                rec = run_one(
                    arch, shape, args.multi_pod, args.mode, not args.no_remat, args.seq, args.unroll, args.ce,
                    args.embed_mode, args.act_sharding, args.ce_chunk, args.cross_cache, args.ssm_chunk,
                    args.cache_batch_only, args.device,
                )
                status = "SKIP" if "skipped" in rec else "OK"
                print(
                    f"[{status}] {tag} "
                    + (
                        rec.get("skipped", "")
                        or f"lower={rec['lower_s']}s flops={rec['cost']['flops']:.3g} "
                        f"coll={rec['collectives']['total']:.3g}B bottleneck={rec['roofline']['bottleneck']}"
                    ),
                    flush=True,
                )
            except Exception as e:  # record the failure and go on with the next pair
                rec = {
                    "arch": arch, "shape": shape, "mode": args.mode, "mesh": mesh_name,
                    "error": f"{type(e).__name__}: {e}", "traceback": traceback.format_exc()[-2000:],
                }
                print(f"[FAIL] {tag} {type(e).__name__}: {str(e)[:300]}", flush=True)
            results.append(rec)
            out = Path(args.out) if args.out else record_path(arch, shape, args)
            out.write_text(json.dumps(rec, indent=2, default=str))
    finally:
        dist.destroy_process_group()
    n_ok = sum(1 for r in results if "error" not in r and "skipped" not in r)
    n_skip = sum(1 for r in results if "skipped" in r)
    n_fail = sum(1 for r in results if "error" in r)
    print(f"\n== dry-run summary: {n_ok} ok / {n_skip} skipped / {n_fail} failed ==")
    if n_fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
