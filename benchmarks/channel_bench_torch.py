"""Lossy-uplink channel bench on the PyTorch/CUDA port: delivery and retry
dynamics for every channel scenario × selection policy; the counterpart of
``benchmarks/channel_bench.py``.

Each cell runs a short ``run_simulation`` on the stream bench's micro world
(``benchmarks/stream_bench_torch.py``) and records the final macro-F1, the
VAoI trajectory summary, the uplink outcome counters (delivery rate,
retries, drops) and epoch throughput.  Rows go to stdout CSV and to
``BENCH_channel_torch.json`` at the repo root.

The ``ideal`` rows must repeat the stream bench's ``static`` rows bit for
bit (the ideal channel is the pre-channel simulator): ``check_ideal_bitmatch``
holds that contract, and the lossy rows' delivery semantics, on a pair of
the port's files, as ``tools/check_bench.py`` does for the JAX benches'.
Both benches run under cuDNN's deterministic algorithms for it.  Runs on
the GPU unless ``--device`` says otherwise:

  PYTHONPATH=src python benchmarks/channel_bench_torch.py           # quick grid
  PYTHONPATH=src python benchmarks/channel_bench_torch.py --full    # larger protocol
  PYTHONPATH=src python benchmarks/channel_bench_torch.py --check   # the contract on the written files
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, List

import torch

try:  # harness mode (python -m benchmarks.run_torch) vs script mode
    from benchmarks import stream_bench_torch as stream_bench
except ImportError:  # script mode: benchmarks/ itself is sys.path[0]
    import stream_bench_torch as stream_bench

from repro_torch.core.policies import POLICIES
from repro_torch.device import resolve_device

OUT = stream_bench.ROOT / "BENCH_channel_torch.json"

# the fields an ideal row repeats from the static stream row of the same
# policy, N, epochs and compact flag
IDEAL_MATCH_KEYS = ("f1", "avg_age_mean", "avg_m_mean", "n_uploaded")


def bench_config(channel: str, params: tuple, policy: str, epochs: int, n: int, compact: bool = False):
    # the stream bench's protocol constants, verbatim: ideal rows must
    # repeat its static rows
    return stream_bench.sim_config(n, epochs, policy, compact, channel=channel, channel_params=params)


def bench_one(
    channel: str, params: tuple, policy: str, data, backend, epochs: int, n: int, compact: bool = False,
    *, draws=None, init_params=None, device: str | torch.device | None = None,
) -> dict:
    """One cell; ``draws`` and ``init_params`` replace the port's random
    draws and initial global model."""
    cfg = bench_config(channel, params, policy, epochs, n, compact)
    m, wall = stream_bench.run_cell(cfg, backend, data, draws=draws, params=init_params, device=device)
    uploaded = int(m["n_uploaded"].sum())
    delivered = int(m["n_delivered"].sum())
    return {
        "scenario": channel,
        "params": dict(params),
        "policy": policy,
        "compact": compact,
        "epochs": epochs,
        "N": n,
        **stream_bench.outcome(m),
        "delivery_rate": round(delivered / max(uploaded, 1), 4),
        "retries": int(m["n_failed"].sum()),
        "drops": int(m["n_dropped"].sum()),
        **stream_bench.timing(n, epochs, wall),
    }


def grid(n: int) -> list:
    """(channel, params, policy, compact) cells: ideal × every policy (the
    bit-match anchor rows, dense + compact like the stream bench), a
    loss-rate sweep on erasure, a contention sweep on ALOHA, the bursty
    fading regime, and erasure with concentration under FedBacys."""
    cells = [("ideal", (), pol, c) for pol in POLICIES for c in stream_bench.compacts(pol, n)]
    cells += [("erasure", (("p_loss", p),), "vaoi", False) for p in (0.2, 0.5, 0.8)]
    cells += [("aloha", (("num_channels", float(m)),), "vaoi", False) for m in (1, 2, 4)]
    cells += [
        ("fading", (("p_bad", 0.4), ("sojourn", 2.0)), "vaoi", False),
        ("erasure", (("p_loss", 0.3), ("concentration", 1.0)), "fedbacys", False),
    ]
    return cells


def silent_by_design(row: Dict[str, Any]) -> bool:
    """ALOHA on one channel delivers only in an epoch with a sole uploader:
    with k = N/4 scheduled that epoch is rare, and a row may deliver
    nothing (the JAX bench's own row does under jax 0.9.0 on the CPU)."""
    return row.get("scenario") == "aloha" and (row.get("params") or {}).get("num_channels") == 1.0


def check_channel_semantics(channel_doc: Dict[str, Any]) -> List[str]:
    """Every row accounts each attempt (delivered or failed: its
    ``delivery_rate`` is ``(n_uploaded - retries) / n_uploaded`` as
    rounded); every lossy row delivers a share in (0, 1] (in [0, 1] where
    :func:`silent_by_design`); every ideal row delivers everything, with
    no retries or drops."""
    errors = []
    for i, row in enumerate(channel_doc.get("rows", [])):
        rate, sent, failed = row.get("delivery_rate"), row.get("n_uploaded"), row.get("retries")
        if not all(isinstance(x, (int, float)) for x in (rate, sent, failed)):
            errors.append(f"rows[{i}] lacks delivery_rate, n_uploaded or retries")
            continue
        if rate != round((sent - failed) / max(sent, 1), 4):
            errors.append(f"rows[{i}] delivery_rate {rate} does not account {sent} attempts, {failed} failed")
        if row.get("scenario") == "ideal":
            if rate != 1.0 or failed or row.get("drops"):
                errors.append(f"rows[{i}] is ideal but lossy (rate={rate}, retries={failed}, "
                              f"drops={row.get('drops')})")
        elif not (0.0 <= rate <= 1.0 if silent_by_design(row) else 0.0 < rate <= 1.0):
            errors.append(f"rows[{i}] ({row.get('scenario')}/{row.get('policy')}) delivery_rate {rate} is not in "
                          "(0, 1]")
    return errors


def check_ideal_bitmatch(stream_doc: Dict[str, Any], channel_doc: Dict[str, Any]) -> List[str]:
    """The contract of a stream file and a channel file from one protocol:
    each ideal row equals the static row with the same policy, N, epochs and
    compact flag on ``IDEAL_MATCH_KEYS``, and the delivery semantics of
    :func:`check_channel_semantics` hold.  Returns the violations (none: the
    pair is good); an ideal row without its static row is one."""
    static = {
        (r.get("policy"), r.get("N"), r.get("epochs"), bool(r.get("compact", False))): r
        for r in stream_doc.get("rows", []) if r.get("scenario") == "static"
    }
    errors = check_channel_semantics(channel_doc)
    ideal = [r for r in channel_doc.get("rows", []) if r.get("scenario") == "ideal"]
    if not ideal:
        errors.append("no ideal rows")
    for row in ideal:
        key = (row.get("policy"), row.get("N"), row.get("epochs"), bool(row.get("compact", False)))
        ref = static.get(key)
        if ref is None:
            errors.append(f"ideal row {key} has no static stream row")
            continue
        for k in IDEAL_MATCH_KEYS:
            if row.get(k) != ref.get(k):
                errors.append(f"ideal row {key} parts from the static stream row on {k!r}: "
                              f"{row.get(k)} != {ref.get(k)}")
    return errors


def run(quick: bool = True, device: str | torch.device | None = None) -> list:
    """``benchmarks/run_torch.py`` suite entry: the channel grid, written to
    BENCH_channel_torch.json, returned as harness CSV rows."""
    device = resolve_device(device)
    n, samples, epochs = stream_bench.protocol(quick)
    data, backend = stream_bench.world(n, samples, device)
    stream_bench.warm_up(backend, data, n, device)
    rows = [
        bench_one(ch, params, pol, data, backend, epochs, n, compact=c, device=device)
        for ch, params, pol, c in grid(n)
    ]
    stream_bench.write(OUT, {**stream_bench.header("channel", quick, device), "deterministic": True, "rows": rows})
    return [
        {
            "name": f"channel/{r['scenario']}_{r['policy']}"
            + "".join(f"_{k}{v:g}" for k, v in r["params"].items())
            + ("_compact" if r["compact"] else ""),
            "us_per_call": r["epoch_s"] * 1e6,
            "derived": f"f1={r['f1']};deliv={r['delivery_rate']};retries={r['retries']};drops={r['drops']}",
        }
        for r in rows
    ]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--full", action="store_true", help="larger N/T protocol")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--check", action="store_true",
                    help="only hold the written channel file against the written stream file")
    args = ap.parse_args(argv)
    if args.check:
        errors = check_ideal_bitmatch(json.loads(stream_bench.OUT.read_text()), json.loads(OUT.read_text()))
        for e in errors:
            print(f"FAIL: {e}")
        return 1 if errors else 0
    stream_bench.print_rows(run(quick=not args.full, device=args.device))
    print(f"wrote {OUT}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
