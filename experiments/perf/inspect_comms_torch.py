"""The 15 largest collectives of one train step of the port on the 16 x 16
production mesh, by bytes: the counterpart of ``experiments/perf/inspect_hlo.py``.

The step is the dry-run's (``repro_torch.launch.dryrun.trace_step``: fake
tensors over a fake group of 256 ranks, nothing allocated), and each
collective is listed with its kind, its output's dtype and shape on rank 0
and the ``record_function`` range that issued it ("backward" for the
backward pass).  It starts the fake group itself, so run it as its own
process:

  PYTHONPATH=src python experiments/perf/inspect_comms_torch.py qwen1.5-0.5b train_4k [gather|onehot] [vocab_only]
      [--seq N] [--device cpu]
"""
import argparse
import dataclasses
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2] / "src"))

import torch.distributed as dist  # noqa: E402

from repro_torch.configs import INPUT_SHAPES, get_config  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("arch")
    ap.add_argument("shape")
    ap.add_argument("ce", nargs="?", default="gather", choices=["gather", "onehot"])
    ap.add_argument("embed_mode", nargs="?", default=None, choices=[None, "fsdp", "vocab_only"])
    ap.add_argument("--seq", type=int, default=None)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    cfg = get_config(args.arch)
    shape = INPUT_SHAPES[args.shape]
    if args.seq:
        shape = dataclasses.replace(shape, seq_len=args.seq)
    dryrun.start_fake_group(256)
    try:
        mesh = make_production_mesh(device_type=args.device)
        _, cost = dryrun.trace_step(
            cfg, shape, mesh, ce_impl=args.ce, embed_mode=args.embed_mode, record_collectives=True
        )
    finally:
        dist.destroy_process_group()
    for c in sorted(cost.collectives, key=lambda c: -c["bytes"])[:15]:
        shp = f"{c['dtype']}[{','.join(map(str, c['shape']))}]"
        print(f"{c['bytes'] / 1e9:8.2f}GB {c['kind']:18s} {shp:32s} {c['range']}")


if __name__ == "__main__":
    main()
