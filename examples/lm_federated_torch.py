"""VAoI-scheduled federated finetuning of a registered LM on the PyTorch
port: the counterpart of ``examples/lm_federated.py`` (the same flags, plus
``--device``), driving ``python -m repro_torch.launch.train`` on a reduced
config.  Runs on the GPU unless ``--device cpu``.

  PYTHONPATH=src python examples/lm_federated_torch.py --arch qwen1.5-0.5b --rounds 3 --device cpu
"""
import argparse
import subprocess
import sys

if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--clients", type=int, default=6)
    ap.add_argument("--device", default=None, help="cpu, or a CUDA device (default: the GPU)")
    args = ap.parse_args()
    # thin wrapper over the launcher (the same public entry point used at scale)
    cmd = [
        sys.executable, "-m", "repro_torch.launch.train",
        "--arch", args.arch, "--reduced",
        "--clients", str(args.clients),
        "--rounds", str(args.rounds),
        "--k", "2", "--steps-per-round", "4",
    ]
    if args.device:
        cmd += ["--device", args.device]
    sys.exit(subprocess.call(cmd))
