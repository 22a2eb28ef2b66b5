"""Quickstart of the PyTorch/CUDA port: VAoI-scheduled EHFL against greedy
FedAvg and the FedBacys baselines, then the harvest-scenario gallery through
the port's multi-seed ``run_batch``; ``examples/quickstart.py``'s
counterpart, on the GPU unless ``--device`` says otherwise.

  PYTHONPATH=src python examples/quickstart_torch.py
  PYTHONPATH=src python examples/quickstart_torch.py --device cpu

The flags after ``--device`` cut the run (the defaults are the JAX
quickstart's); ``main(argv)`` returns the printed rows.
"""
import argparse

from repro_torch.configs.cifar_cnn import CNNConfig
from repro_torch.core import SCENARIOS, EHFLConfig, run_batch, run_simulation
from repro_torch.data import make_federated_dataset
from repro_torch.device import resolve_device
from repro_torch.fl import cnn_backend

POLICIES = ("vaoi", "fedavg", "fedbacys", "fedbacys_odd")
EPOCHS, GALLERY_EPOCHS, GALLERY_SEEDS = 25, 10, (0, 1)
CNN = CNNConfig(name="quick", image_size=16, conv_channels=(8, 8, 16, 16, 32, 32), fc_dims=(64, 32))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--clients", type=int, default=12)
    ap.add_argument("--samples", type=int, default=60)
    ap.add_argument("--epochs", type=int, default=EPOCHS, help="epochs of each policy's run")
    ap.add_argument("--gallery-epochs", type=int, default=GALLERY_EPOCHS, help="epochs of each scenario's seeds")
    ap.add_argument("--policies", nargs="+", default=list(POLICIES), choices=POLICIES)
    ap.add_argument("--scenarios", nargs="+", default=list(SCENARIOS), choices=SCENARIOS)
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    data = make_federated_dataset(0, num_clients=args.clients, samples_per_client=args.samples, alpha=0.1,
                                  test_size=200, image_size=16, device=device)
    backend = cnn_backend(CNN)
    common = dict(num_clients=args.clients, slots_per_epoch=30, kappa=20, p_bc=0.3, k=4, mu=0.5, e_max=25,
                  probe_size=15, lr=0.05)

    rows = {"policies": [], "scenarios": []}
    print(f"{'policy':<14} {'final F1':>9} {'energy':>8} {'trainings':>10}")
    for policy in args.policies:
        cfg = EHFLConfig(epochs=args.epochs, policy=policy, eval_every=args.epochs, **common)
        m = run_simulation(cfg, backend, data, device=device)["metrics"]
        row = {"policy": policy, "f1": float(m["f1"][-1]), "total_energy": float(m["total_energy"]),
               "trainings": int(m["n_started"].sum())}
        rows["policies"].append(row)
        print(f"{policy:<14} {row['f1']:>9.4f} {row['total_energy']:>8.0f} {row['trainings']:>10d}")

    # harvest-scenario gallery: the same mean arrival rate, 2 seeds per
    # scenario, one run_batch per scenario
    print(f"\n{'scenario':<11} {'final F1 (mean±std over seeds)':>31} {'energy':>8}")
    for scenario in args.scenarios:
        cfg = EHFLConfig(epochs=args.gallery_epochs, policy="vaoi", eval_every=args.gallery_epochs,
                         harvest=scenario, **common)
        m = run_batch(cfg, backend, data, seeds=GALLERY_SEEDS, device=device)["metrics"]
        f1 = m["f1"][:, -1].double()
        row = {"scenario": scenario, "f1_mean": float(f1.mean()), "f1_std": float(f1.std(unbiased=False)),
               "total_energy": float(m["total_energy"].double().mean())}
        rows["scenarios"].append(row)
        print(f"{scenario:<11} {row['f1_mean']:>24.4f} ± {row['f1_std']:.4f} {row['total_energy']:>8.0f}")
    return rows


if __name__ == "__main__":
    main()
