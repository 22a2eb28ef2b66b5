"""fedavg_reduce.roofline_pct (%): the FedAvg leaf-table kernel's byte
bound over its device time, read by kernel name.  Only the rows these
inputs need are counted: each row with a nonzero weight (a delivered
upload) read once per leaf dtype group, plus every row's fp32 weight and
the (P,) fp32 output written once; zero-weight rows are not counted."""


def read(tr):
    kernel_us, launches = tr.kernel_us("fedavg_leaves_kernel")
    if not launches or kernel_us <= 0:
        return None
    from repro_torch.core import policies, simulator

    spec = policies.make_policy(tr.cfg.policy, num_clients=tr.cfg.num_clients, k=tr.cfg.k,
                                num_groups=tr.cfg.num_groups)
    cap = simulator.resolve_compact_cap(tr.cfg, spec)
    weights = tr.cfg.num_clients + (cap or 0)
    groups = tr.family.leaf_bytes(tr.cell["model_config"]["model"])
    nbytes = sum(m["n_delivered"] * cols * elt + 4 * weights + 4 * cols
                 for m in tr.epoch_metrics for cols, elt in groups.values())
    bound_us = nbytes / tr.epochs / tr.peaks["hbm_bytes_per_s"] * 1e6  # an epoch
    device_us = kernel_us / launches * len(groups)  # an epoch: one launch a leaf dtype group
    return 100.0 * bound_us / device_us
