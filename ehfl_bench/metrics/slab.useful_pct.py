"""slab.useful_pct (%): clients that started training over the lanes
trained (the compacted slab's width, or N on the dense path), from the
traced epochs' metrics."""


def read(tr):
    from repro_torch.core import policies, simulator

    spec = policies.make_policy(tr.cfg.policy, num_clients=tr.cfg.num_clients, k=tr.cfg.k,
                                num_groups=tr.cfg.num_groups)
    lanes = simulator.resolve_compact_cap(tr.cfg, spec) or tr.cfg.num_clients
    started = sum(m["n_started"] for m in tr.epoch_metrics)
    return 100.0 * started / (lanes * tr.epochs)
