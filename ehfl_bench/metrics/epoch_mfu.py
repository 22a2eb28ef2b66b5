"""epoch_mfu (%): the useful model FLOPs of the traced epochs, counted from
shapes by the family (``useful_flops``: started clients' lanes only, the
probe, the feature taps, the eval where it falls), over the traced window's
wall time times the card's peak in the configuration's dtype."""


def read(tr):
    started = sum(m["n_started"] for m in tr.epoch_metrics)
    flops = tr.family.useful_flops(tr.cell, tr.cfg, tr.epochs, started, tr.evals)
    peak = tr.peaks[tr.cell["model_config"]["dtype"]]
    return 100.0 * flops / (tr.window_s * peak) if flops > 0 else None
