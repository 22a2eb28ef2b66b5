"""vaoi_distance.roofline_pct (%): the Eq. 5 + 7 kernel's byte bound over
its device time, read by kernel name.  Bytes: v and h (N, F) read once in
their dtype, age and q (N,) fp32 read once, m and the new age (N,) fp32
written once, at the card's HBM rate."""


def read(tr):
    kernel_us, launches = tr.kernel_us("vaoi_distance", exclude="empty")
    if not launches or kernel_us <= 0:
        return None
    n, f = tr.cfg.num_clients, tr.family.feature_dim(tr.cell["model_config"]["model"])
    nbytes = 2 * n * f * tr.family.feature_bytes() + 4 * 4 * n
    bound_us = nbytes / tr.peaks["hbm_bytes_per_s"] * 1e6
    return 100.0 * bound_us / (kernel_us / launches)
