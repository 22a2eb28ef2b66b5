"""state.resident_gib (GiB): the device memory the epoch carry holds after
the traced epochs (the global model, the N stacked messages, the moments
and the per-client state), each tensor once; the floor under the peak."""


def read(tr):
    return tr.resident_bytes / 2**30 if tr.resident_bytes else None
