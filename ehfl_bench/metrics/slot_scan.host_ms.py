"""slot_scan.host_ms (ms/epoch): host duration of the ``ehfl.slot_scan``
range (the S-slot energy loop), a traced epoch."""


def read(tr):
    host_ms, _, count = tr.range_ms("ehfl.slot_scan")
    return host_ms / tr.epochs if count else None
