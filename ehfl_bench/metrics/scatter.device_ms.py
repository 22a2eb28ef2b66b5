"""scatter.device_ms (ms/epoch): the device time in which operations
launched under the ``ehfl.scatter`` range (the trained rows written back
into the N-row message table and the Eq. 6 moments) ran, a traced epoch."""


def read(tr):
    _, device_ms, count = tr.range_ms("ehfl.scatter")
    return device_ms / tr.epochs if count and device_ms > 0 else None
