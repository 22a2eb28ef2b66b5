"""local_train.device_ms (ms/epoch): the device time in which kernels
launched under the ``ehfl.local_train`` range (κ SGD steps of the lanes)
ran, a traced epoch."""


def read(tr):
    _, device_ms, count = tr.range_ms("ehfl.local_train")
    return device_ms / tr.epochs if count and device_ms > 0 else None
