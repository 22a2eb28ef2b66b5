"""local_train.feature.device_ms (ms/epoch): the device time in which
operations launched under the ``ehfl.local_train.feature`` ranges (each SGD
step's vmapped Eq. 6 feature forward and its sum; VAoI only) ran, a traced
epoch."""


def read(tr):
    _, device_ms, count = tr.range_ms("ehfl.local_train.feature")
    return device_ms / tr.epochs if count and device_ms > 0 else None
