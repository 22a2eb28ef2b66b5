"""local_train.grad.device_ms (ms/epoch): the device time in which
operations launched under the ``ehfl.local_train.grad`` ranges (each SGD
step's vmapped forward and backward) ran, a traced epoch."""


def read(tr):
    _, device_ms, count = tr.range_ms("ehfl.local_train.grad")
    return device_ms / tr.epochs if count and device_ms > 0 else None
