"""probe.device_ms (ms/epoch): the device time in which kernels launched
under the ``ehfl.probe`` range (the probe's forward) ran, a traced epoch."""


def read(tr):
    _, device_ms, count = tr.range_ms("ehfl.probe")
    return device_ms / tr.epochs if count and device_ms > 0 else None
