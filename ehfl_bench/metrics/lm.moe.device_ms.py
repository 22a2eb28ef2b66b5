"""lm.moe.device_ms (ms/epoch): the device time in which operations
launched under the ``lm.moe`` ranges (the expert layers: router, the held
experts' products, the shared MLP) ran, a traced epoch.  The ranges are
the forward's: the probe, the Eq. 6 taps and the SGD steps' forward; the
backward's kernels are launched outside them and count under
``ehfl.local_train.grad``."""


def read(tr):
    _, device_ms, count = tr.range_ms("lm.moe")
    return device_ms / tr.epochs if count and device_ms > 0 else None
