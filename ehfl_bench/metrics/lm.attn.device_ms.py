"""lm.attn.device_ms (ms/epoch): the device time in which operations
launched under the ``lm.attn`` ranges (the attention core: scores, mask,
softmax and the product with v) ran, a traced epoch.  Forward only, as
``lm.moe.device_ms``: the backward's kernels count under
``ehfl.local_train.grad``."""


def read(tr):
    _, device_ms, count = tr.range_ms("lm.attn")
    return device_ms / tr.epochs if count and device_ms > 0 else None
