"""kernel_launches_per_epoch (count): kernel records of the traced window
(copies and sets excluded) over its epochs."""


def read(tr):
    kernels = tr.kernels
    return len(kernels) / tr.epochs if kernels else None
