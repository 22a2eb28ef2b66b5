"""device_idle_share (%): the share of the traced window in which no
operation ran on the device (1 - union of their intervals / window)."""


def read(tr):
    if not tr.device_ops:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
