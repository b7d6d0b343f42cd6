"""The device's idle share of the traced window: 1 - the union of its
kernel, copy and set intervals over the window's length."""

NAME = "device_idle"
UNIT = "ratio"
LAYER = "device"
MOVES = "qps"


def read(record):
    t = record.trace
    if t is None or t.window_s <= 0:
        return None
    return 1.0 - t.busy_s / t.window_s
