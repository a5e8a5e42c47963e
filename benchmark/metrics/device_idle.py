"""One minus the union of the device's intervals (kernels and copies) over
the traced window, in percent."""


def read(record):
    t = record.trace
    if t is None or t.window_seconds() <= 0:
        return None
    return 100.0 * (1.0 - t.busy_seconds() / t.window_seconds())
