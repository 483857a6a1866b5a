"""The share of the traced window in which no operation ran on the device,
in percent: 1 - (the union of the device's kernels, copies and memsets) /
(the window from the first call's span to the last's)."""


def read(record):
    trace = record.trace
    if trace is None or not trace.device:
        return None
    lo, hi = trace.window
    return (1 - trace.busy_s() / (hi - lo)) * 100 if hi > lo else None
