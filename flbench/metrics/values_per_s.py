"""Values covered by the calls completed in the window (rows x distinct
columns named, counted from the traffic) per second of the window, which
runs from the first call's issue to the last call's return."""


def read(record):
    return record.values / record.window_s if record.calls else None
