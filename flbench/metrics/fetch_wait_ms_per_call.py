"""Host time spent waiting on the device per call of the traced window, in
milliseconds: the self time of the program's spans `fl.fetch`
(analytics._fetch_np and _rows_of: the wait for the device's work, then
the copy to the host)."""

from ..spans import self_ms_per_call


def read(record):
    return self_ms_per_call(record, lambda name: name == "fetch")
