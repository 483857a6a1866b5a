"""Host time of the reads of chunk payloads and validity bitmaps per call of
the traced window, in milliseconds: the self time of the program's spans
`fl.read` (open, seek and read of the file)."""

from ..spans import self_ms_per_call


def read(record):
    return self_ms_per_call(record, lambda name: name == "read")
