"""Host time of the program's own glue per call of the traced window, in
milliseconds: the self time of the root spans `fl.<entry>` that the
program's public entries open, the part of a call that no stage span
covers."""

from ..spans import STAGES, self_ms_per_call


def read(record):
    return self_ms_per_call(record, lambda name: name not in STAGES)
