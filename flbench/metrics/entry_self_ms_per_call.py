"""Host time of the program's own glue per call of the traced window, in
milliseconds: the self time of the root spans `fl.<entry>` that the
program's public entries open (spans.entry_names, read from the program),
the part of a call that no stage span covers. A stage span the program adds
is a child of these, and moves nothing here but its parent's self time."""

from ..spans import entry_names, self_ms_per_call


def read(record):
    entries = entry_names()
    if not entries:  # the program's entries unknown: no glue to tell apart
        return None
    return self_ms_per_call(record, lambda name: name in entries)
