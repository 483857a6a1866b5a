"""Header parses per call of the traced window: the program's spans
`fl.header`, one a call of fio.read_header, fio_table.read_table_header or
fio.payload_base_of (each opens and parses the file's header again)."""

from ..spans import count_per_call


def read(record):
    return count_per_call(record, "header")
