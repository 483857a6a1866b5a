"""Host time of the header parses and string-dictionary loads per call of
the traced window, in milliseconds: the self time of the program's spans
`fl.header` (fio.read_header, fio_table.read_table_header,
fio.payload_base_of) and `fl.dict` (analytics._str_dict_of)."""

from ..spans import self_ms_per_call


def read(record):
    return self_ms_per_call(record, lambda name: name in ("header", "dict"))
