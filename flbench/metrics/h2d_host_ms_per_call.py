"""Host time of the staging copies to the device per call of the traced
window, in milliseconds: the self time of the program's spans `fl.h2d`
(fio_device._rows_to_device and _to_device, pageable copies that hold the
host), the host's side of what h2d_ms_per_call reads on the device."""

from ..spans import self_ms_per_call


def read(record):
    return self_ms_per_call(record, lambda name: name == "h2d")
