"""Host time of the one exchange between ranks per call of the traced
window on rank 0, in milliseconds: the self time of the program's spans
`fl.combine` (parallel/shard._combine's all_gather_object), which holds the
gather and the wait for the slowest rank. Nothing where no call combined."""

from ..spans import count_per_call, self_ms_per_call


def read(record):
    if not count_per_call(record, "combine"):
        return None
    return self_ms_per_call(record, lambda name: name == "combine")
