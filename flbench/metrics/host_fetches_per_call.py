"""Device-to-host fetches of the program's analytics (`analytics.HOST_FETCHES`)
per call of the traced window: the round trips that stall the host."""

COUNTERS = ("analytics.HOST_FETCHES",)


def read(record):
    n = record.counters.get(COUNTERS[0])
    return n / record.calls if n is not None and record.calls else None
