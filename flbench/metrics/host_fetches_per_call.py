"""Device-to-host fetches of the program's analytics (`analytics.HOST_FETCHES`)
per call of the traced window: the round trips that stall the host."""


def read(record):
    return record.counters["host_fetches"] / record.calls if record.calls else None
