"""Device time of the host-to-device copies (the profiler's `Memcpy HtoD`
operations) per call of the traced window, in milliseconds."""


def read(record):
    trace = record.trace
    if trace is None or not trace.device or not record.calls:
        return None
    return trace.seconds_of("memcpy_htod") / record.calls * 1e3
