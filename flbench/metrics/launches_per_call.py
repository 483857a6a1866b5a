"""Kernel launches of the program's decode and encode wrappers
(`kernels.cuda_codecs.LAUNCHES`) per call of the traced window: how well
chunks, files and alp runs are grouped into launches."""

COUNTERS = ("kernels.cuda_codecs.LAUNCHES",)


def read(record):
    n = record.counters.get(COUNTERS[0])
    return n / record.calls if n is not None and record.calls else None
