"""Kernel launches of the program's decode and encode wrappers
(`kernels.cuda_codecs.LAUNCHES`) per call of the traced window: how well
chunks, files and alp runs are grouped into launches."""


def read(record):
    return record.counters["launches"] / record.calls if record.calls else None
