"""The share of the group accumulator's kernel launches
(`kernels.cuda_group.LAUNCHES`) that kept each block's accumulator in shared
memory (`kernels.cuda_group.SHARED_LAUNCHES`) over the traced window, in %:
how often the shared-memory mode engages. None where the program has no such
counters; 0 where the kernel never launched (a run on the CPU, whose
accumulator takes the plain version), so that a cell's CPU run still reads
every program counter it lists."""

COUNTERS = ("kernels.cuda_group.LAUNCHES", "kernels.cuda_group.SHARED_LAUNCHES")


def read(record):
    launches, shared = (record.counters.get(c) for c in COUNTERS)
    if launches is None or shared is None:
        return None
    return 100.0 * shared / launches if launches else 0.0
