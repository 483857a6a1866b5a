"""The peak of device memory that the run held, in MB (10^6 bytes): the
card's allocator peak (`torch.cuda.max_memory_allocated`) over set-up and
window, read by the benchmark before the reference runs; on a mesh the
fullest card's. What a query holds on the card: the room left to other
tables and queries."""


def read(record):
    return record.memory_peak_bytes / 1e6 if record.memory_peak_bytes else None
