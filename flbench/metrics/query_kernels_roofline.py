"""The query's device work against its bytes bound, in percent: the packed
payload of every chunk of the columns the traced calls name, less the chunks
the benchmark's own zone-map rule rules out, at the card's published HBM
rate, over the profiler's time of every kernel the calls ran (decodes,
masks, reductions, accumulators; copies and memsets left out). It counts
the same work whatever kernels implement it. On a mesh it is rank 0's: the
payload of its own chunks over its card's kernels, the collectives' kernels
(`nccl...`, which wait for the other ranks) left out."""


def read(record):
    trace, peaks = record.trace, record.peaks
    if trace is None or peaks is None or not record.work.get("payload_bytes"):
        return None
    seconds = sum(b - a for n, k, a, b in trace.device if k == "kernel" and "nccl" not in n)
    if seconds <= 0:
        return None
    return record.work["payload_bytes"] / peaks["hbm_bytes_per_s"] / seconds * 100
