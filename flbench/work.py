"""The work a call must do, counted by the benchmark from the data and the
call, never from the program: the packed payload a table query must read,
with the chunks that zone maps rule out left out (the 'none' half of the
zone-map rule, frozen from the program's `zonemaps`), and on a mesh of n
ranks only the chunks of one rank (the split by chunk, frozen from the
program's `parallel/shard`)."""

from __future__ import annotations

import math

import numpy as np

from . import domain

BLOCK = 1024


def _none(lo, hi, n_nan: int, op: str, v) -> bool:
    """True where no row of a chunk with non-NaN range [lo, hi] (None: no
    such row) and `n_nan` NaN rows can match `op v`."""
    if op in ("in", "notin"):
        probes = [p for p in v if not (isinstance(p, float) and math.isnan(p))]
        if lo is None:
            return not (op == "notin" and n_nan)
        inside = [p for p in probes if lo <= p <= hi]
        if op == "in":
            return not inside
        return bool(inside) and lo == hi and n_nan == 0 and any(p == lo for p in probes)
    if isinstance(v, float) and math.isnan(v):
        return op != "ne"
    if lo is None:
        return not (op == "ne" and n_nan)
    return {"lt": lo >= v, "le": lo > v, "gt": hi <= v, "ge": hi < v,
            "eq": v < lo or v > hi,
            "ne": lo == hi == v and n_nan == 0}[op]


def chunk_ranges(values: np.ndarray, chunk_rows: int) -> list:
    """(lo, hi, NaN count) of each chunk of a column in its order domain."""
    out = []
    for a in range(0, values.size, chunk_rows):
        part = values[a:a + chunk_rows]
        n_nan = 0
        if part.dtype.kind == "f":
            nan = np.isnan(part)
            n_nan = int(nan.sum())
            part = part[~nan]
        out.append((part.min().item(), part.max().item(), n_nan) if part.size
                   else (None, None, n_nan))
    return out


def rank_chunks(n_chunks: int, part=None) -> tuple:
    """Chunks [lo, hi) of rank r of n (`part` = (r, n)) of a column of
    `n_chunks`: s = ceil(n_chunks / n) a rank, in rank order, the last ranks
    short or empty; every chunk without a part."""
    if part is None:
        return 0, n_chunks
    r, n = part
    s = -(-n_chunks // n)
    return min(r * s, n_chunks), min((r + 1) * s, n_chunks)


def kept_chunks(dataset, path: str, preds) -> list:
    """Which chunks of a table a lockstep walk under `preds` must read."""
    chunk_rows = dataset.header(path)["columns"][preds[0][0]]["chunk_blocks"] * BLOCK \
        if preds else None
    keep = None
    for col, op, value in preds:
        column = dataset.column(path, col)
        pop, pv = domain.probe(column, op, value)
        key = ("chunk_ranges", path, col, chunk_rows)
        if key not in dataset.memo:
            dataset.memo[key] = chunk_ranges(domain.ordered(column), chunk_rows)
        ranges = dataset.memo[key]
        flags = [not _none(lo, hi, n, pop, pv) for lo, hi, n in ranges]
        keep = flags if keep is None else [a and b for a, b in zip(keep, flags)]
    return keep


def table_payload_bytes(dataset, path: str, columns, preds, part=None) -> int:
    """Packed payload bytes of every chunk of `columns` that `preds` do not
    rule out; with `part` = (r, n), of rank r's chunks alone."""
    keep = kept_chunks(dataset, path, preds)
    total = 0
    for col in columns:
        chunks = dataset.chunks(path, col)
        lo, hi = rank_chunks(len(chunks), part)
        total += sum(chunks[i]["nbytes"] for i in range(lo, hi) if keep is None or keep[i])
    return total
