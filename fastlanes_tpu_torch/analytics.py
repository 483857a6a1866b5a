"""Scans and aggregations over compressed FLT columns: decode into the
consumer on the GPU.

The FastLanes layout exists so decoders feed their consumers (reference
macros.rs:5-9). This module is the consumer of a device read in the port:
reductions, filtered counts, GROUP BY, top-k and exact quantiles over an FLT
file or a table column, decoded by the CUDA kernels (kernels/cuda_codecs.py)
run by run and reduced with plain torch, with only a handful of numbers per
run or per call leaving the card, and the row-returning queries (`select`,
`join`), where only the chosen rows leave it. It is the port of
fastlanes_tpu/analytics.py.

    from fastlanes_tpu_torch import analytics
    stats = analytics.scan_column("col.flt")             # sum/min/max/count
    n = analytics.count_where("col.flt", "gt", 1000)     # filtered count
    stats = analytics.scan_column("table.flt", column="price")
    all_cols = analytics.scan_table("table.flt")         # one file pass
    hot = analytics.scan_where("table.flt", "gt", 50,    # filtered agg
                               column="price", where="qty")
    hot = analytics.scan_where_multi(                    # WHERE a AND b
        "table.flt", [("qty", "gt", 50), ("cur", "eq", "EUR")], column="price")
    per_key = analytics.group_stats("table.flt", "k", "price")  # GROUP BY
    counts = analytics.value_counts("table.flt", "cur")  # {value: count}
    best = analytics.top_k("table.flt", "price", k=10)   # ORDER BY .. LIMIT
    values = analytics.distinct("table.flt", "cur")      # host only
    p99 = analytics.quantile("table.flt", "price", 0.99) # exact
    rows = analytics.select("table.flt", ["qty", "cur"],  # WHERE .. ORDER BY
                            preds=[("qty", "gt", 50)], order_by="price",
                            desc=True, limit=10)
    rows = analytics.join("fact.flt", "dim.flt", on="sku")  # dimension join

Every entry that touches the device takes `device=None`: the GPU,
RuntimeError without one; `device="cpu"` runs the plain versions of the
kernels on the host.

Results are the Python scalars the JAX package returns, equal and not merely
close. Where that package works in uint32 limb planes because its chip has
no 64-bit integers, this one uses int64 wherever the answer is identical:

  integer sums   exact. Columns of up to 32 bits sum in int64; 64-bit
                 columns sum their two 32-bit halves apart (each partial fits
                 int64 for any column under 2^31 values) and the host
                 reassembles a Python int. 64-bit columns follow int64
                 semantics for sum, min and max (unsigned values >= 2^63
                 appear negative), the reference's convention.
  float sums     exactly rounded, equal to math.fsum: a superaccumulator of
                 int64 bins, one per (sign, exponent bucket, 32-bit plane) of
                 the shifted mantissa, filled with index_add_ (integer
                 addition commutes, so the order of the atomics cannot
                 matter), reassembled on the host and rounded ONCE.
                 NaN and +-inf are counted apart and resolved on the host.
  order          integer compares only. Unsigned columns compare on the
                 signed view with the top bit flipped (torch has no unsigned
                 compares on the CPU); floats compare on the IEEE total-order
                 key of their bits, so NaN matches only `ne`, -0.0 == +0.0
                 and subnormals are not flushed.

`HOST_FETCHES` counts the device-to-host fetches (each one a
synchronisation): one per decoded run in a scan, a count or a top-k, one per
lockstep window in scan_where_multi, one per call in group_stats and
value_counts, and in select and join two per lockstep window that has
matching rows (the row count or the top-k candidates, then every projected
column in one copy).
"""

from __future__ import annotations

import math
import struct
from fractions import Fraction
from typing import Optional

import numpy as np
import torch

from . import fio, fio_device, zonemaps
from .core import layout
from .kernels import cuda_group
from .ops import _engine as eng
from .parallel import shard
from .utils.trace import entry, span, spanned

_ORDER_OPS = ("lt", "le", "gt", "ge", "eq", "ne")
#: membership predicates take a LIST of probe values (the semi-join /
#: SQL IN pushdown); null rows match neither `in` nor `notin`
_SET_OPS = ("in", "notin")
_ALL_OPS = _ORDER_OPS + _SET_OPS

#: lockstep walks (a cross-column where) decode this many aligned chunks per
#: launch; results are identical for every window (1 = chunk at a time)
_LOCKSTEP_WINDOW = 8

#: device-to-host fetches made by this module (plain integer; reset by
#: assigning 0)
HOST_FETCHES = 0


def _fetch(tensor: torch.Tensor) -> list:
    """A small integer tensor -> Python ints: ONE copy to the host."""
    return _fetch_np(tensor).tolist()


@spanned("fetch")
def _fetch_np(tensor: torch.Tensor) -> np.ndarray:
    """An integer tensor -> a numpy array: ONE copy to the host."""
    global HOST_FETCHES
    HOST_FETCHES += 1
    return tensor.cpu().numpy()


def _column_layout(path: str, column: Optional[str]):
    """Chunk metadata of a column (FLT file or FLTTAB table column):
    (chunks, cdtype, transform, vtype, n_values, base_off, nulls_meta)."""
    file = fio.header_of(path)
    if file.table:
        from . import fio_table

        if column is None:
            raise ValueError("table file: pass column=<name>")
        col = fio_table._col_meta(file.header, column)
    else:
        col = file.header
    return (col["chunks"], col["dtype"], col.get("transform"), col.get("vtype"),
            col.get("n_values"), file.base, col.get("nulls"))


def _paths(path):
    """Every entry point accepts one path or a LIST of paths (a sharded
    dataset); lists scan file by file into one shared accumulator, which
    keeps integer sums, exact float sums, counts and extremes exact across
    files. String columns merge per file: each file owns its dictionary."""
    return list(path) if isinstance(path, (list, tuple)) else [path]


def _merge_str_stats(subs) -> dict:
    """Merge per-file stats of a string column (each file owns its own
    dictionary, so code-domain accumulators cannot merge; strings can)."""
    mins = [s["min"] for s in subs if s["min"] is not None]
    maxs = [s["max"] for s in subs if s["max"] is not None]
    out = {"sum": None, "min": min(mins) if mins else None,
           "max": max(maxs) if maxs else None,
           "count": sum(s["count"] for s in subs)}
    if any("n_null" in s for s in subs):
        out["n_null"] = sum(s.get("n_null", 0) for s in subs)
    return out


def _decoded_chunks(path: str, column: Optional[str], device,
                    window: Optional[int] = None, keep=None, natural=False,
                    part=None):
    """Yield (decoded device blocks, dtype, vtype, valid, vmask) already
    transform-applied: real values in the column's logical domain. `valid`
    counts the leading values of the part that belong to the column (the
    rest is tail padding); `vmask` is the part's flat device validity mask
    for nullable columns (True = present; null fillers are real neighbour
    values and must not contribute), else None. Without a `window` (the
    default), consecutive same-signature chunks decode in ONE kernel launch
    (fio_device._decode_chunks_grouped) and come back as one merged part;
    lockstep consumers (a cross-column scan_where) pass a `window` of N >= 1:
    every window of N chunks decodes batched and yields exactly ONE part, so
    multi-column walks stay aligned.

    `keep` (optional, one bool per chunk, from zone-map decisions) skips
    chunks the caller proved irrelevant: skipped chunks are never read or
    decoded, and value/block accounting jumps over them so `valid` and the
    validity mask stay exact. In window mode a window decodes whole unless
    EVERY chunk in it is skippable (lockstep consumers feed every column
    the same `keep`, so the walks stay aligned).

    `natural=True` (order-insensitive consumers only: reductions, counts)
    lets delta-family chunks keep the NATURAL transposed-domain image: the
    transposed-order kernels `undelta_pack` / `unzdelta_pack` run and no
    relayout does. Values are a per-block permutation of the original
    order, so it is applied per run only when nothing positional rides
    along: no validity bitmap and no padded tail block in the run (the
    `valid` prefix and `vmask` are positional).

    `part` (a mesh rank's place, parallel.shard._Part) walks only this
    rank's chunks (shard._chunk_span): they alone are read from disk and
    decoded, and `valid`, the validity mask and `keep` keep their file-wide
    positions. Windows lie on the file's grid (`_windows`), so each window
    of the walk without a part is one window of one rank, or two pieces of
    it on two neighbouring ranks."""
    chunks, cdtype, transform, vtype, n_values, base_off, nulls_meta = \
        _column_layout(path, column)
    lo, hi = shard._chunk_span(part, len(chunks))
    starts = [0]
    for m in chunks:
        starts.append(starts[-1] + m["n_blocks"])

    def _run_natural(idxs):
        if not natural or nulls_meta is not None:
            return False
        end_values = starts[idxs[-1] + 1] * layout.BLOCK
        return n_values is None or end_values <= n_values

    with open(path, "rb") as f:
        @spanned("read")
        def read_cov(idxs):
            cov = []
            for i in idxs:
                meta = chunks[i]
                f.seek(base_off + meta["offset"])
                cov.append((meta, f.read(meta["nbytes"])))
            return cov

        def emit(parts, block0):
            seen_blocks = block0
            seen_values = block0 * layout.BLOCK
            for blocks in parts:
                n_blocks_here = blocks.shape[0]
                n_here = n_blocks_here * layout.BLOCK
                blocks = fio_device._apply_transform_device(blocks, transform,
                                                            cdtype)
                valid = n_here
                if n_values is not None:
                    valid = max(0, min(n_here, n_values - seen_values))
                seen_values += n_here
                vmask = None
                if nulls_meta is not None:
                    vmask = fio_device._to_device(fio.read_validity_range(
                        path, nulls_meta, base_off, seen_blocks,
                        seen_blocks + n_blocks_here).reshape(-1), device)
                seen_blocks += n_blocks_here
                yield blocks, cdtype, vtype, valid, vmask

        if window is None:
            runs = []  # maximal contiguous runs of kept chunk indices
            for i in range(lo, hi):
                if keep is not None and not keep[i]:
                    continue
                if runs and runs[-1][-1] == i - 1:
                    runs[-1].append(i)
                else:
                    runs.append([i])
            for run in runs:
                subs = [run]
                if (natural and nulls_meta is None
                        and len(run) > 1 and not _run_natural(run)
                        and _run_natural(run[:-1])):
                    # only the padded tail chunk blocks natural order:
                    # split it off so the bulk still skips the relayout
                    subs = [run[:-1], run[-1:]]
                for sub in subs:
                    parts = fio_device._decode_chunks_grouped(
                        read_cov(sub), cdtype, device,
                        natural=_run_natural(sub))
                    yield from emit(parts, starts[sub[0]])
        else:
            for idxs in _windows(lo, hi, window):
                if keep is not None:
                    # trim the skippable prefix/suffix of the window (the
                    # interior decodes whole so the part stays one
                    # contiguous block range; lockstep columns share keep,
                    # so every column trims identically)
                    kept = [j for j in idxs if keep[j]]
                    if not kept:
                        continue
                    idxs = range(kept[0], kept[-1] + 1)
                ps = fio_device._decode_chunks_grouped(
                    read_cov(idxs), cdtype, device)
                yield from emit(
                    [fio_device._concat_parts(ps, cdtype, device, vtype)],
                    starts[idxs[0]])


def _windows(lo: int, hi: int, window: int):
    """The lockstep windows of the chunks [lo, hi), each a range: cut at the
    multiples of `window` counted from the file's chunk 0, so a range that
    starts inside a window (a mesh rank's) starts with the rest of it."""
    while lo < hi:
        end = min((lo // window + 1) * window, hi)
        yield range(lo, end)
        lo = end


def _probe_epoch(path, column, value):
    """Temporal-column probes -> int64 epochs in the COLUMN's unit:
    np.datetime64/np.timedelta64 scalars (any unit) and date strings
    convert with unit scaling; plain ints pass through as raw epochs.
    Non-temporal columns return the probe unchanged."""
    vt = _column_layout(path, column)[3]
    if not (vt or "").startswith(("datetime64", "timedelta64")):
        return value

    def one(v):
        if isinstance(v, (int, np.integer)):
            return int(v)
        return int(np.array(v, dtype=np.dtype(vt)).view("int64"))

    return [one(v) for v in value] if isinstance(value, (list, tuple)) \
        else one(value)


def _zone_decisions_col(path, column, op, value):
    """Per-chunk zone decisions ('none'/'all'/'maybe') of one predicate on
    one column (op/value already code-domain for string columns), plus the
    chunk list and n_values for 'all' accounting. Chunks without stored
    stats (pre-zone-map files) decide 'maybe'."""
    chunks, cdtype, _t, vtype, n_values, _b, _nm = _column_layout(path,
                                                                  column)
    kind = zonemaps.kind_of(cdtype, vtype)
    return zonemaps.decisions(chunks, kind, op, value), chunks, n_values


@spanned("zonemap")
def _zone_keep(path, preds, names=()):
    """Chunk keep flags for ANDed predicates [(col, op, value)]: False
    where some predicate's zone decision is 'none' (the chunk can satisfy
    no row, so lockstep walks skip it for EVERY column). Returns None when
    nothing is skippable, or when any involved column's chunk count
    disagrees, leaving the layout mismatch to the walk's own error."""
    counts = set()
    for n in names:
        try:
            counts.add(len(_column_layout(path, n)[0]))
        except (ValueError, KeyError):
            return None
    keep = None
    for pcol, op, value in preds:
        try:
            ds, chunks, _nv = _zone_decisions_col(path, pcol, op, value)
        except (ValueError, KeyError):
            return None
        counts.add(len(chunks))
        if len(counts) > 1:
            return None
        if keep is None:
            keep = [True] * len(chunks)
        for i, d in enumerate(ds):
            if d == "none":
                keep[i] = False
    return None if keep is None or all(keep) else keep


@spanned("dict")
def _str_dict_of(path: str, column: Optional[str]):
    """Sorted dictionary of a string table column, else None; loaded once
    a call (fio.header_of)."""
    if column is None:
        return None
    file = fio.header_of(path)
    if not file.table:
        return None
    from . import fio_table

    col = fio_table._col_meta(file.header, column)
    if col.get("vtype") != "str":
        return None
    if column not in file.dicts:
        with open(path, "rb") as f:
            file.dicts[column] = fio_table._load_str_dict(f, file.base, col)
    return file.dicts[column]


def _str_pred_to_code(dictionary: np.ndarray, op: str, value):
    """String predicate -> code-domain integer predicate. The dictionary is
    sorted ascending, so code order == lexicographic order; probes absent
    from the dictionary fold to the neighbouring threshold (eq/ne on a
    missing value become never/always: code < 0 / code >= 0)."""
    if op in _SET_OPS:  # membership probes -> present codes only
        codes = []
        for v in value:
            i = int(np.searchsorted(dictionary, str(v)))
            if i < dictionary.size and dictionary[i] == str(v):
                codes.append(i)
        return op, codes
    value = str(value)
    lo_idx = int(np.searchsorted(dictionary, value))
    exact = bool(lo_idx < dictionary.size and dictionary[lo_idx] == value)
    thr = lo_idx + (1 if exact else 0)
    if op == "lt":
        return "lt", lo_idx
    if op == "le":
        return "lt", thr
    if op == "ge":
        return "ge", lo_idx
    if op == "gt":
        return "ge", thr
    if op == "eq":
        return ("eq", lo_idx) if exact else ("lt", 0)
    if op == "ne":
        return ("ne", lo_idx) if exact else ("ge", 0)
    raise ValueError(f"unknown predicate {op!r}; have {sorted(_ALL_OPS)}")


def _map_str_result(r: dict, dictionary: np.ndarray) -> dict:
    """Code-domain stats of a string column -> user-facing stats: min/max
    become the lexicographic extreme strings; a sum of codes is meaningless
    and reports None."""
    has = r["count"] > 0
    return {"sum": None,
            "min": str(dictionary[int(r["min"])]) if has else None,
            "max": str(dictionary[int(r["max"])]) if has else None,
            "count": r["count"], "n_dict": int(dictionary.size)}


# ---------------------------------------------------------------------------
# The flat logical vector of a decoded part. Every domain is a SIGNED
# integer tensor whose signed order is the column's logical order:
#
#   kind "int"   key = the values, as they are for a signed column (after a
#                zigzag/viewu transform) and for every 64-bit column (int64
#                semantics); for an unsigned column of up to 32 bits the
#                signed view with the top bit flipped, logical value =
#                key + offset with offset = 2^(T-1).
#   kind "f32"/  key = the raw IEEE bits (int32 / int64); the total-order
#        "f64"   key is derived from them where an order is needed.


class _Flat:
    __slots__ = ("kind", "key", "bits", "offset")

    def __init__(self, kind, key, bits, offset=0):
        self.kind = kind      # "int" | "f32" | "f64"
        self.key = key        # 1-D signed integer tensor
        self.bits = bits      # 8, 16, 32 or 64
        self.offset = offset  # logical value = key + offset ("int" only)

    def __len__(self) -> int:
        return int(self.key.shape[0])

    def head(self, n: int) -> "_Flat":
        """The first `n` values (a part's valid prefix)."""
        if n == len(self):
            return self
        return _Flat(self.kind, self.key[:n], self.bits, self.offset)


_INT_OF_BITS = {8: torch.int8, 16: torch.int16, 32: torch.int32,
                64: torch.int64}


def _flatten_logical(blocks, cdtype, vtype) -> _Flat:
    """Device blocks -> the flat signed-key vector (see above)."""
    arr = blocks.reshape(-1)
    if arr.dtype == torch.float64:
        return _Flat("f64", arr.view(torch.int64), 64)
    if arr.dtype == torch.float32:
        return _Flat("f32", arr.view(torch.int32), 32)
    t = arr.dtype.itemsize * 8
    if t == 64:  # int64 semantics, signed or not (the reference's u64 rule)
        return _Flat("int", arr.view(torch.int64), 64)
    if arr.dtype in _INT_OF_BITS.values():  # signed after its transform
        return _Flat("int", arr, t)
    top = 1 << (t - 1)
    return _Flat("int", arr.view(_INT_OF_BITS[t]) ^ (-top), t, top)


def _imin(dtype) -> int:
    return torch.iinfo(dtype).min


def _imax(dtype) -> int:
    return torch.iinfo(dtype).max


def _masked(x, ok, fill):
    return x if ok is None else torch.where(ok, x, fill)


def _count(ok, n: int, device):
    if ok is None:
        return torch.tensor([n], dtype=torch.int64, device=device)
    return ok.sum(dtype=torch.int64).reshape(1)


def _stats_core_int(key, ok):
    """Masked count/sum/min/max of a signed key of up to 32 bits, as ONE
    int64 tensor [n_ok, sum, min, max]. The sum accumulates in int64:
    |key| < 2^31, so it is exact for any part under 2^32 values."""
    dt = key.dtype
    return torch.stack([
        _count(ok, key.shape[0], key.device)[0],
        _masked(key, ok, 0).sum(dtype=torch.int64),
        _masked(key, ok, _imax(dt)).min().to(torch.int64),
        _masked(key, ok, _imin(dt)).max().to(torch.int64)])


def _stats_core_i64(key, ok):
    """64-bit twin: [n_ok, sum of the low halves, sum of the high halves,
    min, max]. value = hi * 2^32 + lo with lo in [0, 2^32) and hi the
    ARITHMETIC shift in [-2^31, 2^31), so each partial sum fits int64 for
    any part under 2^31 values and the host's hi_sum * 2^32 + lo_sum is the
    exact int64-semantics total (what the plane sum minus 2^64 * n_negative
    of the limb form gives). min/max are in signed-int64 order."""
    x = _masked(key, ok, 0)
    return torch.stack([
        _count(ok, key.shape[0], key.device)[0],
        (x & 0xFFFFFFFF).sum(), (x >> 32).sum(),
        _masked(key, ok, _imax(torch.int64)).min(),
        _masked(key, ok, _imin(torch.int64)).max()])


# ---------------------------------------------------------------------------
# Exact float sums. A float64 is (-1)^s * m * 2^(E'-1075) with E' = max(E, 1)
# and m the 52-bit fraction plus the implicit bit when E > 0 (a float32:
# 2^(E'-150), 23 bits). Writing E' = 8*b + r, the EXACT column sum is a
# SUPERACCUMULATOR:
#
#   sum = ( sum_{s,b,k} +-BIN[s,b,k] * 2^(8*b + 32*k) ) * 2^-1075
#
# where BIN accumulates the k-th 32-bit plane of m << r per sign and bucket
# (m << r < 2^61: two planes for f64; < 2^31: one plane for f32). Every
# plane value is < 2^32, so an int64 bin holds any part under 2^31 values.
# The bins are filled by index_add_ over _SPREAD interleaved copies (a
# decimal column puts nearly every value into one bin; consecutive elements
# go to different copies so the atomic adds do not queue on one address),
# summed on the device, reassembled as a Python int on the host and rounded
# once (Fraction -> float). The bin layout is this module's own; the float
# that comes out is the reference's.

_SPREAD = 64
_FLOAT_SPEC = {
    # kind: (int dtype, exponent bits, fraction bits, planes, buckets, denominator bits)
    "f64": (torch.int64, 11, 52, 2, 256, 1075),
    "f32": (torch.int32, 8, 23, 1, 32, 150),
}


def _float_fields(bits, kind):
    """(sign 0/1, biased exponent, fraction, is_special) of IEEE bits."""
    _dt, ebits, fbits, _p, _b, _d = _FLOAT_SPEC[kind]
    sign = (bits >> (ebits + fbits)) & 1
    exp = (bits >> fbits) & ((1 << ebits) - 1)
    frac = bits & ((1 << fbits) - 1)
    return sign, exp, frac, exp == (1 << ebits) - 1


def _total_order_key(bits, kind):
    """IEEE-754 total-order key in the SIGNED domain: flip the non-sign
    bits of a negative float, and signed integer order == numeric order
    (with -0.0 < +0.0; NaNs at the extremes, callers mask them). The map is
    its own inverse."""
    dt = _FLOAT_SPEC[kind][0]
    return bits ^ ((bits >> (dt.itemsize * 8 - 1)) & _imax(dt))


def _stats_core_float(bits, ok, kind):
    """Exact float stats from the raw bit pattern, as ONE int64 tensor:
    [bins (2 * buckets * planes) ..., n_ok, n_nan, n_pinf, n_ninf, n_key,
    key_min, key_max]."""
    dt, _ebits, fbits, planes, buckets, _d = _FLOAT_SPEC[kind]
    n = bits.shape[0]
    sign, exp, frac, special = _float_fields(bits, kind)
    live = (lambda m: m) if ok is None else (lambda m: m & ok)
    is_nan = live(special & (frac != 0))
    is_inf = live(special & (frac == 0))
    fin = live(~special)
    # finite contribution: m << (E' % 8), split into 32-bit planes
    ep = exp.clamp(min=1)
    m = torch.where(fin, frac | ((exp > 0).to(dt) << fbits), 0)
    shifted = m << (ep & 7)
    n_bins = 2 * buckets * planes
    slot = torch.where(fin, (sign * buckets + (ep >> 3)) * planes, 0).to(torch.int64)
    slot += (torch.arange(n, device=bits.device) % _SPREAD) * n_bins
    acc = torch.zeros(_SPREAD * n_bins, dtype=torch.int64, device=bits.device)
    for k in range(planes):
        plane = (shifted >> (32 * k)) & 0xFFFFFFFF if planes > 1 else shifted
        acc.index_add_(0, slot + k, plane.to(torch.int64))
    # total-order min/max over comparable (non-NaN, in-range) values
    key = _total_order_key(bits, kind)
    kok = live(~(special & (frac != 0)))
    return torch.cat([
        acc.reshape(_SPREAD, n_bins).sum(0),
        _count(ok, n, bits.device),
        torch.stack([is_nan.sum(), (is_inf & (sign == 0)).sum(),
                     (is_inf & (sign == 1)).sum(), kok.sum(),
                     torch.where(kok, key, _imax(dt)).min().to(torch.int64),
                     torch.where(kok, key, _imin(dt)).max().to(torch.int64)])])


def _float_bins_to_int(bins, kind) -> int:
    """Fetched bins -> signed big-int numerator (units of 2^-1075 / 2^-150)."""
    _dt, _e, _f, planes, buckets, _d = _FLOAT_SPEC[kind]
    bins = np.asarray(bins, dtype=np.int64)
    num = 0
    for j in np.flatnonzero(bins).tolist():
        s, r = divmod(j, buckets * planes)
        b, k = divmod(r, planes)
        num += (1 - 2 * s) * (int(bins[j]) << (8 * b + 32 * k))
    return num


def _float_of_key(key: int, kind: str) -> float:
    """Inverse of _total_order_key on a host int -> python float."""
    if kind == "f64":
        return struct.unpack("<d", struct.pack("<q", key ^ ((key >> 63) & (2 ** 63 - 1))))[0]
    return struct.unpack("<f", struct.pack("<i", key ^ ((key >> 31) & (2 ** 31 - 1))))[0]


def _probe_key(value: float, kind: str) -> int:
    """Total-order key of a float probe in the column's precision; a zero
    probe of either sign is +0.0 (-0.0 == +0.0)."""
    if kind == "f32":
        vb = struct.unpack("<i", struct.pack(
            "<f", 0.0 if value == 0 else np.float32(value)))[0]
        return vb ^ ((vb >> 31) & (2 ** 31 - 1))
    vb = struct.unpack("<q", struct.pack("<d", 0.0 if value == 0 else value))[0]
    return vb ^ ((vb >> 63) & (2 ** 63 - 1))


def _order_hit(key, vkey: int, op: str):
    if op == "lt":
        return key < vkey
    if op == "le":
        return key <= vkey
    if op == "gt":
        return key > vkey
    if op == "ge":
        return key >= vkey
    if op == "eq":
        return key == vkey
    if op == "ne":
        return key != vkey
    raise ValueError(f"unknown predicate {op!r}; have {sorted(_ALL_OPS)}")


def _hit_float(bits, vkey: int, op: str, kind: str):
    """Float predicate mask on total-order keys: integer compares, so
    subnormals keep numpy semantics; NaN matches only 'ne'; -0.0 == +0.0
    (zeros normalized before the key)."""
    _sign, _exp, frac, special = _float_fields(bits, kind)
    is_nan = special & (frac != 0)
    neg_zero = _imin(_FLOAT_SPEC[kind][0])
    key = _total_order_key(torch.where(bits == neg_zero, 0, bits), kind)
    hit = _order_hit(key, vkey, op)
    return (hit | is_nan) if op == "ne" else (hit & ~is_nan)


def _const_mask(flat: _Flat, value: bool):
    return torch.full((len(flat),), value, dtype=torch.bool, device=flat.key.device)


def _int_probe(flat: _Flat, value):
    """An integer probe in the key domain of `flat`, or None when it lies
    outside the column dtype's range. A 64-bit column takes the probe's
    two's-complement bit pattern (int64 semantics, as for its values)."""
    v = int(value)
    if flat.bits == 64:
        v &= (1 << 64) - 1
        return v - (1 << 64) if v >= 1 << 63 else v
    v -= flat.offset
    dt = flat.key.dtype
    return v if _imin(dt) <= v <= _imax(dt) else None


def _hit_in_sorted(key, sset):
    """Membership of key in a sorted device set: one searchsorted + one
    gather, so it scales to large IN lists. The set is sorted in the key
    domain, which for an unsigned column is the flipped order of the key."""
    i = torch.searchsorted(sset, key).clamp(max=sset.shape[0] - 1)
    return sset[i] == key


def _membership_mask(flat: _Flat, values, negate: bool):
    """IN / NOT IN over any value domain. Integer domains use a sorted
    device set (probes outside the dtype's range are dropped on the host);
    float domains OR per-probe equality masks (IN lists are short; every
    probe reuses the exact eq semantics: -0.0 == +0.0, NaN probes match
    nothing)."""
    vals = list(values)
    if flat.kind != "int":
        m = _const_mask(flat, False)
        for v in vals:
            m = m | _pred_mask(flat, "eq", v)
        return ~m if negate else m
    keep = sorted({k for k in (_int_probe(flat, v) for v in vals)
                   if k is not None})
    if not keep:
        m = _const_mask(flat, False)
    else:
        sset = torch.tensor(keep, dtype=flat.key.dtype, device=flat.key.device)
        m = _hit_in_sorted(flat.key, sset)
    return ~m if negate else m


def _pred_mask(flat: _Flat, op: str, value):
    """Predicate hit mask (device bool tensor) over a flattened part, any
    domain: the probe value is key-encoded on the host to match the part's
    comparison domain."""
    if op in _SET_OPS:
        return _membership_mask(flat, value, op == "notin")
    if flat.kind != "int":
        v = float(value)
        if math.isnan(v):  # numpy: NaN matches only 'ne', everywhere
            return _const_mask(flat, op == "ne")
        return _hit_float(flat.key, _probe_key(v, flat.kind), op, flat.kind)
    vkey = _int_probe(flat, value)
    if vkey is None:
        # probes outside the column dtype's range fold to constants on the host
        above = int(value) - flat.offset > _imax(flat.key.dtype)
        if op not in _ORDER_OPS:
            raise ValueError(f"unknown predicate {op!r}; have {sorted(_ALL_OPS)}")
        every = (above and op in ("lt", "le", "ne")) or \
                (not above and op in ("gt", "ge", "ne"))
        return _const_mask(flat, every)
    return _order_hit(flat.key, vkey, op)


def _count_masked(mask, valid: int) -> int:
    return _fetch(mask[:valid].sum().reshape(1))[0]


def _merge_extreme(cur, new, op):
    """NaN-sticky merge of two extremes (Python's min/max with a NaN depend
    on the argument order; numpy's semantics propagate it)."""
    if cur is None:
        return new
    if isinstance(cur, float) and math.isnan(cur):
        return cur
    if isinstance(new, float) and math.isnan(new):
        return new
    return op(cur, new)


class _StatAcc:
    """Running sum/min/max/count accumulator fed one decoded part at a
    time: the shared core of scan_column, scan_table and scan_where. Each
    feed fetches ONE small integer tensor from the device."""

    def __init__(self):
        self.total = 0
        self.mn = None
        self.mx = None
        self.count = 0
        # exact-float state (f32/f64 columns): big-int superaccumulator
        # numerator (units of 2^-150 / 2^-1075), special counts, total-order
        # keys (signed ints: integer compare == numeric order)
        self.float_kind = None
        self.float_num = 0
        self.n_nan = 0
        self.n_pinf = 0
        self.n_ninf = 0
        self.kmn = None
        self.kmx = None

    def feed(self, blocks, cdtype, vtype, valid, pred=None):
        """Accumulate one decoded part; `pred` (device bool tensor aligned
        with the flattened part) restricts to matching rows: the
        scan_where path. `count` counts CONTRIBUTING rows."""
        if valid == 0:
            return
        self.feed_flat(_flatten_logical(blocks, cdtype, vtype), valid, pred)

    @spanned("acc")
    def feed_flat(self, flat: _Flat, valid, pred=None):
        if valid == 0:
            return
        key = flat.head(valid).key
        ok = None if pred is None else pred[:valid]
        if flat.kind != "int":
            self._feed_float(key, ok, flat.kind)
            return
        if flat.bits == 64:
            n_ok, s_lo, s_hi, mn, mx = _fetch(_stats_core_i64(key, ok))
            total = (s_hi << 32) + s_lo
        else:
            n_ok, total, mn, mx = _fetch(_stats_core_int(key, ok))
        if n_ok == 0:  # nothing contributes: keep the neutrals out
            return
        self.total += total + n_ok * flat.offset
        self.mn = _merge_extreme(self.mn, mn + flat.offset, min)
        self.mx = _merge_extreme(self.mx, mx + flat.offset, max)
        self.count += n_ok

    def _feed_float(self, bits, ok, kind):
        self.float_kind = kind
        out = _fetch(_stats_core_float(bits, ok, kind))
        n_ok, n_nan, n_pinf, n_ninf, n_key, kmn, kmx = out[-7:]
        self.float_num += _float_bins_to_int(out[:-7], kind)
        self.n_nan += n_nan
        self.n_pinf += n_pinf
        self.n_ninf += n_ninf
        if n_key:  # the part had comparable values: merge total-order keys
            self.kmn = kmn if self.kmn is None else min(self.kmn, kmn)
            self.kmx = kmx if self.kmx is None else max(self.kmx, kmx)
        self.count += n_ok

    @classmethod
    def merged(cls, accs) -> "_StatAcc":
        """One accumulator holding what `accs` (the ranks' partial states,
        in rank order) hold: every field is exact (Python ints, the float
        numerator, counts, total-order keys), so the merge is the walk
        without a mesh."""
        out = cls()
        for a in accs:
            out.total += a.total
            out.count += a.count
            if a.mn is not None:
                out.mn = _merge_extreme(out.mn, a.mn, min)
                out.mx = _merge_extreme(out.mx, a.mx, max)
            out.float_kind = a.float_kind or out.float_kind
            out.float_num += a.float_num
            out.n_nan += a.n_nan
            out.n_pinf += a.n_pinf
            out.n_ninf += a.n_ninf
            if a.kmn is not None:
                out.kmn = a.kmn if out.kmn is None else min(out.kmn, a.kmn)
                out.kmx = a.kmx if out.kmx is None else max(out.kmx, a.kmx)
        return out

    def result(self) -> dict:
        if self.float_kind is None:
            return {"sum": self.total, "min": self.mn, "max": self.mx,
                    "count": self.count}
        denom_bits = _FLOAT_SPEC[self.float_kind][5]
        if self.n_nan or (self.n_pinf and self.n_ninf):
            total = float("nan")
        elif self.n_pinf:
            total = float("inf")
        elif self.n_ninf:
            total = float("-inf")
        else:
            total = (float(Fraction(self.float_num, 1 << denom_bits))
                     if self.float_num else 0.0)
        if self.n_nan:
            mn = mx = float("nan")
        else:
            mn = (_float_of_key(self.kmn, self.float_kind)
                  if self.kmn is not None else None)
            mx = (_float_of_key(self.kmx, self.float_kind)
                  if self.kmx is not None else None)
        return {"sum": total, "min": mn, "max": mx, "count": self.count}


def _per_file(paths, column) -> bool:
    """A dataset over a string column merges per file: each file owns its
    dictionary, so code-domain accumulators cannot merge; strings can."""
    return len(paths) > 1 and _str_dict_of(paths[0], column) is not None


def _local_accs(paths, column, feed) -> list:
    """`feed(acc, path)` for every path into one shared _StatAcc, or one per
    file for a string dataset: this rank's partial states."""
    accs = [_StatAcc() for _ in (paths if _per_file(paths, column) else paths[:1])]
    for i, p in enumerate(paths):
        feed(accs[min(i, len(accs) - 1)], p)
    return accs


def _combined_accs(part, paths, column, feed) -> list:
    """_local_accs on every rank, combined over the mesh: the merged
    accumulators."""
    states = shard._combine(part, lambda: _local_accs(paths, column, feed))
    return [_StatAcc.merged(col) for col in zip(*states)]


def _acc_results(paths, column, accs, with_n_null: bool = False) -> dict:
    """Merged accumulators -> the user's stats: a string column's codes map
    to its labels (file by file for a string dataset, then merged);
    `with_n_null` adds the headers' null count of a nullable column."""
    subs = []
    for p, acc in zip(paths, accs):  # one shared acc: the first file's labels
        d = _str_dict_of(p, column)
        subs.append(_map_str_result(acc.result(), d) if d is not None else acc.result())
    out = _merge_str_stats(subs) if len(subs) > 1 else subs[0]
    if with_n_null:
        nulls = [_column_layout(p, column)[6] for p in paths]
        if any(m is not None for m in nulls):
            out["n_null"] = sum(int(m["n_null"]) for m in nulls if m is not None)
    return out


def _scan_column_feed(column, device, part):
    """scan_column's feed: every run of this rank's chunks of `column`."""
    def feed(acc, p):
        for blocks, cdtype, vtype, valid, vmask in _decoded_chunks(
                p, column, device, natural=True, part=part):
            acc.feed(blocks, cdtype, vtype, valid, pred=vmask)
    return feed


@entry
def scan_column(path, column: Optional[str] = None, device=None,
                mesh=None) -> dict:
    """Sum/min/max/count over a compressed column (one path or a list of
    paths), decoded and reduced on the device run by run. Returns python
    scalars: {sum, min, max, count} (+ n_null for a nullable column).

    With `mesh` (parallel.make_mesh), each rank reads and reduces only its
    share of every file's chunks, and the exact partial states (Python-int
    sums, the float superaccumulator, counts, total-order keys) meet in ONE
    all_gather_object: every rank returns the answer without a mesh."""
    device, part = shard._placement(device, mesh)
    paths = _paths(path)
    accs = _combined_accs(part, paths, column, _scan_column_feed(column, device, part))
    return _acc_results(paths, column, accs, with_n_null=True)


@entry
def scan_table(path, columns=None, device=None, mesh=None) -> dict:
    """Single-pass stats over several (default: all) columns of an FLTTAB
    table file: the header parses once and every selected chunk is visited
    in payload-offset order, so the file is read sequentially exactly once
    no matter how many columns are scanned. Returns
    {column_name: {sum, min, max, count}}. With `mesh`, as scan_column:
    every column's partial state meets in ONE all_gather_object."""
    from . import fio_table

    device, part = shard._placement(device, mesh)
    paths = _paths(path)
    header = fio.header_of(paths[0], table=True).header
    names = list(header["columns"]) if columns is None else list(columns)
    cols = {name: fio_table._col_meta(header, name) for name in names}
    if len(paths) == 1:
        # Columns' payloads are laid out sequentially (write_table appends
        # one column's chunks after another), so scanning columns in
        # first-chunk offset order IS one sequential pass over the file;
        # within a column the batched generator merges same-signature
        # chunks into one launch.
        names.sort(key=lambda n: cols[n]["chunks"][0]["offset"]
                   if cols[n]["chunks"] else 0)

    def local():  # every column's accumulators over this rank's chunks
        return {name: _local_accs(paths, name, _scan_column_feed(name, device, part))
                for name in names}

    states = shard._combine(part, local)
    out = {}
    for name in names:
        accs = [_StatAcc.merged(a) for a in zip(*(st[name] for st in states))]
        out[name] = _acc_results(paths, name, accs, with_n_null=True)
    return out


@entry
def count_where(path, op: str, value, column: Optional[str] = None,
                device=None, mesh=None) -> int:
    """Filtered count: the predicate is evaluated on the decoded values on
    the device, and only the running count leaves it. Chunks whose zone map
    decides the predicate are never decoded. With `mesh`, each rank counts
    its own chunks (a chunk the zone map resolves counts on the rank that
    owns it) and the counts add in ONE all_gather_object."""
    if op not in _ALL_OPS:
        raise ValueError(f"unknown predicate {op!r}; have {sorted(_ALL_OPS)}")
    device, part = shard._placement(device, mesh)

    def local():
        total = 0
        for p in _paths(path):
            d = _str_dict_of(p, column)
            # string column: the predicate pushes down on THIS file's codes
            op_p, value_p = ((op, _probe_epoch(p, column, value)) if d is None
                             else _str_pred_to_code(d, op, value))
            # zone maps: 'none' chunks skip decode, 'all' chunks resolve from
            # the header alone (chunk row count minus its nulls)
            ds, chunks, n_values = _zone_decisions_col(p, column, op_p, value_p)
            lo, hi = shard._chunk_span(part, len(chunks))
            keep, start_v = [], 0
            for i, (meta, dec) in enumerate(zip(chunks, ds)):
                cap = meta["n_blocks"] * layout.BLOCK
                n_chunk = cap if n_values is None else max(
                    0, min(cap, n_values - start_v))
                start_v += cap
                if dec == "all" and lo <= i < hi:
                    total += n_chunk - meta.get("stats", {}).get("nn", 0)
                keep.append(dec == "maybe")
            if not any(keep[lo:hi]):
                continue
            if all(keep):
                keep = None
            for blocks, cdtype, vtype, valid, vmask in _decoded_chunks(
                    p, column, device, keep=keep, natural=True, part=part):
                if valid == 0:
                    continue
                flat = _flatten_logical(blocks, cdtype, vtype)
                mask = _pred_mask(flat, op_p, value_p)
                if vmask is not None:  # nulls match no predicate (not even 'ne')
                    mask = mask & vmask
                total += _count_masked(mask, valid)
        return total

    return sum(shard._combine(part, local))


@entry
def scan_where(path, op: str, value, column: Optional[str] = None,
               where: Optional[str] = None, device=None,
               window: Optional[int] = None, mesh=None) -> dict:
    """Filtered aggregation, selection and aggregation in one pass:
    sum/min/max/count over the rows matching `OP value`, decoded and
    reduced on the device per run (sums stay exact: the predicate just
    masks the reduction). `where` names the predicate column for table
    files (default: the aggregated column itself); a cross-column predicate
    requires the two columns to share block layout (equal length and
    chunking, the writer's default for equal-length columns) and walks both
    in lockstep, `window` chunks per launch (default 8; the result does not
    depend on it). Returns {sum, min, max, count} over matching rows. With
    `mesh`, as scan_column: each rank walks its own chunks (in lockstep,
    the same range of every column) and the partial states meet once."""
    if op not in _ALL_OPS:
        raise ValueError(f"unknown predicate {op!r}; have {sorted(_ALL_OPS)}")
    device, part = shard._placement(device, mesh)
    paths = _paths(path)
    accs = _combined_accs(part, paths, column, lambda acc, p: _scan_where_into(
        acc, p, op, value, column, where, device, window or _LOCKSTEP_WINDOW, part))
    return _acc_results(paths, column, accs)


def _scan_where_into(acc, path, op, value, column, where, device, window,
                     part=None):
    """One file's worth of filtered aggregation fed into a shared
    accumulator (string predicates translate against THIS file's
    dictionary); with a mesh `part`, this rank's chunks of it."""
    vdict = _str_dict_of(path, column)
    wdict = (vdict if where is None or where == column
             else _str_dict_of(path, where))
    if wdict is not None:  # string predicate column: compare codes
        op, value = _str_pred_to_code(wdict, op, value)
    else:
        value = _probe_epoch(path, where if where is not None else column,
                             value)

    if where is None or where == column:
        keep = _zone_keep(path, [(column, op, value)])
        for blocks, cdtype, vtype, valid, vmask in _decoded_chunks(
                path, column, device, keep=keep, natural=True, part=part):
            if valid == 0:
                continue
            flat = _flatten_logical(blocks, cdtype, vtype)
            pred = _pred_mask(flat, op, value)
            if vmask is not None:  # null rows neither match nor aggregate
                pred = pred & vmask
            acc.feed_flat(flat, valid, pred)
        return
    # cross-column predicate: walk both chunk streams in lockstep (both
    # sides share the zone-map keep so the walks stay aligned)
    keep = _zone_keep(path, [(where, op, value)], names=(column, where))
    for rows in _lockstep_chunks(path, (column, where), device, keep=keep,
                                 window=window, part=part):
        vb, vdt, vvt, v_valid, v_mask = rows[column]
        if v_valid == 0:
            continue
        pred = _chunk_row_mask(rows, [(where, op, value)])
        if v_mask is not None:  # null values don't aggregate (SQL SUM(col))
            pred = pred & v_mask
        acc.feed_flat(_flatten_logical(vb, vdt, vvt), v_valid, pred)


# ---------------------------------------------------------------------------
# multi-predicate filtering: several ANDed (column, op, value) predicates
# evaluated in lockstep over the chunk streams, the WHERE clause of a
# SQL-ish query. scan_where_multi and group_stats walk through here.


def _lockstep_chunks(path: str, names, device, keep=None,
                     window: int = _LOCKSTEP_WINDOW, part=None):
    """Walk several columns' chunk streams in lockstep, `window` chunks per
    part, so parts align row for row. Yields {name: (blocks, cdtype, vtype,
    valid, vmask)} per window; raises ValueError on mismatched layouts.
    `keep` (zone-map chunk flags) is shared: every column skips the same
    windows, so alignment survives. With a mesh `part` every column takes
    the same chunk range, so the layouts must agree chunk for chunk: that is
    checked from the headers first, on every rank alike."""
    if part is not None and len({_chunk_layout(path, n) for n in names}) > 1:
        raise ValueError(
            f"columns {sorted(names, key=str)} have mismatched chunk "
            "layouts; lockstep scans need equal length and chunking")
    iters = {n: _decoded_chunks(path, n, device, window=window, keep=keep,
                                part=part)
             for n in names}
    while True:
        with span("window"):
            rows = {n: next(it, None) for n, it in iters.items()}
        done = sum(r is None for r in rows.values())
        if done:
            if done != len(iters):
                raise ValueError(
                    f"columns {sorted(names, key=str)} have different chunk "
                    "counts; lockstep scans need equal length and chunking")
            return
        if len({(r[0].numel(), r[3]) for r in rows.values()}) != 1:
            raise ValueError(
                f"columns {sorted(names, key=str)} have mismatched chunk "
                "layouts; lockstep scans need equal length and chunking")
        yield rows


def _chunk_layout(path: str, column) -> tuple:
    """(blocks of every chunk, n_values) of a column, from its header."""
    chunks, _cd, _t, _vt, n_values = _column_layout(path, column)[:5]
    return tuple(m["n_blocks"] for m in chunks), n_values


def _normalize_preds(path: str, preds):
    """[(column, op, value)] -> the same with ops validated, string probes
    translated to THIS file's dictionary codes and temporal probes to
    epochs."""
    out = []
    for pcol, op, value in preds:
        if op not in _ALL_OPS:
            raise ValueError(
                f"unknown predicate {op!r}; have {sorted(_ALL_OPS)}")
        wdict = _str_dict_of(path, pcol)
        if wdict is not None:
            op, value = _str_pred_to_code(wdict, op, value)
        else:
            value = _probe_epoch(path, pcol, value)
        out.append((pcol, op, value))
    return out


@spanned("mask")
def _chunk_row_mask(rows, preds):
    """AND of every predicate's hit mask over one lockstep window (None
    without predicates); null predicate rows match nothing."""
    mask = None
    for pcol, op, value in preds:
        blocks, cdtype, vtype, _valid, vmask = rows[pcol]
        m = _pred_mask(_flatten_logical(blocks, cdtype, vtype), op, value)
        if vmask is not None:
            m = m & vmask
        mask = m if mask is None else mask & m
    return mask


@entry
def scan_where_multi(path, preds, column: Optional[str] = None,
                     device=None, mesh=None) -> dict:
    """Filtered aggregation with several ANDed predicates, the WHERE clause
    `p1 AND p2 AND ...` pushed down in one pass: each predicate is (column,
    op, value) (string probes compare as dictionary codes; null rows never
    match), and sum/min/max/count aggregate `column` over the surviving
    rows with the scans' exactness. Chunks a predicate's zone map rules out
    are not decoded. One host fetch per lockstep window. With `mesh`, as
    scan_where."""
    device, part = shard._placement(device, mesh)
    paths = _paths(path)
    raw_preds = list(preds)

    def feed(acc, p):
        preds_p = _normalize_preds(p, raw_preds)
        names = list(dict.fromkeys([q[0] for q in preds_p] + [column]))
        if None in names and len(names) > 1:
            raise ValueError("single-column files take column=None "
                             "predicates only; name table columns explicitly")
        keep = _zone_keep(p, preds_p, names=[n for n in names
                                             if n is not None])
        for rows in _lockstep_chunks(p, names, device, keep=keep, part=part):
            blocks, cdtype, vtype, valid, vmask = rows[column]
            if valid == 0:
                continue
            mask = _chunk_row_mask(rows, preds_p)
            if vmask is not None:  # null values don't aggregate
                mask = vmask if mask is None else mask & vmask
            acc.feed_flat(_flatten_logical(blocks, cdtype, vtype), valid, mask)

    return _acc_results(paths, column, _combined_accs(part, paths, column, feed))


# ---------------------------------------------------------------------------
# GROUP BY: per-group sum/min/max/count of a value column grouped by an
# integer key column, reduced on the device window by window with the scans'
# exactness. Rows that leave every group (tail padding, a null key or value,
# a failed WHERE, a key outside [0, k)) go to a trash slot k. On the card one
# kernel a window does the reduction (kernels/cuda_group.py); its plain
# version, which CPU tensors take, is torch (index_add_ for counts and sums,
# scatter_reduce_ amin/amax for extremes). Both keep the same int64 forms as
# the scans:
#
#   int   (values of up to 32 bits) [count, sum of the signed key]; the host
#         adds count * offset for unsigned columns
#   i64   (64-bit values, int64 semantics) [count, sum of the low 32-bit
#         halves, sum of the high halves]
#   f32 / [finite, NaN, +inf, -inf counts, then the superaccumulator bins
#   f64   of the scans, (sign, bucket, plane), per group]
#
# and the extremes on signed keys (total-order keys for floats, NaN rows
# left out). Every addend is under 2^32 in magnitude, so an int64 slot holds
# any 2^31 rows: the accumulator stays on the device across windows and
# files, and leaves it in ONE fetch per call (per 2^31 rows).

_GROUP_CAP_INT = 65536
_GROUP_CAP_FLOAT = 1024
#: few groups, or one hot group of a skewed key, put the atomic adds of a
#: window on a handful of addresses: a group accumulator is spread over
#: copies (the plain version: row i adds into copy i % S; the kernel: warp w
#: into copy w % S), as many as _GROUP_BYTES of device memory holds, at most
#: _SPREAD. An accumulator that fits in a block's shared memory on the card
#: keeps one copy: the kernel's blocks are its copies.
_GROUP_BYTES = 1 << 25
_GROUP_FLUSH_ROWS = 1 << 31


def _spread_of(slots: int, width: int) -> int:
    """Copies of an accumulator of `slots` slots of `width` int64 columns."""
    return max(1, min(_SPREAD, _GROUP_BYTES // (slots * width * 8)))


class _GroupAcc:
    """Per-group accumulator on the device, shared by every window and file
    of one group_stats call (see above). `mode`: "plain" (a CPU device, or
    `plain=True` on any device) feeds through feed_plain; "shared" and
    "global" through the card's kernel, "shared" where the accumulator fits
    in the shared memory one block may take (cuda_group.fits_shared)."""

    def __init__(self, k: int, flat: _Flat, device, plain: bool = False):
        self.k = k
        self.kind = ("i64" if flat.bits == 64 else "int") \
            if flat.kind == "int" else flat.kind
        self.offset = flat.offset
        if self.kind == "int":
            self.n_cols = 2
        elif self.kind == "i64":
            self.n_cols = 3
        else:
            _dt, _e, _f, planes, buckets, _d = _FLOAT_SPEC[self.kind]
            self.n_cols = 4 + 2 * buckets * planes
        device = torch.device(device)
        if plain or device.type != "cuda":
            self.mode = "plain"
        elif cuda_group.fits_shared(k, self.n_cols, cuda_group.shared_bytes(device)):
            self.mode = "shared"
        else:
            self.mode = "global"
        self.spread = 1 if self.mode == "shared" else _spread_of(k + 1, self.n_cols + 2)
        slots = self.spread * (k + 1)
        self.add = torch.zeros(slots * self.n_cols, dtype=torch.int64,
                               device=device)
        self.mn = torch.full((slots,), _imax(torch.int64), dtype=torch.int64,
                             device=device)
        self.mx = torch.full((slots,), _imin(torch.int64), dtype=torch.int64,
                             device=device)
        self.rows = 0
        self.parts = []  # fetched (sums (k, n_cols), mins (k,), maxs (k,))

    @spanned("acc")
    def feed(self, flat_k: _Flat, flat_v: _Flat, valid: int, mask):
        """One lockstep window: group numbers from `flat_k`, values from
        `flat_v`, the first `valid` rows, `mask` (None or a bool tensor)
        keeping rows."""
        if self.rows + valid >= _GROUP_FLUSH_ROWS:
            self.flush()
        self.rows += valid
        if self.mode == "plain":
            self.feed_plain(flat_k, flat_v, valid, mask)
        else:
            cuda_group.feed(flat_k.key, flat_k.offset, flat_v.key, self.kind, valid, mask,
                            self.k, self.add, self.mn, self.mx, self.spread,
                            self.mode == "shared")

    def feed_plain(self, flat_k: _Flat, flat_v: _Flat, valid: int, mask):
        """The kernel's plain version: feed's reduction in torch, on any
        device, into the accumulator's spread copies (row i into copy
        i % spread)."""
        k = self.k
        g = flat_k.key[:valid].to(torch.int64) + flat_k.offset
        # a negative key indexes from the end, as the reference's scatter
        # does (reachable only under an explicit max_groups)
        g = torch.where(g < 0, g + (k + 1), g)
        ok = (g >= 0) & (g < k)
        if mask is not None:
            ok = ok & mask[:valid]
        g = torch.where(ok, g, k)
        copy = 0
        if self.spread > 1:
            copy = (torch.arange(valid, device=g.device) % self.spread) * (k + 1)
        slot = g + copy
        x = flat_v.key[:valid]
        ones = torch.ones(valid, dtype=torch.int64, device=g.device)
        cols = self.n_cols
        if self.kind == "int":
            self.add.index_add_(0, slot * cols, ones)
            self.add.index_add_(0, slot * cols + 1, x.to(torch.int64))
            ext, ext_slot = x.to(torch.int64), slot
        elif self.kind == "i64":
            self.add.index_add_(0, slot * cols, ones)
            self.add.index_add_(0, slot * cols + 1, x & 0xFFFFFFFF)
            self.add.index_add_(0, slot * cols + 2, x >> 32)
            ext, ext_slot = x, slot
        else:
            kind = self.kind
            _dt, _e, fbits, planes, buckets, _d = _FLOAT_SPEC[kind]
            sign, exp, frac, special = _float_fields(x, kind)
            is_nan = special & (frac != 0)
            # column 0 finite, 1 NaN, 2 +inf, 3 -inf
            cls = torch.where(special, torch.where(is_nan, 1, 2 + sign), 0)
            self.add.index_add_(0, slot * cols + cls, ones)
            ep = exp.clamp(min=1)
            m = torch.where(special, 0, frac | ((exp > 0).to(x.dtype) << fbits))
            shifted = m << (ep & 7)
            bins = slot * cols + 4 + (sign * buckets + (ep >> 3)) * planes
            for p in range(planes):
                plane = (shifted >> (32 * p)) & 0xFFFFFFFF if planes > 1 else shifted
                self.add.index_add_(0, bins + p, plane.to(torch.int64))
            ext = _total_order_key(x, kind).to(torch.int64)
            ext_slot = torch.where(is_nan, k, g) + copy
        self.mn.scatter_reduce_(0, ext_slot, ext, "amin")
        self.mx.scatter_reduce_(0, ext_slot, ext, "amax")

    @spanned("acc")
    def flush(self) -> None:
        """Fold the spread copies on the device and fetch the k groups (the
        trash slot stays behind) in ONE copy; reset the device state."""
        if not self.rows:
            return
        k, s, c = self.k, self.spread, self.n_cols
        sums, mins, maxs = self.add.view(s, k + 1, c), self.mn.view(s, k + 1), self.mx.view(s, k + 1)
        # one copy (the kernel's SHARED mode) has nothing to fold
        sums, mins, maxs = ((sums.sum(0), mins.amin(0), maxs.amax(0)) if s > 1
                            else (sums[0], mins[0], maxs[0]))
        out = _fetch_np(torch.cat([sums[:k].reshape(-1), mins[:k], maxs[:k]]))
        self.parts.append((out[:k * c].reshape(k, c), out[k * c:k * c + k],
                           out[k * c + k:]))
        self.add.zero_()
        self.mn.fill_(_imax(torch.int64))
        self.mx.fill_(_imin(torch.int64))
        self.rows = 0

    def host_state(self) -> tuple:
        """(kind, offset, fetched parts): this accumulator's exact state on
        the host, after one flush. The parts of several accumulators of one
        group count concatenate (`_group_result`)."""
        self.flush()
        return self.kind, self.offset, self.parts

    def result(self) -> dict:
        """{group: {sum, min, max, count}} for the non-empty groups, in
        ascending group number; Python ints and floats."""
        return _group_result(*self.host_state())


def _group_result(kind, offset, parts) -> dict:
    """The groups of fetched accumulator `parts` (see _GroupAcc.flush):
    counts, sums and float bins add, extremes take their min / max."""
    if not parts:
        return {}
    n_count = 4 if kind in ("f32", "f64") else 1
    counts = sum(p[0][:, :n_count].sum(1) for p in parts)
    mins = np.minimum.reduce([p[1] for p in parts])
    maxs = np.maximum.reduce([p[2] for p in parts])
    groups = np.flatnonzero(counts)
    if kind in ("int", "i64"):
        # exact Python ints (object arrays), added over the fetches
        sums = sum(p[0][groups, 1:].astype(object) for p in parts)
        if kind == "int":
            total = sums[:, 0] + counts[groups].astype(object) * offset
        else:
            total = (sums[:, 1] << 32) + sums[:, 0]
        return {g: {"sum": s, "min": mn + offset, "max": mx + offset, "count": c}
                for g, s, mn, mx, c in zip(
                    groups.tolist(), total.tolist(), mins[groups].tolist(),
                    maxs[groups].tolist(), counts[groups].tolist())}
    denom_bits = _FLOAT_SPEC[kind][5]
    out = {}
    for g in groups.tolist():
        n_nan, n_pinf, n_ninf = (sum(int(p[0][g, j]) for p in parts)
                                 for j in (1, 2, 3))
        if n_nan or (n_pinf and n_ninf):
            total = float("nan")
        elif n_pinf:
            total = float("inf")
        elif n_ninf:
            total = float("-inf")
        else:
            num = sum(_float_bins_to_int(p[0][g, 4:], kind) for p in parts)
            total = float(Fraction(num, 1 << denom_bits)) if num else 0.0
        if n_nan:
            mn = mx = float("nan")
        else:
            mn = _float_of_key(int(mins[g]), kind)
            mx = _float_of_key(int(maxs[g]), kind)
        out[g] = {"sum": total, "min": mn, "max": mx, "count": int(counts[g])}
    return out


def _merged_group_result(states) -> dict:
    """The ranks' host states of one group count (None: a rank that fed
    nothing) -> the groups, as one accumulator fed every rank's rows."""
    fed = [st for st in states if st is not None]
    if not fed:
        return {}
    return _group_result(fed[0][0], fed[0][1], [p for st in fed for p in st[2]])


def _merge_group_results(subs, str_value: bool) -> dict:
    """Merge per-file group_stats results (string-keyed or string-valued
    datasets: each file owns its dictionaries, so merging happens at the
    label level). Integer sums add exactly; float sums add the per-file
    exactly-rounded totals."""
    out = {}
    for sub in subs:
        for g, s in sub.items():
            cur = out.get(g)
            if cur is None:
                out[g] = cur = dict(s)
                cur.pop("n_dict", None)  # per-file dictionary size
                continue
            cur["count"] += s["count"]
            if str_value:
                cur["min"] = min(cur["min"], s["min"])
                cur["max"] = max(cur["max"], s["max"])
            else:
                cur["sum"] = cur["sum"] + s["sum"]
                cur["min"] = _merge_extreme(cur["min"], s["min"], min)
                cur["max"] = _merge_extreme(cur["max"], s["max"], max)
    return out


def _stats_summary(paths, column):
    """scan_column-compatible {count, min, max, nan} from the zone maps
    alone (no decode), or None when any chunk lacks stats. min/max in the
    scans' comparison conventions (logical ints, int64 semantics for 64-bit
    carriers, floats as floats, string columns as dictionary codes); count
    excludes nulls, `nan` flags any NaN."""
    total, lo, hi, nan = 0, None, None, False
    for p in paths:
        try:
            chunks, _cd, _t, _vt, n_values, _b, nulls = _column_layout(
                p, column)
        except (ValueError, KeyError):
            return None
        total += _n_rows(chunks, n_values) - (int(nulls["n_null"]) if nulls else 0)
        for m in chunks:
            st = m.get("stats")
            if not isinstance(st, dict):
                return None
            if st.get("nan"):
                nan = True
            if "lo" in st:
                lo = st["lo"] if lo is None or st["lo"] < lo else lo
                hi = st["hi"] if hi is None or st["hi"] > hi else hi
    return {"count": total, "min": lo, "max": hi, "nan": nan}


def _group_count(paths, key, kdict, max_groups, device, mesh) -> Optional[int]:
    """The group count k of a group_stats call over `paths` (None: the
    answer is empty): `max_groups`, the key's dictionary size, or the key
    range from the zone maps or one key scan."""
    if max_groups is not None:
        return int(max_groups)
    if kdict is not None:
        return int(kdict.size) or None
    # the group count needs the key range only: header-only when zone maps
    # cover the column, one key scan otherwise
    ks = _stats_summary(paths, key)
    if ks is None:
        ks = scan_column(paths, column=key, device=device, mesh=mesh)
    if ks["count"] == 0:
        return None
    if ks["min"] < 0:
        raise ValueError(f"group keys must be >= 0; {key!r} has "
                         f"min {ks['min']}")
    return int(ks["max"]) + 1


def _group_walk(paths, key, value, k, raw_preds, device, part):
    """This rank's chunks of `paths` grouped into one _GroupAcc: its host
    state, or None when no window was walked."""
    acc = None
    for p in paths:
        preds_p = _normalize_preds(p, raw_preds)
        names = list(dict.fromkeys([key, value] + [q[0] for q in preds_p]))
        keep = _zone_keep(p, preds_p, names=names)
        for rows in _lockstep_chunks(p, names, device, keep=keep, part=part):
            kb, kdt, kvt, _k_valid, k_mask = rows[key]
            vb, vdt, vvt, v_valid, v_mask = rows[value]
            flat_v = _flatten_logical(vb, vdt, vvt)
            flat_k = _flatten_logical(kb, kdt, kvt)
            if flat_k.kind != "int" or flat_k.bits == 64:
                raise ValueError(
                    f"group key column {key!r} must be an integer column of "
                    "width <= 32 (u8/u16/u32 or signed)")
            if v_valid == 0:
                continue
            mask = k_mask
            if v_mask is not None:
                mask = v_mask if mask is None else mask & v_mask
            if preds_p:  # WHERE: failing rows leave every group
                pm = _chunk_row_mask(rows, preds_p)
                mask = pm if mask is None else mask & pm
            if flat_v.kind != "int" and k > _GROUP_CAP_FLOAT:
                raise ValueError(
                    f"group_stats over float columns caps at "
                    f"{_GROUP_CAP_FLOAT} groups (got {k})")
            if flat_v.kind == "int" and flat_v.bits < 64 and k > _GROUP_CAP_INT:
                # (64-bit values have no cap, as in the reference)
                raise ValueError(f"group_stats caps at {_GROUP_CAP_INT} "
                                 f"groups (got {k})")
            if acc is None:
                acc = _GroupAcc(k, flat_v, flat_v.key.device)
            acc.feed(flat_k, flat_v, v_valid, mask)
    return None if acc is None else acc.host_state()


@entry
def group_stats(path, key: str, value: str, max_groups: Optional[int] = None,
                device=None, preds=(), mesh=None) -> dict:
    """GROUP BY pushdown over a compressed table file: per-group
    sum/min/max/count of the `value` column grouped by the integer `key`
    column, decoded and reduced on the device with the scans' exactness
    (integer sums exact, float sums exactly rounded). Keys must be
    non-negative integers of up to 32 bits; the group count comes from the
    key's zone maps (or a key scan) unless `max_groups` is given (caps:
    65536 for integer values, 1024 for float values, the reference's). The
    columns must share block layout (equal length and chunking). Returns
    {group: {sum, min, max, count}} for the non-empty groups, in ascending
    group number. A STRING `key` groups by its dictionary codes and labels
    the result with the strings; a string `value` aggregates lexicographic
    min/max/count (sum is None). A LIST of paths: integer-keyed numeric
    groups share one exact accumulator; string-keyed or string-valued
    groups merge per-file results. `preds` ANDs (column, op, value) WHERE
    predicates before grouping, with zone-map chunk pruning.

    With `mesh`, each rank groups its own chunks (the same range of every
    column) and the accumulators, their spread copies folded, meet in ONE
    all_gather_object of their fetched counts, sums, float bins and
    extremes; every rank returns the answer without a mesh. (Without zone
    maps on the key, the key scan that sizes the groups is a combine of its
    own.)"""
    device, part = shard._placement(device, mesh)
    paths = _paths(path)
    kdict = _str_dict_of(paths[0], key)
    vdict = _str_dict_of(paths[0], value)
    raw_preds = list(preds)
    # string-keyed or string-valued datasets group file by file
    per_file = len(paths) > 1 and (kdict is not None or vdict is not None)
    sets = [[p] for p in paths] if per_file else [paths]
    ks = [_group_count(ps, key, _str_dict_of(ps[0], key), max_groups, device, mesh)
          for ps in sets]

    def local():
        return [None if k is None else _group_walk(ps, key, value, k, raw_preds, device, part)
                for ps, k in zip(sets, ks)]

    states = shard._combine(part, local)
    subs = []
    for i, ps in enumerate(sets):
        out = _merged_group_result([st[i] for st in states])
        vd, kd = _str_dict_of(ps[0], value), _str_dict_of(ps[0], key)
        if vd is not None:  # string value column: codes -> labels
            out = {g: _map_str_result(s, vd) for g, s in out.items()}
        if kd is not None:  # string key column: label groups
            out = {str(kd[g]): s for g, s in out.items()}
        subs.append(out)
    return _merge_group_results(subs, vdict is not None) if per_file else subs[0]


# ---------------------------------------------------------------------------
# distinct / value_counts / top_k / quantile: the remaining pushdowns.
# distinct reads dictionaries and run values without decoding (host only);
# value_counts counts searchsorted codes of a device dictionary; top_k keeps
# k candidates per decoded run on signed keys; quantile counts.

_VALUE_COUNTS_CAP = 65536


@entry
def distinct(path, column: Optional[str] = None) -> np.ndarray:
    """Sorted distinct values of a compressed column, on the host: dict
    chunks read only their dictionaries and rle chunks only their run values
    (no decode at all); string columns return their sorted dictionary;
    other codecs decode chunk by chunk and merge. Tail padding repeats the
    final value, so it never adds a distinct value."""
    paths = _paths(path)
    if len(paths) > 1:  # sharded dataset: exact union of per-file sets
        parts = [p for p in (distinct(q, column) for q in paths) if p.size]
        if not parts:
            return distinct(paths[0], column)
        return np.unique(np.concatenate(parts))
    return _distinct_of(paths[0], column)


def _distinct_of(path, column, part=None) -> np.ndarray:
    """distinct of one file; with a mesh `part`, of this rank's chunks only
    (the ranks' sets unite to the file's)."""
    (chunks, cdtype, transform, vtype, n_values, base_off,
     nulls_meta) = _column_layout(path, column)
    d = _str_dict_of(path, column)
    if nulls_meta is not None and _all_null(chunks, n_values, nulls_meta):
        # all null: the fillers are synthetic (otherwise every filler copies
        # a value that also occurs non-null, so the set is unaffected)
        return np.empty(0, d.dtype if d is not None else layout.np_dtype(cdtype))
    if d is not None:
        return d.copy()  # built from the data: every entry occurs
    parts = []
    lo, hi = shard._chunk_span(part, len(chunks))
    with open(path, "rb") as f:
        for meta in chunks[lo:hi]:
            f.seek(base_off + meta["offset"])
            raw = f.read(meta["nbytes"])
            if meta["codec"] == "dict":
                vals, _ = fio._split_dict_payload(meta, raw, meta["n_blocks"],
                                                  cdtype)
            elif meta["codec"] == "rle":
                vals = np.unique(fio._split_rle_payload(
                    meta, raw, meta["n_blocks"], cdtype)[3])
            else:
                vals = np.unique(fio._decode_chunk(
                    meta, raw, meta["n_blocks"], cdtype).reshape(-1))
            parts.append(np.asarray(vals))
    if not parts:
        return np.empty(0, layout.np_dtype(cdtype))
    merged = np.unique(np.concatenate(parts))
    if transform is not None:  # transforms reorder the wire domain
        merged = np.unique(fio.apply_inverse_transform(merged, transform))
    if vtype == "bool":
        return merged.astype(bool)
    if vtype is not None and vtype.startswith(("datetime64", "timedelta64")):
        return merged.view(np.dtype(vtype))  # int64 order == temporal order
    return merged


def _n_rows(chunks, n_values) -> int:
    return (n_values if n_values is not None
            else sum(c["n_blocks"] for c in chunks) * layout.BLOCK)


def _all_null(chunks, n_values, nulls_meta) -> bool:
    return nulls_meta["n_null"] >= _n_rows(chunks, n_values)


def _holds_a_value(chunks, n_values, nulls_meta) -> bool:
    """True if the column has a non-null row: neither 0 rows nor all null."""
    n_null = nulls_meta["n_null"] if nulls_meta is not None else 0
    return _n_rows(chunks, n_values) > n_null


@entry
def value_counts(path, column: Optional[str] = None,
                 max_values: int = _VALUE_COUNTS_CAP, device=None,
                 mesh=None) -> dict:
    """{value: count} over a compressed column, exact. The distinct set
    (see `distinct`) becomes a sorted device dictionary in the column's key
    domain; each decoded run counts its searchsorted codes with index_add_
    on the device, and the counts leave it in ONE fetch. String columns
    count their dictionary codes directly. Capped at `max_values` distinct
    values; float columns raise, and so do 64-bit columns: the reference
    refuses them (its device has no 64-bit integers), and the port keeps
    the refusal for parity.

    With `mesh`, each rank takes the distinct set of its own chunks and
    counts them against it; the (values, counts) of every rank meet in ONE
    all_gather_object, and the cap is checked on their union, the file's
    distinct set."""
    device, part = shard._placement(device, mesh)
    paths = _paths(path)
    states = shard._combine(part, lambda: [
        _value_counts_local(p, column, max_values, device, part) for p in paths])
    merged = {}
    for i, p in enumerate(paths):
        for val, cnt in _value_counts_merge(
                p, column, max_values, [st[i] for st in states]).items():
            merged[val] = merged.get(val, 0) + cnt
    if len(paths) > 1 and len(merged) > max_values:  # sharded dataset
        raise ValueError(f"{len(merged)} distinct values exceed "
                         f"max_values={max_values}")
    return merged


def _value_counts_local(path, column, max_values, device, part):
    """One file's counts on this rank: (its values, their counts), the
    counts None where the values alone pass the cap (the union is then
    over it too)."""
    d = _str_dict_of(path, column)
    if d is None:
        chunks, cdtype, _t, vtype, n_values, _b, nulls_meta = _column_layout(
            path, column)
        # the refusals, from the header: the reference finds the same dtype
        # after a host pass over the whole column (a 0-row or all-null
        # column has the carrier's dtype there)
        if _holds_a_value(chunks, n_values, nulls_meta):
            if vtype in ("f32", "f64"):
                raise ValueError("value_counts over float columns is "
                                 "ill-defined; use group_stats or top_k")
            if layout.bit_width(cdtype) == 64:
                raise ValueError("value_counts over 64-bit columns is not "
                                 "supported without x64; use group_stats")
        vals = _distinct_of(path, column, part)
        if vals.dtype.itemsize * 8 == 64:
            raise ValueError("value_counts over 64-bit columns is not "
                             "supported without x64; use group_stats")
    else:
        vals = d
    kcap = int(vals.size)
    if kcap > max_values:
        return vals, None
    # one slot per value and a trash slot, spread as the group accumulator is
    spread = _spread_of(kcap + 1, 1)
    counts = torch.zeros(spread * (kcap + 1), dtype=torch.int64, device=device)
    sset = None
    for blocks, cdtype, vtype, valid, vmask in (() if kcap == 0 else _decoded_chunks(
            path, column, device, natural=True, part=part)):
        if valid == 0:
            continue
        flat = _flatten_logical(blocks, cdtype, vtype).head(valid)
        if d is not None:  # string codes
            codes = flat.key.to(torch.int64) + flat.offset
        else:
            if sset is None:  # the dictionary in the key's own domain
                keys = vals.astype(np.uint8) if vals.dtype == bool else vals
                sset = torch.from_numpy(keys.astype(np.int64) - flat.offset
                                        ).to(device=device, dtype=flat.key.dtype)
            codes = torch.searchsorted(sset, flat.key)
        if vmask is not None:  # null rows count nowhere
            codes = torch.where(vmask[:valid], codes, kcap)
        if spread > 1:
            codes = codes + (torch.arange(valid, device=codes.device) % spread) * (kcap + 1)
        counts.index_add_(0, codes, torch.ones_like(codes))
    if kcap == 0:
        return vals, np.zeros(0, np.int64)
    return vals, _fetch_np(counts.view(spread, kcap + 1).sum(0)[:kcap])


def _value_counts_merge(path, column, max_values, states) -> dict:
    """The ranks' (values, counts) of one file -> {value: count}."""
    vals = states[0][0]
    held = [v for v, _ in states if v.size]  # a rank without chunks: the carrier's dtype
    if len(held) > 1:  # the ranks' sets unite to the file's
        vals = np.unique(np.concatenate(held))
    elif held:
        vals = held[0]
    if vals.size > max_values:
        raise ValueError(f"{vals.size} distinct values exceed "
                         f"max_values={max_values}")
    got = np.zeros(vals.size, np.int64)
    for v, c in states:
        np.add.at(got, np.searchsorted(vals, v), c)
    got = got.tolist()
    if _str_dict_of(path, column) is not None:
        return {str(vals[i]): c for i, c in enumerate(got) if c}
    if vals.dtype == bool:
        return {bool(vals[i]): c for i, c in enumerate(got) if c}
    return {int(vals[i]): c for i, c in enumerate(got) if c}


def _chunk_top(flat: _Flat, ok, kk: int, largest: bool) -> torch.Tensor:
    """One decoded run's top-kk keys, best first, as ONE int64 tensor
    (behind the count of kept rows when `ok` masks rows). Keys are signed
    and ordered like the values: the int key, or the IEEE total-order key of
    a float (NaN above +inf, -NaN below -inf). Masked rows take the worst
    key; a caller keeping only the first n_ok never sees one (a masked row
    can only tie a kept row of the very same key)."""
    key = flat.key if flat.kind == "int" else _total_order_key(flat.key, flat.kind)
    key = key.to(torch.int64)
    if ok is not None:
        key = torch.where(ok, key, _imin(torch.int64) if largest
                          else _imax(torch.int64))
    top = torch.topk(key, kk, largest=largest, sorted=True).values
    if ok is None:
        return top
    return torch.cat([ok.sum(dtype=torch.int64).reshape(1), top])


def _bound_int(key_tuple) -> int:
    """A zone-map bound (the reference's unsigned key tuple, (hi, lo) for
    64 bits) as one unsigned int."""
    out = 0
    for part in key_tuple:
        out = (out << 32) | int(part)
    return out


@entry
def top_k(path, column: Optional[str] = None, k: int = 10,
          largest: bool = True, device=None, mesh=None) -> list:
    """The k largest (or smallest) values of a compressed column,
    duplicates included, best first. Each decoded run reduces to k
    candidates on the device (torch.topk on one signed int64 key: ints by
    value, u64 with the scans' int64 semantics; floats by IEEE total order,
    NaN above +inf and -NaN below -inf; strings by dictionary code); only
    those reach the host merge. Null rows never rank. Runs are visited
    best-zone-map-bound first in growing batches, and the walk stops once
    the k-th candidate beats every remaining chunk's bound. With `mesh`,
    each rank takes the k best of its own chunks, and the candidates meet
    in ONE all_gather_object and merge as the runs' candidates do."""
    if k <= 0:
        return []
    device, part = shard._placement(device, mesh)
    paths = _paths(path)
    states = shard._combine(part, lambda: [
        _top_k_local(p, column, k, largest, device, part) for p in paths])
    per_file = [_top_k_values(p, column, k, largest, [st[i] for st in states])
                for i, p in enumerate(paths)]
    if len(paths) == 1:
        return per_file[0]
    # sharded dataset: exact k-candidate value merge

    def keyf(v):  # IEEE total order: +NaN above +inf, -NaN below -inf
        if isinstance(v, float) and math.isnan(v):
            return (-1 if math.copysign(1.0, v) < 0 else 1, 0.0)
        return (0, v)

    return sorted([v for vals in per_file for v in vals], key=keyf, reverse=largest)[:k]


def _top_k_local(path, column, k, largest, device, part):
    """One file's best k keys on this rank (its chunks only): (domain,
    candidates), domain = (kind, bits, offset) of the keys once a row
    ranked, else None."""
    cands = []  # signed keys (see _chunk_top)
    domain = None

    def visit(keep):
        nonlocal domain
        for blocks, cdtype, vtype, valid, vmask in _decoded_chunks(
                path, column, device, keep=keep, natural=True, part=part):
            if valid == 0:
                continue
            flat = _flatten_logical(blocks, cdtype, vtype).head(valid)
            ok = None if vmask is None else vmask[:valid]
            got = _fetch(_chunk_top(flat, ok, min(k, valid), largest))
            n_ok = valid if ok is None else got.pop(0)
            if n_ok:
                domain = (flat.kind, flat.bits, flat.offset)
                cands.extend(got[:n_ok])

    chunks, cdtype_l, transform_l, vtype_l, _nv, _bo, _nm = _column_layout(
        path, column)
    zkind, zbits = zonemaps.topk_kind(cdtype_l, vtype_l, transform_l)
    lo, hi = shard._chunk_span(part, len(chunks))
    bounds = {i: zonemaps.topk_bound(chunks[i], zkind, zbits, largest)
              for i in range(lo, hi)}
    order = [i for i, b in bounds.items() if b is not None]
    order.sort(key=lambda i: bounds[i], reverse=largest)
    if len(order) == hi - lo and all("stats" not in chunks[i] for i in order):
        visit(None)  # no zone maps anywhere: one grouped pass
    else:
        pos, batch = 0, 1
        while pos < len(order):
            if len(cands) >= k:
                # the bounds are the reference's UNSIGNED keys: a signed key
                # maps onto them by adding 2^(bits-1) (the flipped top bit)
                kth = sorted(cands, reverse=largest)[k - 1] + \
                    (1 << (domain[1] - 1))
                b = _bound_int(bounds[order[pos]])
                if (b < kth) if largest else (b > kth):
                    break  # no remaining chunk can beat the k-th candidate
            take = order[pos:pos + batch]
            pos += batch
            batch *= 4
            kl = [False] * len(chunks)
            for i in take:
                kl[i] = True
            visit(kl)
    return domain, sorted(cands, reverse=largest)[:k]


def _top_k_values(path, column, k, largest, states) -> list:
    """The ranks' (domain, candidates) of one file -> its k best values."""
    domains = [dom for dom, _ in states if dom is not None]
    if not domains:
        return []
    kind, _bits, offset = domains[0]
    best = sorted([c for _, cands in states for c in cands], reverse=largest)[:k]
    d = _str_dict_of(path, column)
    if d is not None:
        return [str(d[c + offset]) for c in best]
    if kind != "int":
        return [_float_of_key(c, kind) for c in best]
    out = [c + offset for c in best]
    vtype = _column_layout(path, column)[3]
    if vtype == "bool":
        return [bool(v) for v in out]
    if vtype is not None and vtype.startswith(("datetime64", "timedelta64")):
        dt = np.dtype(vtype)
        return [np.int64(v).view(dt) for v in out]
    return out


@entry
def quantile(path, column: Optional[str] = None, q=0.5, device=None, mesh=None):
    """EXACT quantile of a compressed column (lower interpolation: the value
    at zero-based rank floor(q*(n-1)) of the sorted non-null values, numpy's
    method='lower'). Accepts a scalar q or a list.

    When the distinct set fits value_counts, ONE counting pass answers every
    q. Otherwise a binary search in the column's own key space runs
    count_where('le', mid) per step (~32 counts for 32-bit ints, ~64 for
    64-bit ints and f64), each exact. Columns holding NaN return NaN (numpy
    semantics); an empty or all-null column returns None. With `mesh`, every
    count it takes (scan_column without zone maps, value_counts, each
    count_where step) is sharded and combined once, so every rank walks the
    same search and returns the same answer."""
    device = shard._placement(device, mesh)[0]
    qs = np.atleast_1d(np.asarray(q, np.float64))
    if ((qs < 0) | (qs > 1)).any():
        raise ValueError("quantiles must be in [0, 1]")
    # zone maps make the leading summary free: count from the headers,
    # min/max/NaN from the chunk stats (string columns keep the scan: their
    # min/max are labels, not codes)
    s = (None if _str_dict_of(_paths(path)[0], column) is not None
         else _stats_summary(_paths(path), column))
    if s is not None and s["nan"]:
        s = {"count": s["count"], "min": float("nan"), "max": float("nan")}
    if s is None:
        s = scan_column(path, column=column, device=device, mesh=mesh)
    n = s["count"]
    scalar = np.isscalar(q) or np.asarray(q).ndim == 0
    if n == 0:
        return None if scalar else [None] * len(qs)
    if isinstance(s["min"], float) and np.isnan(s["min"]):
        return float("nan") if scalar else [float("nan")] * len(qs)
    ranks = [int(np.floor(qq * (n - 1))) for qq in qs]

    try:  # one counting pass over the distinct set
        vc = value_counts(path, column=column, device=device, mesh=mesh)
    except ValueError:
        vc = None
    if vc is not None:
        keys = sorted(vc)
        cum = np.cumsum([vc[kk] for kk in keys])
        out = [keys[int(np.searchsorted(cum, r + 1))] for r in ranks]
        return out[0] if scalar else out

    is_float = isinstance(s["min"], float)
    if is_float:
        # search the column's OWN key space: an f32 column probes with f32
        # values, or count_where's rounding would desync the search
        f32 = _column_layout(_paths(path)[0], column)[3] == "f32"
        bits = 32 if f32 else 64
        fmt = "<f" if f32 else "<d"
        ufmt = "<I" if f32 else "<Q"
        top = 1 << (bits - 1)
        ones = (1 << bits) - 1

        def to_key(v):  # the total-order key as one unsigned Python int
            b = struct.unpack(ufmt, struct.pack(fmt, v))[0]
            return (~b & ones) if b >> (bits - 1) else b | top

        def of_key(kk):
            b = (kk ^ top) if kk >> (bits - 1) else (~kk & ones)
            return struct.unpack(fmt, struct.pack(ufmt, b))[0]
    else:
        to_key = of_key = int

    out = []
    for r in ranks:
        lo, hi = to_key(s["min"]), to_key(s["max"])
        while lo < hi:
            mid = (lo + hi) // 2
            probe = of_key(mid)
            if is_float and not (s["min"] <= probe <= s["max"]):
                probe = min(max(probe, s["min"]), s["max"])
            if count_where(path, "le", probe, column=column,
                           device=device, mesh=mesh) >= r + 1:
                hi = mid
            else:
                lo = mid + 1
        out.append(of_key(lo))
    return out[0] if scalar else out


@entry
def median(path, column: Optional[str] = None, device=None, mesh=None):
    """Exact median (see quantile)."""
    return quantile(path, column=column, q=0.5, device=device, mesh=mesh)


# ---------------------------------------------------------------------------
# Row materialisation: select (projection + WHERE, ORDER BY ... LIMIT) and the
# dimension join. The predicates, the per-window top-k and the key match run
# on the device; only the chosen rows cross to the host, gathered there by
# index_select on the raw bits of each decoded part. Host fetches per lockstep
# window: one for the row count (`torch.nonzero`), or in a top-k one for the
# window's candidates, and one for the values of every projected column (with
# validity masks, a join's right-row indices) in a single copy.


def _logical_vt(col_meta: dict):
    """The column's logical vtype when it rides integer storage (bool /
    datetime64[*] / timedelta64[*]), else None."""
    vt = col_meta.get("vtype")
    if vt == "bool" or (vt or "").startswith(("datetime64", "timedelta64")):
        return vt
    return None


_NP_OF_TORCH = {torch.uint8: np.uint8, torch.uint16: np.uint16, torch.uint32: np.uint32,
                torch.uint64: np.uint64, torch.int8: np.int8, torch.int16: np.int16,
                torch.int32: np.int32, torch.int64: np.int64, torch.float32: np.float32,
                torch.float64: np.float64, torch.bool: np.bool_}


@spanned("fetch")
def _rows_of(mask) -> torch.Tensor:
    """Device row indices where `mask` holds. `torch.nonzero` sizes its
    output on the host: one fetch (the count)."""
    global HOST_FETCHES
    HOST_FETCHES += 1
    return torch.nonzero(mask).flatten()


def _fetch_many(tensors) -> list:
    """1-D device tensors -> numpy arrays of the same dtypes in ONE copy: their
    bytes go to the host concatenated and are split there."""
    parts = [t.contiguous().view(torch.uint8) for t in tensors]
    flat = _fetch_np(torch.cat(parts))
    out, at = [], 0
    for t, p in zip(tensors, parts):
        out.append(flat[at:at + p.numel()].view(_NP_OF_TORCH[t.dtype]))
        at += p.numel()
    return out


def _raw_flat(blocks) -> torch.Tensor:
    """A decoded part's flat values as a signed integer tensor of the same
    bits: gathers move bits, and torch has few ops on unsigned dtypes on the
    CPU."""
    arr = blocks.reshape(-1)
    return arr.view(_INT_OF_BITS[arr.element_size() * 8])


def _host_values(raw: np.ndarray, tdtype, transform_signed, str_dict, logical):
    """Fetched raw bits of a column (the signed view of the decoded dtype
    `tdtype`) -> host values in the user-facing domain, the JAX package's
    dtypes: unsigned and signed ints as stored, 64-bit ints as uint64 or, for
    a signed transform, int64, temporal columns in their datetime64[*] /
    timedelta64[*] dtype, bools, floats bit for bit, strings through the
    file's dictionary."""
    np_dt = np.dtype(_NP_OF_TORCH[tdtype])
    if np_dt.kind in "iu" and np_dt.itemsize == 8:
        wide = raw.view(np.int64 if transform_signed else np.uint64)
        return wide.view(np.dtype(logical)) if logical is not None else wide
    vals = raw.view(np_dt)
    if str_dict is not None:
        return str_dict[vals.astype(np.int64)]
    if logical == "bool":
        return vals.astype(bool)
    return vals


def _gather_columns(rows, columns, meta, idx, n: int, extra=()) -> tuple:
    """Rows `idx` (a device index tensor of `n` rows) of each column of one
    lockstep window -> ({name: host values}, host arrays of the `extra`
    device tensors gathered at `idx`) in ONE fetch (none when n is 0).
    Nullable columns come back as masked arrays, as in the JAX package."""
    order = list(dict.fromkeys(columns))
    gathered = []
    for name in order:
        blocks, _cdtype, _vtype, _valid, vmask = rows[name]
        gathered.append(_raw_flat(blocks).index_select(0, idx))
        if vmask is not None:
            gathered.append(vmask.index_select(0, idx))
    gathered += [t.index_select(0, idx) for t in extra]
    host = _fetch_many(gathered) if n and gathered else [
        np.empty(0, _NP_OF_TORCH[t.dtype]) for t in gathered]
    out, at = {}, 0
    for name in order:
        blocks, _cdtype, _vtype, _valid, vmask = rows[name]
        vals = _host_values(host[at], blocks.dtype, *meta[name])
        at += 1
        if vmask is not None:
            vals = np.ma.MaskedArray(vals, mask=~host[at])
            at += 1
        out[name] = vals
    return out, host[at:]


def _concat_parts(parts):
    if not parts:
        return np.empty(0)
    if any(isinstance(p, np.ma.MaskedArray) for p in parts):
        return np.ma.concatenate(parts)
    return np.concatenate(parts)


def _column_meta(path: str, header: dict, names) -> dict:
    """name -> (signed transform?, string dictionary, logical vtype)."""
    from . import fio_table

    meta = {}
    for n in names:
        cm = fio_table._col_meta(header, n)
        meta[n] = (cm.get("transform") in ("zigzag", "viewu"), _str_dict_of(path, n),
                   _logical_vt(cm))
    return meta


@entry
def select(path, columns=None, preds=(), limit: Optional[int] = None, device=None,
           order_by: Optional[str] = None, desc: bool = False, mesh=None) -> dict:
    """Materialise the rows matching every predicate: projection and
    selection pushdown. Only the requested columns decode, the predicates
    are evaluated on the device, and only matching rows reach the host.
    `preds` is a list of (column, op, value); `columns` defaults to every
    table column. Returns {name: numpy array} with nullable columns as masked
    arrays and string columns as unicode arrays, in the JAX package's dtypes.

    `order_by` sorts the result by that column (`desc` for descending; rows
    whose order key is null sort last, ties keep row order, reversed under
    DESC). With `limit` it is an ORDER BY ... LIMIT pushdown: every lockstep
    window reduces to k candidate rows on the device and only those reach
    the host; equal keys come out lowest row first for keys of up to 32
    bits and highest row first for 64-bit keys, the JAX package's order. A
    row that fails a predicate or has a null order key is never a candidate
    (there the JAX package can return one; ROADMAP.md, Queue 3). Without
    `order_by`, `limit` stops the file walk early, in file order.

    With `mesh` (parallel.make_mesh), each rank reads and decodes only its
    share of every file's chunks (its walk stops at its own `limit`), and
    the ranks' rows meet in ONE all_gather_object: every rank returns the
    answer without a mesh."""
    device, part = shard._placement(device, mesh)
    paths = _paths(path)
    if len(paths) > 1:
        return _select_dataset(paths, columns, list(preds), limit, device, order_by, desc,
                               part)
    plan = _select_plan(paths[0], columns, preds, order_by)
    columns = plan[0]
    if order_by is not None and limit is not None:
        states = shard._combine(part, lambda: _rank_files(paths, lambda p, _left: [
            (0, _topk_candidates(p, plan, limit, device, order_by, desc, part))], None, part))
        return _topk_rows(states, 0, columns, limit, desc)
    states = shard._combine(part, lambda: _rank_files(
        paths, lambda p, left: _select_rows(p, plan, left, device, order_by, part), limit, part))
    out = {n: [] for n in columns}
    okeys = []  # order_by without limit: carry the key column, sort after
    for _f, (vals, _extra) in _merged_rows(states, 1, limit):
        for c in columns:
            out[c].append(vals[c])
        if order_by is not None:
            okeys.append(vals[order_by])
    result = {n: _concat_parts(out[n]) for n in columns}
    if order_by is not None and okeys:
        order = _order_of(_concat_parts(okeys), desc)
        result = {n: result[n][order] for n in result}
    return result


def _select_plan(path, columns, preds, order_by) -> tuple:
    """(columns, preds, names, meta, keep) of select() over one table file,
    from its header: the projected columns (default: all), the predicates in
    the file's domain, every column the walk decodes, their _column_meta and
    the predicates' zone-map keep."""
    file = fio.header_of(path)
    if not file.table:
        raise ValueError("select() takes an FLTTAB table file")
    header = file.header
    if columns is None:
        columns = list(header["columns"])
    preds = _normalize_preds(path, list(preds))
    names = list(dict.fromkeys(
        [p[0] for p in preds] + list(columns) + ([order_by] if order_by is not None else [])))
    return (columns, preds, names, _column_meta(path, header, names),
            _zone_keep(path, preds, names=names))


def _select_rows(path, plan, limit, device, order_by, part):
    """Yield (n, ({name: host values}, ())) for each lockstep window of this
    rank's chunks of one table file: its n rows that match the plan's
    predicates, with the projected columns and the order column. Stops
    after `limit` rows."""
    columns, preds, names, meta, keep = plan
    fetched = list(columns) + ([order_by] if order_by is not None else [])
    taken = 0
    for rows in _lockstep_chunks(path, names, device, keep=keep, part=part):
        valid = rows[names[0]][3]
        if valid == 0:
            continue
        mask = _chunk_row_mask(rows, preds)
        if mask is None:
            idx = torch.arange(valid, device=device)
        else:
            idx = _rows_of(mask[:valid])
        if limit is not None and taken + idx.numel() > limit:
            idx = idx[:limit - taken]
        n = idx.numel()
        taken += n
        yield n, (_gather_columns(rows, fetched, meta, idx, n)[0], ())
        if limit is not None and taken >= limit:
            return


def _rank_files(paths, walk, limit, part) -> list:
    """This rank's share of a row walk over `paths`: [(items, exception)] a
    file, in file order. `walk(path, rows_left)` yields (n, item) for n
    rows. The walk stops after `limit` rows over all files (a later row of
    this rank cannot be among the call's first `limit`: every row before it
    in the call's order is before it on this rank too), and at the first
    exception, which is kept in its place for the merge to raise there (as
    the walk without a mesh would, unless `limit` rows came first)."""
    out, taken = [], 0
    for p in paths:
        items = []
        try:
            for n, item in walk(p, None if limit is None else limit - taken):
                items.append((n, item))
                taken += n
        except Exception as exc:  # noqa: BLE001  (raised by the merge, in its place)
            out.append((items, exc if part is None else shard._portable(exc)))
            break
        out.append((items, None))
        if limit is not None and taken >= limit:
            break
    return out


def _merged_rows(states, n_files: int, limit):
    """Yield (file, (values, extra)) of the ranks' row walks (_rank_files, in
    rank order) in file, rank and window order: the order of the walk
    without a mesh, as the ranks' chunk ranges are in order. Cut at `limit`
    rows; where a rank's walk raised, raise its exception there."""
    taken = 0
    for f in range(n_files):
        for mine in states:
            items, exc = mine[f] if f < len(mine) else ((), None)
            for n, (vals, extra) in items:
                if limit is not None and taken + n > limit:
                    n = limit - taken
                    vals = {c: v[:n] for c, v in vals.items()}
                    extra = tuple(x[:n] for x in extra)
                taken += n
                yield f, (vals, extra)
                if limit is not None and taken >= limit:
                    return
            if exc is not None:
                raise exc


def _order_of(keys, desc: bool) -> np.ndarray:
    """Sort order of an order-by column: stable, null keys last, u64 keys
    with the scans' int64 semantics."""
    null = (np.ma.getmaskarray(keys) if isinstance(keys, np.ma.MaskedArray)
            else np.zeros(len(keys), bool))
    kd = np.asarray(np.ma.getdata(keys))
    if kd.dtype == np.uint64:
        kd = kd.view(np.int64)
    pos = np.arange(len(kd))
    vi = pos[~null][np.argsort(kd[~null], kind="stable")]
    if desc:
        vi = vi[::-1]
    return np.concatenate([vi, pos[null]]).astype(np.int64)


def _concat_row_dicts(parts, names) -> dict:
    """Concatenate per-file select() results column-wise (mask-aware)."""
    return {n: _concat_parts([p[n] for p in parts if n in p and len(p[n])])
            for n in names}


def _select_dataset(paths, columns, preds, limit, device, order_by, desc, part):
    """select() over a sharded dataset: per-file pushdown (each file owns its
    dictionaries), then a column-wise merge; ORDER BY re-sorts the merged
    candidates on the host and trims to the limit. With a mesh `part`, each
    file splits over the ranks and the call combines once."""
    if columns is None:
        columns = list(fio.header_of(paths[0], table=True).header["columns"])

    def file_rows(names, lim) -> dict:
        states = shard._combine(part, lambda: _rank_files(paths, lambda p, left: _select_rows(
            p, _select_plan(p, names, preds, None), left, device, None, part), lim, part))
        per_file = [{n: [] for n in names} for _ in paths]
        for f, (vals, _extra) in _merged_rows(states, len(paths), lim):
            for n in names:
                per_file[f][n].append(vals[n])
        return _concat_row_dicts(
            [{n: _concat_parts(v) for n, v in rows.items()} for rows in per_file], names)

    if order_by is None:
        return file_rows(columns, limit)
    inner = list(dict.fromkeys(list(columns) + [order_by]))
    if limit is None:
        combined = file_rows(inner, None)
    else:
        states = shard._combine(part, lambda: _rank_files(paths, lambda p, _left: [
            (0, _topk_candidates(p, _select_plan(p, inner, preds, order_by), limit, device,
                                 order_by, desc, part))], None, part))
        combined = _concat_row_dicts(
            [_topk_rows(states, f, inner, limit, desc) for f in range(len(paths))], inner)
    if len(combined[order_by]):
        order = _order_of(combined[order_by], desc)
        combined = {n: v[order] for n, v in combined.items()}
    if limit is not None:
        combined = {n: v[:limit] for n, v in combined.items()}
    if order_by not in columns:
        combined.pop(order_by)
    return combined


def _top_rows(flat: _Flat, ok, k: int, largest: bool) -> torch.Tensor:
    """The best min(k, n_ok) rows of one decoded window by the order key, as
    ONE int64 tensor [n_ok, rows (kk), keys (kk)], kk = min(k, len(flat)):
    the first min(k, n_ok) rows are the candidates (unordered, the rest -1),
    their keys beside them. Keys are signed and ordered like the values (the
    int key; the IEEE total-order key of a float). Rows that `ok` masks are
    never candidates. Among rows whose key equals the k-th best, the lowest
    rows are taken for keys of up to 32 bits and the highest for 64-bit keys,
    the tie rule of the JAX package's per-chunk top-k."""
    key = flat.key if flat.kind == "int" else _total_order_key(flat.key, flat.kind)
    key = key.to(torch.int64)
    n = key.shape[0]
    kk = min(k, n)
    if ok is None:
        ok = torch.ones(n, dtype=torch.bool, device=key.device)
    worst = _imin(torch.int64) if largest else _imax(torch.int64)
    top = torch.topk(torch.where(ok, key, worst), kk, largest=largest, sorted=True).values
    n_ok = ok.sum(dtype=torch.int64)
    take = n_ok.clamp(max=kk)
    thr = top[(take - 1).clamp(min=0)]
    better = ok & ((key > thr) if largest else (key < thr))
    equal = ok & (key == thr)
    if flat.bits == 64:  # rank the ties from the last row
        rank = equal.flip(0).cumsum(0, dtype=torch.int64).flip(0)
    else:
        rank = equal.cumsum(0, dtype=torch.int64)
    chosen = better | (equal & (rank <= take - better.sum(dtype=torch.int64)))
    rows = torch.topk(torch.where(chosen, torch.arange(n, device=key.device), -1), kk).values
    return torch.cat([n_ok.reshape(1), rows, key[rows.clamp(min=0)]])




def _topk_candidates(path, plan, k, device, order_by, desc, part) -> tuple:
    """ORDER BY order_by [DESC] LIMIT k over this rank's chunks of one table
    file: (the order key's bits, or None where no row ranked; its best k
    candidates as (key, window, row, seq, j), window and row counted from
    the file's start, in the order _topk_rows merges them; store: the
    projected values of each window that gave candidates, the candidate at
    store[seq][j]). Each lockstep window reduces to k candidate rows on the
    device (_top_rows) and only theirs reach the host. Zone-map bounds on the
    order column visit the windows best bound first, in batches growing x4,
    and stop once the k-th candidate beats every remaining window: a row of
    the call's best k is among its rank's best k."""
    columns, preds, names, meta, keep = plan
    chunks, ocdt_l, otr_l, ovt_l, _nv, _bo, _nm = _column_layout(path, order_by)
    n_chunks = len(chunks)
    win = _LOCKSTEP_WINDOW
    windows = list(_windows(*shard._chunk_span(part, n_chunks), win))
    first_row = [0]
    for m in chunks:
        first_row.append(first_row[-1] + m["n_blocks"] * layout.BLOCK)
    store = []    # per contributing window: {col: gathered values}
    entries = []  # (key, window, row, store seq, emit position)
    bits = None   # the order key's width, once a row ranked

    def visit(keep_w):
        nonlocal bits
        # the windows that yield a part (a chunk of theirs is kept), each
        # from its first kept chunk
        spans = []
        for idxs in windows:
            kept = [c for c in idxs if keep_w is None or keep_w[c]]
            if kept:
                spans.append((idxs[0] // win, first_row[kept[0]]))
        parts = _lockstep_chunks(path, names, device, keep=keep_w, window=win, part=part)
        for rows, (widx, row0) in zip(parts, spans, strict=True):
            valid = rows[names[0]][3]
            if valid == 0:
                continue
            mask = _chunk_row_mask(rows, preds)
            oblocks, ocdt, ovt, _ov, ovmask = rows[order_by]
            ok = None if mask is None else mask[:valid]
            if ovmask is not None:  # null order keys sort out of a top-k
                ok = ovmask[:valid] if ok is None else ok & ovmask[:valid]
            oflat = _flatten_logical(oblocks, ocdt, ovt).head(valid)
            got = _fetch(_top_rows(oflat, ok, k, desc))
            kk = (len(got) - 1) // 2
            take = min(got[0], kk)
            if take == 0:
                continue
            bits = oflat.bits
            tie = -1 if bits == 64 else 1  # ties: highest row first for 64-bit keys
            cands = sorted(zip(got[1 + kk:1 + kk + take], got[1:1 + take]),
                           key=lambda c: (-c[0] if desc else c[0], tie * c[1]))
            idx = torch.tensor([r for _key, r in cands], dtype=torch.int64, device=device)
            chunk_vals, _ = _gather_columns(rows, columns, meta, idx, take)
            seq = len(store)
            store.append(chunk_vals)
            entries.extend((key, widx, row0 + r, seq, j) for j, (key, r) in enumerate(cands))

    if all("stats" not in c for c in chunks):
        # no zone maps: one sequential pass
        visit(keep)
    else:
        zkind, zbits = zonemaps.topk_kind(ocdt_l, ovt_l, otr_l)
        wb = {}
        for wi, idxs in enumerate(windows):
            bs = [zonemaps.topk_bound(chunks[c], zkind, zbits, desc)
                  for c in idxs if keep is None or keep[c]]
            bs = [_bound_int(b) for b in bs if b is not None]
            if bs:
                wb[wi] = max(bs) if desc else min(bs)
        order = sorted(wb, key=lambda wi: wb[wi], reverse=desc)
        pos, batch = 0, 1
        while pos < len(order):
            if len(entries) >= k:
                # the bounds are the JAX package's UNSIGNED keys: a signed key
                # maps onto them by adding 2^(bits-1) (the flipped top bit)
                kth = sorted((e[0] for e in entries), reverse=desc)[k - 1] + (1 << (bits - 1))
                b = wb[order[pos]]
                if (b < kth) if desc else (b > kth):
                    break
            kl = [False] * n_chunks
            for wi in order[pos:pos + batch]:
                for c in windows[wi]:
                    kl[c] = keep is None or keep[c]
            pos += batch
            batch *= 4
            # every taken window yields exactly one part (wb membership
            # guarantees a kept chunk)
            visit(kl)
    entries.sort(key=_candidate_order(bits, desc))
    return bits, entries[:k], store


def _candidate_order(bits, desc: bool):
    """Sort key of a candidate (key, window, row, ...): best key first, then
    window, then row, lowest first for keys of up to 32 bits and highest
    first for 64-bit keys. It is the order of the walk without a mesh, where
    each window's candidates come out by key and row and a stable key sort
    over the windows in order follows."""
    tie = -1 if bits == 64 else 1
    return lambda e: (-e[0] if desc else e[0], e[1], tie * e[2])


def _topk_rows(states, f: int, columns, k: int, desc: bool) -> dict:
    """The rows of ORDER BY ... LIMIT k over file `f` from every rank's
    candidates there (_topk_candidates, through _rank_files): the best k of
    their union. Raises the lowest rank's exception where one raised."""
    cands, bits = [], None
    for mine in states:  # a rank stops early only where it raised
        items, exc = mine[f]
        if exc is not None:
            raise exc
        for _n, (b, entries, store) in items:
            bits = b if b is not None else bits
            cands += [(key, widx, row, store[seq], j) for key, widx, row, seq, j in entries]
    cands.sort(key=_candidate_order(bits, desc))
    chosen = [(vals, j) for _key, _w, _r, vals, j in cands[:k]]
    result = {}
    for n in columns:
        if not chosen:
            result[n] = np.empty(0)
            continue
        data = [np.ma.getdata(vals[n])[j] for vals, j in chosen]
        msk = [bool(np.ma.getmaskarray(vals[n])[j]) for vals, j in chosen]
        dt = np.ma.getdata(chosen[0][0][n]).dtype
        # unicode widths differ per window: numpy takes the largest
        arr = np.asarray(data) if dt.kind == "U" else np.asarray(data, dt)
        if any(isinstance(vals[n], np.ma.MaskedArray) for vals, _j in chosen):
            result[n] = np.ma.MaskedArray(arr, mask=np.asarray(msk))
        else:
            result[n] = arr
    return result


def _join_match(keys, right_sorted):
    """(row index into the sorted right keys, matched?) per left key; both
    int64 (torch has no uint32 order on the CPU, and a left and a right key
    of up to 32 bits fit it)."""
    i = torch.searchsorted(right_sorted, keys).clamp(0, right_sorted.shape[0] - 1)
    return i, right_sorted[i] == keys


@entry
def join(left_path, right_path, on: str, columns=None, right_columns=None, preds=(),
         how: str = "inner", limit: Optional[int] = None, device=None, mesh=None) -> dict:
    """Dimension join: enrich the (large, streamed) LEFT table with columns
    of the (small) RIGHT table matched on the `on` key column.

    The right key must be UNIQUE (a dimension table, so no row
    multiplication); the right side decodes once to the host and is sorted
    there, the left side streams window by window with `preds` pushed down
    and the key match evaluated on the device: integer keys by
    torch.searchsorted against the sorted right keys (both sides int64),
    string keys by label through a left-code -> right-row table built per
    left file (each file owns its dictionary), so the match is one device
    gather. `how`: "inner" drops unmatched left rows, "left" keeps them with
    masked right values; null keys never match. Key domains: integers of up
    to 32 bits and strings (64-bit and float keys raise). Right columns whose
    names collide get a "_right" suffix.

    With `mesh`, every rank decodes the right side, streams only its share
    of the left chunks (stopping at its own `limit`), and the ranks' rows
    meet in ONE all_gather_object: every rank returns the answer without a
    mesh. Returns {name: numpy array} like select()."""
    from . import fio_table

    if how not in ("inner", "left"):
        raise ValueError(f"how must be 'inner' or 'left', got {how!r}")
    device, part = shard._placement(device, mesh)
    lpaths = _paths(left_path)
    rheader = fio.header_of(right_path, table=True).header
    if right_columns is None:
        right_columns = [c for c in rheader["columns"] if c != on]
    rkeys = fio_table.read_column(right_path, on)
    if isinstance(rkeys, np.ma.MaskedArray):
        raise ValueError(f"right key column {on!r} must not contain nulls")
    rvals = {c: fio_table.read_column(right_path, c) for c in right_columns}

    lheader = fio.header_of(lpaths[0], table=True).header
    if columns is None:
        columns = list(lheader["columns"])
    out_names = list(columns) + [(c if c not in columns else f"{c}_right")
                                 for c in right_columns]

    # sort the right side by key; uniqueness = no duplicate neighbours
    rkd = None
    if rkeys.dtype.kind in ("U", "O"):
        rk = np.asarray(rkeys).astype(np.str_)
        order = np.argsort(rk, kind="stable")
        rk_sorted = rk[order]
        str_key = True
    else:
        if rkeys.dtype.itemsize * 8 == 64 or rkeys.dtype.kind == "f":
            raise ValueError("join keys must be integers <= 32 bits or "
                             f"strings; {on!r} is {rkeys.dtype}")
        order = np.argsort(rkeys, kind="stable")
        rk_sorted = np.asarray(rkeys)[order]
        str_key = False
        rkd = torch.from_numpy(rk_sorted.astype(np.int64)).to(device)
    if rk_sorted.size > 1 and (rk_sorted[1:] == rk_sorted[:-1]).any():
        raise ValueError(f"right key column {on!r} has duplicates")
    rvals_sorted = {c: v[order] for c, v in rvals.items()}

    def walk(p, left):
        """(n, ({left column: values}, (right row, matched?))) a window of
        this rank's chunks of left file `p`, stopping after `left` rows."""
        preds_p = _normalize_preds(p, list(preds))
        names = list(dict.fromkeys([q[0] for q in preds_p] + list(columns) + [on]))
        col_meta = _column_meta(p, fio.header_of(p, table=True).header, names)
        if str_key:
            ld = _str_dict_of(p, on)
            if ld is None:
                raise ValueError(f"left {on!r} is not a string column but the right key is")
            # left code -> right sorted row (or -1): a host searchsorted of the
            # left dictionary into the right keys, then ONE device gather per
            # window does the whole match
            pos = np.searchsorted(rk_sorted, ld)
            pos_c = np.clip(pos, 0, max(0, rk_sorted.size - 1))
            hit = (rk_sorted[pos_c] == ld) if rk_sorted.size else np.zeros(ld.size, bool)
            tr_dev = torch.from_numpy(np.where(hit, pos_c, -1).astype(np.int64)).to(device)
        keep = _zone_keep(p, preds_p, names=names)
        taken = 0
        for rows in _lockstep_chunks(p, names, device, keep=keep, part=part):
            valid = rows[names[0]][3]
            if valid == 0:
                continue
            mask = _chunk_row_mask(rows, preds_p)
            kblocks, kdt, kvt, _kv, kmask = rows[on]
            kflat = _flatten_logical(kblocks, kdt, kvt)
            if kflat.kind != "int" or kflat.bits == 64:
                raise ValueError("join keys must be integers <= 32 bits or strings")
            lkey = kflat.key.to(torch.int64) + kflat.offset
            if str_key:
                ridx = tr_dev[lkey]
                matched = ridx >= 0
            elif rk_sorted.size == 0:
                ridx = torch.zeros_like(lkey)
                matched = torch.zeros(lkey.shape, dtype=torch.bool, device=lkey.device)
            else:
                # the JAX package compares the decoded key's dtype with the
                # right key's: the logical numpy dtypes, not the int64 forms
                ldt = np.dtype(_NP_OF_TORCH[kblocks.dtype])
                if ldt != rk_sorted.dtype:
                    raise ValueError(f"join key dtypes differ ({ldt} vs {rk_sorted.dtype}); "
                                     "store both sides as one dtype")
                ridx, matched = _join_match(lkey, rkd)
            if kmask is not None:  # null keys never match
                matched = matched & kmask
            if how == "inner":
                keep_rows = matched if mask is None else matched & mask
            else:
                keep_rows = mask
            if keep_rows is None:
                idx = torch.arange(valid, device=device)
            else:
                idx = _rows_of(keep_rows[:valid])
            if left is not None and taken + idx.numel() > left:
                idx = idx[:left - taken]
            n = idx.numel()
            taken += n
            # left columns, the right row and the match flag: one fetch
            vals, extra = _gather_columns(rows, columns, col_meta, idx, n, extra=(ridx, matched))
            yield n, (vals, tuple(extra))
            if left is not None and taken >= left:
                return

    states = shard._combine(part, lambda: _rank_files(lpaths, walk, limit, part))
    out = {n: [] for n in out_names}
    for _f, (vals, (ridx_np, ok_np)) in _merged_rows(states, len(lpaths), limit):
        for c in columns:
            out[c].append(vals[c])
        # right columns: host gather by matched sorted-row index
        safe = np.where(ok_np, ridx_np, 0).astype(np.int64)
        for c, oname in zip(right_columns, out_names[len(columns):]):
            if rvals_sorted[c].size == 0:  # empty right: all masked
                rv = np.ma.masked_all(len(safe), dtype=np.ma.getdata(rvals_sorted[c]).dtype)
            else:
                rv = rvals_sorted[c][safe]
            if how == "left":
                m = ~ok_np
                if isinstance(rv, np.ma.MaskedArray):
                    rv = np.ma.MaskedArray(np.ma.getdata(rv),
                                           mask=np.ma.getmaskarray(rv) | m)
                elif m.any():
                    rv = np.ma.MaskedArray(rv, mask=m)
            out[oname].append(rv)
    return {n: _concat_parts(out[n]) for n in out_names}
