"""Scans over compressed FLT columns: decode into the consumer on the GPU.

The FastLanes layout exists so decoders feed their consumers (reference
macros.rs:5-9). This module is the first consumer of a device read in the
port: reductions and filtered counts over an FLT file or a table column,
decoded by the CUDA kernels (kernels/cuda_codecs.py) run by run and reduced
with plain torch, with only a handful of scalars per run leaving the card.
It is the port of the scans of fastlanes_tpu/analytics.py (`scan_column`,
`scan_table`, `count_where`, `scan_where`); the rest of that module
(scan_where_multi, group_stats, select, join, quantile, distinct,
value_counts, top_k) is not ported yet and its names are absent here.

    from fastlanes_tpu_torch import analytics
    stats = analytics.scan_column("col.flt")             # sum/min/max/count
    n = analytics.count_where("col.flt", "gt", 1000)     # filtered count
    stats = analytics.scan_column("table.flt", column="price")
    all_cols = analytics.scan_table("table.flt")         # one file pass
    hot = analytics.scan_where("table.flt", "gt", 50,    # filtered agg
                               column="price", where="qty")

Every entry takes `device=None`: the GPU, RuntimeError without one;
`device="cpu"` runs the plain versions of the kernels on the host.

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
synchronisation): one per decoded run in a scan, one per run in a count.
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
from .ops import _engine as eng

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
    global HOST_FETCHES
    HOST_FETCHES += 1
    return tensor.cpu().tolist()


def _column_layout(path: str, column: Optional[str]):
    """Chunk metadata of a column (FLT file or FLTTAB table column):
    (chunks, cdtype, transform, vtype, n_values, base_off, nulls_meta)."""
    with open(path, "rb") as f:
        magic = f.read(8)
    if magic.startswith(b"FLTTAB1"):
        from . import fio_table

        if column is None:
            raise ValueError("table file: pass column=<name>")
        header = fio_table.read_table_header(path)
        col = fio_table._col_meta(header, column)
        return (col["chunks"], col["dtype"], col.get("transform"),
                col.get("vtype"), col.get("n_values"),
                fio.payload_base_of(path, fio_table.MAGIC),
                col.get("nulls"))
    header = fio.read_header(path)
    return (header["chunks"], header["dtype"], header.get("transform"),
            header.get("vtype"), header.get("n_values"),
            fio._payload_base(path), header.get("nulls"))


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
                    window: Optional[int] = None, keep=None, natural=False):
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
    `valid` prefix and `vmask` are positional)."""
    chunks, cdtype, transform, vtype, n_values, base_off, nulls_meta = \
        _column_layout(path, column)
    starts = [0]
    for m in chunks:
        starts.append(starts[-1] + m["n_blocks"])

    def _run_natural(idxs):
        if not natural or nulls_meta is not None:
            return False
        end_values = starts[idxs[-1] + 1] * layout.BLOCK
        return n_values is None or end_values <= n_values

    with open(path, "rb") as f:
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
            for i in range(len(chunks)):
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
            for i in range(0, len(chunks), window):
                idxs = range(i, min(i + window, len(chunks)))
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


def _str_dict_of(path: str, column: Optional[str]):
    """Sorted dictionary of a string table column, else None."""
    if column is None:
        return None
    with open(path, "rb") as f:
        magic = f.read(8)
    if not magic.startswith(b"FLTTAB1"):
        return None
    from . import fio_table

    header = fio_table.read_table_header(path)
    col = fio_table._col_meta(header, column)
    if col.get("vtype") != "str":
        return None
    with open(path, "rb") as f:
        return fio_table._load_str_dict(
            f, fio.payload_base_of(path, fio_table.MAGIC), col)


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
    num = 0
    half = buckets * planes
    for s, sgn in ((0, 1), (1, -1)):
        for j in range(half):
            c = bins[s * half + j]
            if c:
                b, k = divmod(j, planes)
                num += sgn * (c << (8 * b + 32 * k))
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
    if cur is None:
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


def scan_column(path, column: Optional[str] = None, device=None) -> dict:
    """Sum/min/max/count over a compressed column (one path or a list of
    paths), decoded and reduced on the device run by run. Returns python
    scalars: {sum, min, max, count} (+ n_null for a nullable column)."""
    device = eng.resolve_device(device)
    paths = _paths(path)
    if len(paths) > 1 and _str_dict_of(paths[0], column) is not None:
        return _merge_str_stats([scan_column(p, column, device)
                                 for p in paths])
    acc = _StatAcc()
    n_null = 0
    any_null = False
    for p in paths:
        for blocks, cdtype, vtype, valid, vmask in _decoded_chunks(
                p, column, device, natural=True):
            acc.feed(blocks, cdtype, vtype, valid, pred=vmask)
        nulls_meta = _column_layout(p, column)[6]
        if nulls_meta is not None:
            any_null = True
            n_null += int(nulls_meta["n_null"])
    d = _str_dict_of(paths[0], column)
    r = _map_str_result(acc.result(), d) if d is not None else acc.result()
    if any_null:
        r["n_null"] = n_null
    return r


def scan_table(path, columns=None, device=None) -> dict:
    """Single-pass stats over several (default: all) columns of an FLTTAB
    table file: the header parses once and every selected chunk is visited
    in payload-offset order, so the file is read sequentially exactly once
    no matter how many columns are scanned. Returns
    {column_name: {sum, min, max, count}}."""
    from . import fio_table

    device = eng.resolve_device(device)
    paths = _paths(path)
    if len(paths) > 1:  # sharded dataset: per-column dataset scans
        header = fio_table.read_table_header(paths[0])
        names = list(header["columns"]) if columns is None else list(columns)
        return {name: scan_column(paths, name, device) for name in names}
    path = paths[0]
    header = fio_table.read_table_header(path)
    names = list(header["columns"]) if columns is None else list(columns)
    cols = {name: fio_table._col_meta(header, name) for name in names}

    # Columns' payloads are laid out sequentially (write_table appends one
    # column's chunks after another), so scanning columns in first-chunk
    # offset order IS one sequential pass over the file; within a column
    # the batched generator merges same-signature chunks into one launch.
    names.sort(key=lambda n: cols[n]["chunks"][0]["offset"]
               if cols[n]["chunks"] else 0)
    out = {}
    for name in names:
        acc = _StatAcc()
        for blocks, cdtype, vtype, valid, vmask in _decoded_chunks(
                path, name, device, natural=True):
            acc.feed(blocks, cdtype, vtype, valid, pred=vmask)
        d = _str_dict_of(path, name)
        r = (_map_str_result(acc.result(), d) if d is not None
             else acc.result())
        nulls_meta = cols[name].get("nulls")
        if nulls_meta is not None:
            r["n_null"] = int(nulls_meta["n_null"])
        out[name] = r
    return out


def count_where(path, op: str, value, column: Optional[str] = None,
                device=None) -> int:
    """Filtered count: the predicate is evaluated on the decoded values on
    the device, and only the running count leaves it. Chunks whose zone map
    decides the predicate are never decoded."""
    if op not in _ALL_OPS:
        raise ValueError(f"unknown predicate {op!r}; have {sorted(_ALL_OPS)}")
    device = eng.resolve_device(device)
    total = 0
    for p in _paths(path):
        d = _str_dict_of(p, column)
        # string column: the predicate pushes down on THIS file's codes
        op_p, value_p = ((op, _probe_epoch(p, column, value)) if d is None
                         else _str_pred_to_code(d, op, value))
        # zone maps: 'none' chunks skip decode, 'all' chunks resolve from
        # the header alone (chunk row count minus its nulls)
        ds, chunks, n_values = _zone_decisions_col(p, column, op_p, value_p)
        keep, start_v = [], 0
        for meta, dec in zip(chunks, ds):
            cap = meta["n_blocks"] * layout.BLOCK
            n_chunk = cap if n_values is None else max(
                0, min(cap, n_values - start_v))
            start_v += cap
            if dec == "all":
                total += n_chunk - meta.get("stats", {}).get("nn", 0)
            keep.append(dec == "maybe")
        if not any(keep):
            continue
        if all(keep):
            keep = None
        for blocks, cdtype, vtype, valid, vmask in _decoded_chunks(
                p, column, device, keep=keep, natural=True):
            if valid == 0:
                continue
            flat = _flatten_logical(blocks, cdtype, vtype)
            mask = _pred_mask(flat, op_p, value_p)
            if vmask is not None:  # nulls match no predicate (not even 'ne')
                mask = mask & vmask
            total += _count_masked(mask, valid)
    return total


def scan_where(path, op: str, value, column: Optional[str] = None,
               where: Optional[str] = None, device=None,
               window: Optional[int] = None) -> dict:
    """Filtered aggregation, selection and aggregation in one pass:
    sum/min/max/count over the rows matching `OP value`, decoded and
    reduced on the device per run (sums stay exact: the predicate just
    masks the reduction). `where` names the predicate column for table
    files (default: the aggregated column itself); a cross-column predicate
    requires the two columns to share block layout (equal length and
    chunking, the writer's default for equal-length columns) and walks both
    in lockstep, `window` chunks per launch (default 8; the result does not
    depend on it). Returns {sum, min, max, count} over matching rows."""
    if op not in _ALL_OPS:
        raise ValueError(f"unknown predicate {op!r}; have {sorted(_ALL_OPS)}")
    device = eng.resolve_device(device)
    paths = _paths(path)
    vdict0 = _str_dict_of(paths[0], column)
    if len(paths) > 1 and vdict0 is not None:
        return _merge_str_stats([scan_where(p, op, value, column, where,
                                            device, window) for p in paths])
    acc = _StatAcc()
    for p in paths:
        _scan_where_into(acc, p, op, value, column, where, device,
                         window or _LOCKSTEP_WINDOW)
    return (_map_str_result(acc.result(), vdict0) if vdict0 is not None
            else acc.result())


def _scan_where_into(acc, path, op, value, column, where, device, window):
    """One file's worth of filtered aggregation fed into a shared
    accumulator (string predicates translate against THIS file's
    dictionary)."""
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
                path, column, device, keep=keep, natural=True):
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
    vals = _decoded_chunks(path, column, device, window=window, keep=keep)
    preds = _decoded_chunks(path, where, device, window=window, keep=keep)
    for (vb, vdt, vvt, v_valid, v_mask), (wb, wdt, wvt, w_valid, w_mask) in \
            zip(vals, preds):
        flat_v = _flatten_logical(vb, vdt, vvt)
        flat_w = _flatten_logical(wb, wdt, wvt)
        n_v, n_w = len(flat_v), len(flat_w)
        if n_v != n_w or v_valid != w_valid:
            raise ValueError(
                f"columns {column!r} and {where!r} have mismatched chunk "
                f"layouts ({n_v}/{v_valid} vs {n_w}/{w_valid} values); "
                "cross-column scan_where needs equal length and chunking")
        if v_valid == 0:
            continue
        pred = _pred_mask(flat_w, op, value)
        if w_mask is not None:  # null predicate rows match nothing
            pred = pred & w_mask
        if v_mask is not None:  # null values don't aggregate (SQL SUM(col))
            pred = pred & v_mask
        acc.feed_flat(flat_v, v_valid, pred)
    # unequal chunk counts (zip stops early) count as mismatched layouts
    if next(vals, None) is not None or next(preds, None) is not None:
        raise ValueError(
            f"columns {column!r} and {where!r} have different chunk counts; "
            "cross-column scan_where needs equal length and chunking")
