"""FLT file format: chunked FastLanes-compressed columns on disk.

The host-runtime IO layer of the framework (the role Vortex plays for the
Rust crate): a self-describing container whose payload bytes per block are
the exact FastLanes wire format, written/read at SIMD speed by the C++ host
codec (native/, where g++ builds it; else the NumPy host codec,
ref/numpy_ref.py), with block-range random access (only the covering chunks
decode) and element random access via unpack_single.

The byte format is the JAX package's (fastlanes_tpu/fio.py): this module is
the PyTorch port's own copy of that writer and reader, and a test pins that
both write the same bytes for the same input.

Layout:  magic FLTPU1 | u32 header_len | header JSON | chunk payloads
Each chunk: `chunk_blocks` blocks encoded with one codec + width; Delta
chunks carry their per-lane base vector as a payload prefix.

Within one call of a public entry of the port (utils/trace.py `entry`) each
file's header is read and parsed once: `header_of` serves the call's later
lookups, of FLT files and FLT tables alike, from the call's header scope,
which closes when the entry returns or raises. Outside an entry every
lookup reads the file again.
"""

from __future__ import annotations

import contextlib
import contextvars
import json
import struct
from typing import Optional

import numpy as np

from .core import layout
from . import alp as alp_mod
from . import native
from . import transforms
from . import zonemaps
from .ref import numpy_ref as npref
from .utils.trace import span, spanned

MAGIC = b"FLTPU1"
# v1: delta chunks used a shared all-zero base (no payload prefix).
# v2: delta/zdelta chunks carry a per-block row-0 base as a payload prefix
#     (n_blocks * LANES words before the packed stream). Readers accept v1
#     files only when no chunk depends on the changed base layout.
_VERSION = 2

#: header parses (read_header, fio_table.read_table_header), and the
#: lookups that an open header scope served without one (plain integers;
#: reset by assigning 0)
HEADER_PARSES = 0
HEADER_HITS = 0


def _bits_needed_arr(arr: np.ndarray) -> int:
    m = int(arr.max()) if arr.size else 0
    return m.bit_length()


def pad_to_blocks(arr: np.ndarray, dtype: str):
    """Normalize a column to (B, 1024) blocks; flat input of any length is
    tail-padded by repeating the last value. Returns (blocks, n_values or
    None) — shared by write_file and fio_table."""
    arr = np.ascontiguousarray(arr).astype(layout.np_dtype(dtype), copy=False)
    n_values = None
    if arr.ndim == 1:
        n_values = int(arr.size)
        pad = (-arr.size) % layout.BLOCK
        if pad:
            fill = arr[-1:] if arr.size else np.zeros(1, arr.dtype)
            arr = np.concatenate([arr, np.repeat(fill, pad)])
        arr = arr.reshape(-1, layout.BLOCK)
    if arr.ndim != 2 or arr.shape[1] != layout.BLOCK:
        raise ValueError(f"values must be (B, {layout.BLOCK}) or flat, got {arr.shape}")
    return arr, n_values


def _pad_to_blocks_float(arr: np.ndarray):
    """Float twin of pad_to_blocks (no unsigned cast)."""
    n_values = None
    if arr.ndim == 1:
        n_values = int(arr.size)
        pad = (-arr.size) % layout.BLOCK
        if pad:
            fill = arr[-1:] if arr.size else np.zeros(1, arr.dtype)
            arr = np.concatenate([arr, np.repeat(fill, pad)])
        arr = arr.reshape(-1, layout.BLOCK)
    if arr.ndim != 2 or arr.shape[1] != layout.BLOCK:
        raise ValueError(f"values must be (B, {layout.BLOCK}) or flat, got {arr.shape}")
    return arr, n_values


# ---------------------------------------------------------------------------
# Nullable columns: a per-block validity bitmap (1 bit/value, little-endian
# within bytes => 128 bytes per 1024-value block) stored as one raw blob in
# the payload area; null positions' underlying values are forward-filled
# before encoding so delta/rle/dict widths stay tight (null compression).
# Header/column meta key `nulls` = {offset, nbytes, n_null} — optional, so
# old readers see the filled values and ignore the mask.


def extract_null_mask(arr):
    """(plain values array, null mask bool array or None). Accepts
    np.ma.MaskedArray (any dtype) and object arrays holding None (string
    columns)."""
    if isinstance(arr, np.ma.MaskedArray):
        mask = np.ma.getmaskarray(arr)
        return np.asarray(arr.data), (mask.copy() if mask.any() else None)
    arr = np.asarray(arr)
    if arr.dtype == object:
        mask = np.frompyfunc(lambda x: x is None, 1, 1)(arr).astype(bool)
        if mask.any():
            return arr, mask
    return arr, None


def fill_nulls(values: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """Forward-fill null positions with the previous valid value (leading
    nulls take the first valid value; an all-null column fills with
    zero/''). Keeps runs/deltas tight — the mask, not the filler, is the
    source of truth."""
    flat = values.reshape(-1)
    m = mask.reshape(-1)
    if m.all():
        fill = "" if values.dtype.kind in ("O", "U", "S") else 0
        return np.full(values.shape, fill, values.dtype)
    idx = np.where(~m, np.arange(m.size), -1)
    np.maximum.accumulate(idx, out=idx)
    idx[idx < 0] = int(np.argmax(~m))
    return flat[idx].reshape(values.shape)


def encode_validity(mask: np.ndarray, n_blocks: int) -> bytes:
    """Null mask (flat or (B, 1024), True = null) -> validity blob: bit i of
    block b is 1 when the value is PRESENT; tail padding counts as present
    (n_values trims it, like the values themselves)."""
    valid = ~np.asarray(mask, bool).reshape(-1)
    pad = n_blocks * layout.BLOCK - valid.size
    if pad:
        valid = np.concatenate([valid, np.ones(pad, bool)])
    return np.packbits(valid.reshape(n_blocks, layout.BLOCK), axis=1,
                       bitorder="little").tobytes()


def decode_validity(raw: bytes, n_blocks: int) -> np.ndarray:
    """Validity blob -> (B, 1024) bool, True = value present."""
    if len(raw) < n_blocks * 128:
        raise ValueError("truncated validity bitmap")
    bits = np.frombuffer(raw[: n_blocks * 128], np.uint8)
    return np.unpackbits(bits.reshape(n_blocks, 128), axis=1,
                         bitorder="little").astype(bool)


def read_validity_range(path: str, nulls_meta: dict, base_off: int,
                        start: int, stop: int) -> np.ndarray:
    """Validity bits of blocks [start, stop) — touches only those 128-byte
    rows of the bitmap blob."""
    with span("read"), open(path, "rb") as f:
        f.seek(base_off + nulls_meta["offset"] + start * 128)
        raw = f.read((stop - start) * 128)
    return decode_validity(raw, stop - start)


@spanned("header")
def payload_base_of(path: str, magic: bytes) -> int:
    """Absolute offset of the payload area (after magic + header)."""
    with open(path, "rb") as f:
        f.seek(len(magic))
        (hlen,) = struct.unpack("<I", f.read(4))
    return len(magic) + 4 + hlen


def read_chunk_range(f, chunks, base_off: int, chunk_blocks: int,
                     start: int, stop: int, dtype: str) -> np.ndarray:
    """Decode blocks [start, stop) from a chunk stream — touches only the
    covering chunks. Shared by fio.read_blocks and fio_table.read_column."""
    out = []
    for ci, meta in enumerate(chunks):
        c_start = ci * chunk_blocks
        c_stop = c_start + meta["n_blocks"]
        if c_stop <= start or c_start >= stop:
            continue
        f.seek(base_off + meta["offset"])
        raw = f.read(meta["nbytes"])
        blocks = _decode_chunk(meta, raw, meta["n_blocks"], dtype)
        out.append(blocks[max(start, c_start) - c_start:
                          min(stop, c_stop) - c_start])
    if not out:
        return np.empty((0, layout.BLOCK), layout.np_dtype(dtype))
    return np.concatenate(out, axis=0)


def _delta_parts(values: np.ndarray, dtype: str, use_native: bool):
    """transposed, per-block row-0 base (index(0, lane) == lane), deltas."""
    nl = layout.lanes(dtype)
    transposed = (native.transpose(values, dtype) if use_native
                  else npref.transpose(values, dtype))
    base = np.ascontiguousarray(transposed[:, :nl])
    deltas = (native.delta(transposed, base, dtype) if use_native
              else npref.delta(transposed, base, dtype))
    return transposed, base, deltas


def _zigzag_deltas(deltas: np.ndarray) -> np.ndarray:
    """Wrapping-unsigned deltas -> zigzag codes: a small NEGATIVE step (which
    wraps to a huge unsigned delta and ruins plain delta's width) becomes a
    small code. The zdelta codec = Transpose -> Delta -> zigzag -> BitPack."""
    t = deltas.dtype.itemsize * 8
    signed = deltas.view(np.dtype(f"int{t}"))  # two's complement reinterpret
    return transforms.zigzag_encode_np(signed)


def _unzigzag_deltas(codes: np.ndarray) -> np.ndarray:
    t = codes.dtype.itemsize * 8
    return transforms.zigzag_decode_np(codes).view(np.dtype(f"uint{t}"))


def _auto_candidates(values: np.ndarray, dtype: str, delta_parts) -> dict:
    """Per-codec cost in equivalent bits/value. delta/zdelta pay their base
    prefix: LANES*T = 1024 bits per 1024-value block = exactly +1 bit/value
    for every dtype."""
    t = layout.bit_width(dtype)
    vmax = int(values.max()) if values.size else 0
    vmin = int(values.min()) if values.size else 0
    deltas = delta_parts[2]
    # rle: 1 (idx deltas) + 1 (u16 base = 64*16/1024) + counts overhead +
    # run values at T bits each, averaged over positions
    n_runs = int(np.count_nonzero(values[:, 1:] != values[:, :-1])) + values.shape[0]
    rle_bits = 2.0 + 16.0 / 1024 + n_runs * t / values.size if values.size else t
    # dict: u16 code stream at bits(n_dict-1) + the dictionary itself,
    # amortized over the chunk; beyond the 2^16-entry cap it can't encode
    n_dict = int(np.unique(values).size)
    if values.size and n_dict <= _DICT_MAX:
        dict_bits = max(0, n_dict - 1).bit_length() + n_dict * t / values.size
    else:
        dict_bits = float("inf")
    return {
        "bitpack": float(vmax.bit_length()),
        "ffor": float((((vmax - vmin) % (1 << t))).bit_length()),
        "delta": _bits_needed_arr(deltas) + 1.0,
        "zdelta": _bits_needed_arr(_zigzag_deltas(deltas)) + 1.0,
        "rle": rle_bits,
        "dict": dict_bits,
    }


def choose_signed_transform(arr: np.ndarray, chunk_blocks: int = 1024):
    """For a signed column, pick the file/column transform by probing the
    first chunk: 'zigzag' (values mapped so |v| small -> code small; best for
    clustered-around-zero data) vs 'viewu' (two's-complement reinterpret;
    consecutive diffs survive, so sorted/walk data zdeltas tightly).
    Returns (transformed unsigned array, transform name)."""
    u_dt = np.dtype(f"uint{arr.dtype.itemsize * 8}")
    wire = layout.canon_dtype(u_dt)
    viewed = np.ascontiguousarray(arr).view(u_dt)
    zigzagged = transforms.zigzag_encode_np(arr)
    use_native = native.available()
    costs = {}
    for name, cand in (("viewu", viewed), ("zigzag", zigzagged)):
        blocks, _ = pad_to_blocks(cand, wire)
        probe = blocks[:chunk_blocks]
        costs[name] = min(_auto_candidates(
            probe, wire, _delta_parts(probe, wire, use_native)).values())
    best = min(costs, key=costs.get)
    return (viewed if best == "viewu" else zigzagged), best


def apply_inverse_transform(blocks: np.ndarray, transform) -> np.ndarray:
    """Undo a file/column-level transform on decoded unsigned blocks."""
    if transform == "zigzag":
        return transforms.zigzag_decode_np(blocks)
    if transform == "viewu":
        return blocks.view(np.dtype(f"int{blocks.dtype.itemsize * 8}"))
    if transform is None:
        return blocks
    raise ValueError(f"unknown transform {transform!r}")


def _encode_chunk(values: np.ndarray, dtype: str, codec: str):
    """Encode one chunk; returns (meta, payload_bytes)."""
    t = layout.bit_width(dtype)
    use_native = native.available()
    delta_parts = None

    if codec == "auto":
        delta_parts = _delta_parts(values, dtype, use_native)
        cands = _auto_candidates(values, dtype, delta_parts)
        codec = min(cands, key=lambda k: (cands[k], k != "ffor"))

    if codec == "rle":
        return _encode_chunk_rle(values, dtype)

    if codec == "dict":
        return _encode_chunk_dict(values, dtype)

    if codec == "bitpack":
        w = min(t, _bits_needed_arr(values))
        payload = (native.pack(values, w, dtype) if use_native
                   else npref.pack(values, w, dtype))
        return {"codec": codec, "width": w}, payload.tobytes()

    if codec == "ffor":
        ref_val = int(values.min()) if values.size else 0
        spread = ((int(values.max()) - ref_val) % (1 << t)) if values.size else 0
        w = min(t, int(spread).bit_length())
        payload = (native.for_pack(values, ref_val, w, dtype) if use_native
                   else npref.for_pack(values, ref_val, w, dtype))
        return {"codec": codec, "width": w, "reference": ref_val}, payload.tobytes()

    if codec == "delta":
        if delta_parts is None:
            delta_parts = _delta_parts(values, dtype, use_native)
        _, base, deltas = delta_parts
        w = min(t, _bits_needed_arr(deltas))
        packed = (native.pack(deltas, w, dtype) if use_native
                  else npref.pack(deltas, w, dtype))
        return {"codec": codec, "width": w}, base.tobytes() + packed.tobytes()

    if codec == "zdelta":
        if delta_parts is None:
            delta_parts = _delta_parts(values, dtype, use_native)
        _, base, deltas = delta_parts
        zz = _zigzag_deltas(deltas)
        w = min(t, _bits_needed_arr(zz))
        packed = (native.pack(zz, w, dtype) if use_native
                  else npref.pack(zz, w, dtype))
        return {"codec": codec, "width": w}, base.tobytes() + packed.tobytes()

    raise ValueError(f"unknown codec {codec!r}")


#: per-chunk dictionary cap — codes ride a u16 stream (like rle's index
#: stream), so a chunk may hold at most 2^16 distinct values
_DICT_MAX = 1 << 16


def _dict_parts(values: np.ndarray):
    """(sorted per-chunk dictionary, u16 codes). Sorted dictionary means
    code order == value order, so predicates push down as code compares."""
    dictionary, inverse = np.unique(values, return_inverse=True)
    return dictionary, inverse.reshape(values.shape).astype(np.uint16)


def _encode_chunk_dict(values: np.ndarray, dtype: str):
    """dict chunk (FastLanes-family DICT, VLDB'23; not in the Rust crate):
    payload = sorted dictionary (n_dict elements of the column dtype) ||
    packed u16 codes (standard bitpack stream, W = bits for n_dict-1).
    Decode = one u16 unpack + one gather regardless of column dtype."""
    use_native = native.available()
    dictionary, codes = _dict_parts(values)
    if dictionary.size > _DICT_MAX:
        raise ValueError(
            f"dict codec: {dictionary.size} distinct values exceed the "
            f"{_DICT_MAX}-entry per-chunk dictionary (u16 code stream)")
    w = int(max(0, int(dictionary.size) - 1).bit_length())
    packed = (native.pack(codes, w, "u16") if use_native
              else npref.pack(codes, w, "u16"))
    payload = dictionary.tobytes() + packed.tobytes()
    meta = {"codec": "dict", "width": w, "n_dict": int(dictionary.size)}
    return meta, payload


def _split_dict_payload(meta: dict, raw: bytes, n_blocks: int, dtype: str):
    """-> (dictionary (n_dict,), packed u16 codes (B, plen))."""
    np_dt = layout.np_dtype(dtype)
    nd = meta["n_dict"]
    o = nd * np_dt.itemsize
    plen = layout.packed_len("u16", meta["width"])
    if len(raw) < o:
        raise ValueError(f"truncated dict chunk: {len(raw)} payload bytes "
                         f"cannot hold the {nd}-entry dictionary")
    if len(raw) < o + 2 * n_blocks * plen:
        raise ValueError("truncated dict chunk: short code stream")
    dictionary = np.frombuffer(raw[:o], np_dt)
    packed = np.frombuffer(raw[o:o + 2 * n_blocks * plen], np.uint16)
    return dictionary, packed.reshape(n_blocks, plen)


def _decode_chunk_dict(meta: dict, raw: bytes, n_blocks: int, dtype: str):
    dictionary, packed = _split_dict_payload(meta, raw, n_blocks, dtype)
    use_native = native.available()
    codes = (native.unpack(packed, meta["width"], "u16") if use_native
             else npref.unpack(packed, meta["width"], "u16"))
    if codes.size and int(codes.max()) >= meta["n_dict"]:
        raise ValueError("corrupt dict chunk: code beyond dictionary")
    return dictionary[codes.astype(np.int64)]


def _rle_parts(values: np.ndarray):
    """Per-block run decomposition: (counts (B,) int64, flat run values,
    idx (B, 1024) uint16). idx is monotone per block with steps in {0, 1},
    so its transposed per-lane deltas ALWAYS pack at W=1 — RLE rides the
    standard Delta machinery (FastLanes VLDB'23 §RLE: run-index vector
    delta-compressed on the transposed layout; not in the Rust crate)."""
    first = np.ones((values.shape[0], 1), bool)
    step = np.concatenate([first, values[:, 1:] != values[:, :-1]], axis=1)
    idx = (np.cumsum(step, axis=1) - 1).astype(np.uint16)
    counts = idx[:, -1].astype(np.int64) + 1
    run_values = values[step]  # flat, concatenated in block order
    return counts, run_values, idx


def _encode_chunk_rle(values: np.ndarray, dtype: str):
    """RLE chunk: counts(u16) || per-block u16 idx base (B*64) || packed
    idx deltas (u16, W=1) || raw run values. The index stream is a u16
    FastLanes delta stream regardless of column dtype (1024 < 2^16)."""
    use_native = native.available()
    counts, run_values, idx = _rle_parts(values)
    if int(counts.max()) > 0xFFFF:
        raise ValueError("impossible: more runs than block positions")
    transposed = (native.transpose(idx, "u16") if use_native
                  else npref.transpose(idx, "u16"))
    base = np.ascontiguousarray(transposed[:, :64])
    deltas = (native.delta(transposed, base, "u16") if use_native
              else npref.delta(transposed, base, "u16"))
    assert int(deltas.max()) <= 1
    packed_idx = (native.pack(deltas, 1, "u16") if use_native
                  else npref.pack(deltas, 1, "u16"))
    payload = (counts.astype("<u2").tobytes() + base.tobytes()
               + packed_idx.tobytes() + run_values.tobytes())
    meta = {"codec": "rle", "width": 1, "n_runs": int(counts.sum())}
    return meta, payload


def _split_rle_payload(meta: dict, raw: bytes, n_blocks: int, dtype: str):
    """-> (counts int64 (B,), base u16 (B, 64), packed_idx u16 (B, 64),
    flat run values)."""
    np_dt = layout.np_dtype(dtype)
    o = 0
    counts = np.frombuffer(raw[o:o + 2 * n_blocks], "<u2").astype(np.int64)
    o += 2 * n_blocks
    base = np.frombuffer(raw[o:o + 2 * n_blocks * 64], np.uint16).reshape(n_blocks, 64)
    o += 2 * n_blocks * 64
    plen = layout.packed_len("u16", 1)  # 64 words
    packed_idx = np.frombuffer(raw[o:o + 2 * n_blocks * plen], np.uint16)
    packed_idx = packed_idx.reshape(n_blocks, plen)
    o += 2 * n_blocks * plen
    run_values = np.frombuffer(raw[o:], np_dt)[: meta["n_runs"]]
    if len(run_values) != meta["n_runs"]:
        raise ValueError(
            f"truncated rle payload: {len(run_values)} run values, "
            f"header says {meta['n_runs']}")
    return counts, base, packed_idx, run_values


def _rle_gather(counts, run_values, idx):
    """out[b, i] = run_values_of_block_b[idx[b, i]] via flat offsets."""
    offsets = np.cumsum(counts) - counts
    return run_values[offsets[:, None] + idx.astype(np.int64)]


def _decode_chunk_rle(meta: dict, raw: bytes, n_blocks: int, dtype: str):
    counts, base, packed_idx, run_values = _split_rle_payload(
        meta, raw, n_blocks, dtype)
    use_native = native.available()
    transposed = (native.undelta_pack(packed_idx, base, 1, "u16") if use_native
                  else npref.undelta_pack(packed_idx, base, 1, "u16"))
    idx = (native.untranspose(transposed, "u16") if use_native
           else npref.untranspose(transposed, "u16"))
    return _rle_gather(counts, run_values, idx)


def _encode_chunk_alp(values_f: np.ndarray, wire_dtype: str):
    """ALP chunk for a float32/float64 block batch: FFoR'd scaled ints
    bit-packed with the integer machinery, exceptions appended raw.
    Payload: packed || exc_pos(u32 LE) || exc_val(value dtype LE)."""
    enc = alp_mod.encode_np(values_f)
    w = enc["width"]
    use_native = native.available()
    packed = (native.pack(enc["ints"], w, wire_dtype) if use_native
              else npref.pack(enc["ints"], w, wire_dtype))
    payload = (packed.tobytes() + enc["exc_pos"].astype("<u4").tobytes()
               + enc["exc_val"].tobytes())
    meta = {"codec": "alp", "width": w, "reference": enc["reference"],
            "e": enc["e"], "f": enc["f"], "n_exc": int(len(enc["exc_pos"])),
            "vtype": "f32" if values_f.dtype == np.float32 else "f64"}
    return meta, payload


def _split_alp_payload(meta: dict, raw: bytes, n_blocks: int, dtype: str,
                       np_float):
    """ALP payload -> (packed uint array, exc_pos, exc_val)."""
    np_dt = layout.np_dtype(dtype)
    plen = layout.packed_len(dtype, meta["width"])
    packed_bytes = n_blocks * plen * np_dt.itemsize
    packed = np.frombuffer(raw[:packed_bytes], np_dt).reshape(n_blocks, plen)
    n_exc = meta.get("n_exc", 0)
    pos_bytes = n_exc * 4
    exc_pos = np.frombuffer(raw[packed_bytes:packed_bytes + pos_bytes], "<u4")
    exc_val = np.frombuffer(raw[packed_bytes + pos_bytes:], np_float)[:n_exc]
    return packed, exc_pos, exc_val


def _decode_chunk_alp(meta: dict, raw: bytes, n_blocks: int, dtype: str,
                      np_float) -> np.ndarray:
    packed, exc_pos, exc_val = _split_alp_payload(meta, raw, n_blocks, dtype,
                                                  np_float)
    use_native = native.available()
    shifted = (native.unpack(packed, meta["width"], dtype) if use_native
               else npref.unpack(packed, meta["width"], dtype))
    return alp_mod.decode_np(shifted, meta["e"], meta["f"], meta["reference"],
                             np_float, exc_pos, exc_val)


def _encode_chunk_alprd(values_f: np.ndarray, wire_dtype: str):
    """ALP_RD chunk (left/right split for non-decimal floats): payload =
    packed rights (wire dtype, W=right_bits) || packed left indices (u16
    stream, W=idx_width) || exc_pos (u32) || exc_left (u16 when the left
    part is <= 16 bits, u32 for wider lefts — derived from width+vtype,
    see _alprd_exc_left_dtype)."""
    use_native = native.available()
    enc = alp_mod.rd_encode_np(values_f)
    wr = enc["right_bits"]
    dictionary = enc["dict"]
    wi = max(1, int(len(dictionary) - 1).bit_length())
    rights = enc["rights"].astype(layout.np_dtype(wire_dtype))
    packed_r = (native.pack(rights, wr, wire_dtype) if use_native
                else npref.pack(rights, wr, wire_dtype))
    packed_i = (native.pack(enc["left_idx"], wi, "u16") if use_native
                else npref.pack(enc["left_idx"], wi, "u16"))
    vbits = 32 if values_f.dtype == np.float32 else 64
    exc_dt = "<u2" if vbits - wr <= 16 else "<u4"
    payload = (packed_r.tobytes() + packed_i.tobytes()
               + enc["exc_pos"].astype("<u4").tobytes()
               + enc["exc_left"].astype(exc_dt).tobytes())
    meta = {"codec": "alprd", "width": wr, "idx_width": wi,
            "dict": [int(x) for x in dictionary],
            "n_exc": int(len(enc["exc_pos"])),
            "vtype": "f32" if values_f.dtype == np.float32 else "f64"}
    return meta, payload


def _alprd_exc_left_dtype(meta: dict) -> str:
    """Exception lefts are u16 on the wire when the left part fits 16 bits
    (every pre-wide-left file), u32 for wider lefts."""
    vbits = 32 if meta["vtype"] == "f32" else 64
    return "<u2" if vbits - meta["width"] <= 16 else "<u4"


def _split_alprd_payload(meta: dict, raw: bytes, n_blocks: int, dtype: str):
    """-> (packed rights, packed left_idx (u16), exc_pos, exc_left)."""
    np_dt = layout.np_dtype(dtype)
    plen_r = layout.packed_len(dtype, meta["width"])
    o = n_blocks * plen_r * np_dt.itemsize
    packed_r = np.frombuffer(raw[:o], np_dt).reshape(n_blocks, plen_r)
    plen_i = layout.packed_len("u16", meta["idx_width"])
    packed_i = np.frombuffer(raw[o:o + 2 * n_blocks * plen_i], np.uint16)
    packed_i = packed_i.reshape(n_blocks, plen_i)
    o += 2 * n_blocks * plen_i
    n_exc = meta.get("n_exc", 0)
    exc_pos = np.frombuffer(raw[o:o + 4 * n_exc], "<u4")
    exc_dt = _alprd_exc_left_dtype(meta)
    exc_sz = np.dtype(exc_dt).itemsize
    exc_left = np.frombuffer(
        raw[o + 4 * n_exc:o + 4 * n_exc + exc_sz * n_exc], exc_dt)
    return packed_r, packed_i, exc_pos, exc_left


def _decode_chunk_alprd(meta: dict, raw: bytes, n_blocks: int, dtype: str,
                        np_float) -> np.ndarray:
    packed_r, packed_i, exc_pos, exc_left = _split_alprd_payload(
        meta, raw, n_blocks, dtype)
    use_native = native.available()
    rights = (native.unpack(packed_r, meta["width"], dtype) if use_native
              else npref.unpack(packed_r, meta["width"], dtype))
    left_idx = (native.unpack(packed_i, meta["idx_width"], "u16") if use_native
                else npref.unpack(packed_i, meta["idx_width"], "u16"))
    return alp_mod.rd_decode_np(left_idx, rights,
                                np.asarray(meta["dict"], np.uint32),
                                meta["width"], np_float, exc_pos, exc_left)


# plain ALP exception rate beyond which the RD fallback wins (the paper's
# adaptive scheme: decimal-like chunks -> ALP, real-double chunks -> RD)
_ALP_EXC_SWITCH = 0.2


def _encode_chunk_float(values_f: np.ndarray, wire_dtype: str, codec: str):
    if codec == "alprd":
        return _encode_chunk_alprd(values_f, wire_dtype)
    if codec == "alp":
        return _encode_chunk_alp(values_f, wire_dtype)
    # auto: try decimal ALP; fall back to RD when exceptions dominate
    meta, payload = _encode_chunk_alp(values_f, wire_dtype)
    if meta["n_exc"] > values_f.size * _ALP_EXC_SWITCH:
        meta_rd, payload_rd = _encode_chunk_alprd(values_f, wire_dtype)
        if len(payload_rd) < len(payload):
            return meta_rd, payload_rd
    return meta, payload


_VTYPES = {"f32": np.float32, "f64": np.float64}


def _decode_chunk(meta: dict, raw: bytes, n_blocks: int, dtype: str) -> np.ndarray:
    t = layout.bit_width(dtype)
    nl = layout.lanes(dtype)
    np_dt = layout.np_dtype(dtype)
    w = meta["width"]
    use_native = native.available()
    codec = meta["codec"]

    if codec == "alp":
        return _decode_chunk_alp(meta, raw, n_blocks, dtype,
                                 _VTYPES[meta["vtype"]])
    if codec == "alprd":
        return _decode_chunk_alprd(meta, raw, n_blocks, dtype,
                                   _VTYPES[meta["vtype"]])
    if codec == "rle":
        return _decode_chunk_rle(meta, raw, n_blocks, dtype)
    if codec == "dict":
        return _decode_chunk_dict(meta, raw, n_blocks, dtype)

    if codec == "delta":
        base_bytes = n_blocks * nl * np_dt.itemsize
        base = np.frombuffer(raw[:base_bytes], np_dt).reshape(n_blocks, nl)
        packed = np.frombuffer(raw[base_bytes:], np_dt).reshape(n_blocks, -1)
        transposed = (native.undelta_pack(packed, base, w, dtype) if use_native
                      else npref.undelta_pack(packed, base, w, dtype))
        return (native.untranspose(transposed, dtype) if use_native
                else npref.untranspose(transposed, dtype))

    if codec == "zdelta":
        base_bytes = n_blocks * nl * np_dt.itemsize
        base = np.frombuffer(raw[:base_bytes], np_dt).reshape(n_blocks, nl)
        packed = np.frombuffer(raw[base_bytes:], np_dt).reshape(n_blocks, -1)
        zz = (native.unpack(packed, w, dtype) if use_native
              else npref.unpack(packed, w, dtype))
        deltas = _unzigzag_deltas(zz)
        transposed = (native.undelta(deltas, base, dtype) if use_native
                      else npref.undelta(deltas, base, dtype))
        return (native.untranspose(transposed, dtype) if use_native
                else npref.untranspose(transposed, dtype))

    packed = np.frombuffer(raw, np_dt).reshape(n_blocks, -1)
    if codec == "bitpack":
        return (native.unpack(packed, w, dtype) if use_native
                else npref.unpack(packed, w, dtype))
    if codec == "ffor":
        ref_val = meta["reference"]
        return (native.unfor_pack(packed, ref_val, w, dtype) if use_native
                else npref.unfor_pack(packed, ref_val, w, dtype))
    raise ValueError(f"unknown codec {codec!r}")


def write_file(path: str, values, dtype=None, codec: str = "auto",
               chunk_blocks: int = 1024) -> dict:
    """Compress values into an FLT file. Returns the header dict.

    Accepts (B, 1024) block batches, or a flat vector of ANY length — a
    partial tail block is padded by repeating the final value (keeps delta /
    ffor widths tight) and the true length is recorded as `n_values` so
    reads trim exactly.

    SIGNED input with dtype=None is zigzag-transformed (small magnitudes of
    either sign get small codes) and comes back signed on read; an explicit
    unsigned `dtype` instead reinterprets the bits mod 2^T.

    FLOAT input (float32/float64, dtype must be None) compresses via the
    ALP codec: scaled-integer FFoR+bitpack with exact-roundtrip exceptions;
    reads come back as the original float dtype, bit-exact.

    NULLABLE input (np.ma.MaskedArray) stores a per-block validity bitmap
    (1 bit/value) alongside forward-filled values; reads come back as
    masked arrays."""
    values, null_mask = extract_null_mask(values)
    if null_mask is not None:
        values = fill_nulls(values, null_mask)
    arr = np.ascontiguousarray(values)
    transform = None
    vtype = None
    if arr.dtype.kind == "f":
        if dtype is not None:
            raise ValueError("float columns choose their own wire dtype; "
                             "pass dtype=None")
        if arr.dtype not in (np.float32, np.float64):
            raise ValueError(f"unsupported float dtype {arr.dtype}")
        if codec not in ("auto", "alp", "alprd"):
            raise ValueError(
                f"float columns use the 'alp'/'alprd' codecs, not {codec!r}")
        vtype = "f32" if arr.dtype == np.float32 else "f64"
        dtype = "u32" if vtype == "f32" else "u64"
        zsrc, zkind = arr.reshape(-1), vtype  # pre-pad: true values only
        arr, n_values = _pad_to_blocks_float(arr)
        encode_one = lambda part: _encode_chunk_float(part, dtype, codec)  # noqa: E731
    else:
        if codec in ("alp", "alprd"):
            raise ValueError(f"the {codec!r} codec is for float columns")
        presigned = None
        if dtype is None and arr.dtype.kind == "i":
            presigned = arr  # zone stats live in the logical signed domain
            arr, transform = choose_signed_transform(arr, chunk_blocks)
        dtype = layout.canon_dtype(dtype if dtype is not None else arr.dtype)
        arr, n_values = pad_to_blocks(arr, dtype)
        # zone-map source: the comparison domain of analytics._pred_mask —
        # logical values (pre-transform), 64-bit as the int64 limb order
        zsrc = (presigned.reshape(-1) if transform is not None
                else arr.reshape(-1)[:n_values])
        if dtype == "u64":
            zsrc = zsrc.view(np.int64)
        zkind = "int"
        encode_one = lambda part: _encode_chunk(part, dtype, codec)  # noqa: E731

    zmask = None if null_mask is None else null_mask.reshape(-1)
    chunks, payloads, offset = [], [], 0
    for start in range(0, arr.shape[0], chunk_blocks):
        part = arr[start:start + chunk_blocks]
        meta, payload = encode_one(part)
        a = start * layout.BLOCK
        b = min((start + len(part)) * layout.BLOCK, zsrc.size)
        st = zonemaps.stats_of(zsrc[a:b],
                               None if zmask is None else zmask[a:b], zkind)
        if st:
            meta["stats"] = st
        meta.update(n_blocks=len(part), offset=offset, nbytes=len(payload))
        chunks.append(meta)
        payloads.append(payload)
        offset += len(payload)

    header = {
        "version": _VERSION, "dtype": dtype, "n_blocks": int(arr.shape[0]),
        "chunk_blocks": chunk_blocks, "chunks": chunks,
    }
    if n_values is not None:
        header["n_values"] = n_values  # flat column length before tail padding
    if transform is not None:
        header["transform"] = transform
    if vtype is not None:
        header["vtype"] = vtype
    if null_mask is not None:
        blob = encode_validity(null_mask, int(arr.shape[0]))
        header["nulls"] = {"offset": offset, "nbytes": len(blob),
                           "n_null": int(null_mask.sum())}
        payloads.append(blob)
        offset += len(blob)
    hdr = json.dumps(header).encode()
    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(struct.pack("<I", len(hdr)))
        f.write(hdr)
        for payload in payloads:
            f.write(payload)
    return header


@spanned("header")
def read_header(path: str) -> dict:
    global HEADER_PARSES
    HEADER_PARSES += 1
    with open(path, "rb") as f:
        if f.read(len(MAGIC)) != MAGIC:
            raise ValueError("not an FLT file")
        (hlen,) = struct.unpack("<I", f.read(4))
        header = json.loads(f.read(hlen).decode())
    version = header["version"]
    if version == 1:
        # v1 predates the per-block delta base prefix; its delta chunks
        # (shared zero base, no prefix) would misparse under the v2 layout.
        if any(c["codec"] in ("delta", "zdelta") for c in header.get("chunks", [])):
            raise ValueError(
                "FLT v1 file contains delta-family chunks written with the "
                "legacy shared-zero-base layout; re-encode with this version "
                "(delta chunks now carry a per-block base prefix)")
        return header
    if version != _VERSION:
        raise ValueError(f"unsupported FLT version {version}")
    return header


def _payload_base(path: str) -> int:
    return payload_base_of(path, MAGIC)


#: the open call's headers, path -> FileHeader; None outside an entry
_CALL = contextvars.ContextVar("fastlanes_headers", default=None)


@contextlib.contextmanager
def header_scope():
    """One call's header scope: inside it `header_of` reads each file once.
    An entry called inside another shares its caller's scope; nothing
    outlives the outermost one."""
    if _CALL.get() is not None:
        yield
        return
    token = _CALL.set({})
    try:
        yield
    finally:
        _CALL.reset(token)


class FileHeader:
    """An FLT file's or table's header as one call sees it: whether it is a
    table and where its payload starts, from one read of its first bytes;
    the parsed `header` on first use (read_header or
    fio_table.read_table_header, whose errors it raises); the string
    dictionaries loaded so far (`dicts`, column -> array)."""

    __slots__ = ("path", "table", "base", "_header", "dicts")

    def __init__(self, path):
        from . import fio_table

        with open(path, "rb") as f:
            lead = f.read(len(fio_table.MAGIC) + 4)
        self.path = path
        self.table = lead.startswith(fio_table.MAGIC)
        magic = fio_table.MAGIC if self.table else MAGIC
        hlen = lead[len(magic):len(magic) + 4]
        self.base = len(magic) + 4 + struct.unpack("<I", hlen)[0] \
            if len(hlen) == 4 else None  # no header to parse: the parse raises
        self._header = None
        self.dicts = {}

    @property
    def header(self) -> dict:
        if self._header is None:
            from . import fio_table

            parse = fio_table.read_table_header if self.table else read_header
            self._header = parse(self.path)
        return self._header


def header_of(path, table: Optional[bool] = None) -> FileHeader:
    """The FileHeader of `path`: in an open header scope the call's one
    (a lookup after the first counts in HEADER_HITS), else a fresh one.
    `table=True` / `False` asks for a table / an FLT column file and raises
    the error of fio_table.read_table_header / read_header on another."""
    global HEADER_HITS
    call = _CALL.get()
    got = None if call is None else call.get(path)
    if got is None:
        got = FileHeader(path)
        if call is not None:
            call[path] = got
    else:
        HEADER_HITS += 1
    if table is not None and got.table != table:
        raise ValueError("not an FLT table file" if table else "not an FLT file")
    return got


def read_blocks(path: str, start: int = 0, stop: Optional[int] = None) -> np.ndarray:
    """Decode blocks [start, stop) — touches only the covering chunks."""
    header = read_header(path)
    dtype = header["dtype"]
    n = header["n_blocks"]
    stop = n if stop is None else min(stop, n)
    if not 0 <= start <= stop:
        raise IndexError(f"bad block range [{start}, {stop})")
    with open(path, "rb") as f:
        blocks = read_chunk_range(f, header["chunks"], _payload_base(path),
                                  header["chunk_blocks"], start, stop, dtype)
    if "vtype" in header and blocks.size == 0:
        return np.empty((0, layout.BLOCK), _VTYPES[header["vtype"]])
    blocks = apply_inverse_transform(blocks, header.get("transform"))
    if "nulls" in header and blocks.size:
        valid = read_validity_range(path, header["nulls"],
                                    _payload_base(path), start, stop)
        blocks = np.ma.MaskedArray(blocks, mask=~valid)
    return blocks


def read_file(path: str) -> np.ndarray:
    """Decode the whole file. Columns written as flat vectors come back flat
    and trimmed to their exact original length; block batches come back as
    (B, 1024)."""
    header = read_header(path)
    blocks = read_blocks(path)
    if "n_values" in header:
        return blocks.reshape(-1)[:header["n_values"]]
    return blocks


def _read_single_alp(path: str, meta: dict, ci: int, cb: int, block: int,
                     index: int, dtype: str, base_off: int):
    """Random access into an ALP chunk: check the exception list (tiny),
    otherwise read the block's packed row, unpack_single, unshift, multiply
    — at most two packed words plus the exception arrays touch disk."""
    np_float = _VTYPES[meta["vtype"]]
    np_dt = layout.np_dtype(dtype)
    w = meta["width"]
    plen = layout.packed_len(dtype, w)
    block_in_chunk = block - ci * cb
    n_exc = meta.get("n_exc", 0)
    packed_bytes = meta["n_blocks"] * plen * np_dt.itemsize
    with open(path, "rb") as f:
        if n_exc:
            f.seek(base_off + meta["offset"] + packed_bytes)
            exc_pos = np.frombuffer(f.read(n_exc * 4), "<u4")
            exc_val = np.frombuffer(f.read(n_exc * np_float().itemsize), np_float)
            flat_pos = block_in_chunk * layout.BLOCK + index
            hits = np.flatnonzero(exc_pos == flat_pos)
            if hits.size:
                return exc_val[hits[0]]
        f.seek(base_off + meta["offset"] + block_in_chunk * plen * np_dt.itemsize)
        raw = f.read(plen * np_dt.itemsize)
    packed = np.frombuffer(raw, np_dt).reshape(1, plen)
    idx_arr = np.array([index], dtype=np.int64)
    if native.available():
        shifted = native.unpack_single(packed, w, idx_arr, dtype)[0, 0]
    else:
        shifted = npref.unpack_single(packed, w, idx_arr, dtype)[0, 0]
    return alp_mod.decode_np(np.asarray([shifted]), meta["e"], meta["f"],
                             meta["reference"], np_float)[0]


def read_single(path: str, block: int, index: int):
    """Random access to one element without decoding the chunk (bitpack/ffor
    chunks read at most two packed words via unpack_single; delta chunks fall
    back to decoding the block's chunk)."""
    header = read_header(path)
    dtype = header["dtype"]
    if not 0 <= block < header["n_blocks"]:
        raise IndexError(f"block {block} out of range")
    if not 0 <= index < layout.BLOCK:
        raise IndexError(f"element index {index} out of range [0, {layout.BLOCK})")
    n_values = header.get("n_values")
    if n_values is not None and block * layout.BLOCK + index >= n_values:
        # flat-written ragged column: positions past n_values are tail padding
        raise IndexError(
            f"element {block * layout.BLOCK + index} past column end ({n_values})")
    cb = header["chunk_blocks"]
    ci = block // cb
    meta = header["chunks"][ci]
    np_dt = layout.np_dtype(dtype)
    base_off = _payload_base(path)

    if "nulls" in header:
        # one byte of the validity bitmap decides before any decode
        with open(path, "rb") as f:
            f.seek(base_off + header["nulls"]["offset"]
                   + block * 128 + index // 8)
            byte = f.read(1)[0]
        if not (byte >> (index % 8)) & 1:
            return np.ma.masked

    if meta["codec"] in ("delta", "zdelta", "rle", "alprd"):
        blocks = read_blocks(path, block, block + 1)  # applies any transform
        return blocks[0, index]

    if meta["codec"] == "alp":
        return _read_single_alp(path, meta, ci, cb, block, index, dtype, base_off)

    if meta["codec"] == "dict":
        # one packed u16 code row + one dictionary entry touch disk
        w = meta["width"]
        plen = layout.packed_len("u16", w)
        block_in_chunk = block - ci * cb
        dict_bytes = meta["n_dict"] * np_dt.itemsize
        if w == 0:
            code = 0
        else:
            with open(path, "rb") as f:
                f.seek(base_off + meta["offset"] + dict_bytes
                       + block_in_chunk * plen * 2)
                packed = np.frombuffer(f.read(plen * 2), np.uint16).reshape(1, plen)
            idx_arr = np.array([index], dtype=np.int64)
            if native.available():
                code = int(native.unpack_single(packed, w, idx_arr, "u16")[0, 0])
            else:
                code = int(npref.unpack_single(packed, w, idx_arr, "u16")[0, 0])
        if code >= meta["n_dict"]:
            raise ValueError("corrupt dict chunk: code beyond dictionary")
        with open(path, "rb") as f:
            f.seek(base_off + meta["offset"] + code * np_dt.itemsize)
            val = np.frombuffer(f.read(np_dt.itemsize), np_dt)[0]
        transform = header.get("transform")
        if transform is not None:
            return apply_inverse_transform(np.asarray([val], np_dt), transform)[0]
        return val

    w = meta["width"]
    plen = layout.packed_len(dtype, w)
    block_in_chunk = block - ci * cb
    with open(path, "rb") as f:
        f.seek(base_off + meta["offset"] + block_in_chunk * plen * np_dt.itemsize)
        raw = f.read(plen * np_dt.itemsize)
    packed = np.frombuffer(raw, np_dt).reshape(1, plen)
    idx_arr = np.array([index], dtype=np.int64)
    if native.available():
        val = native.unpack_single(packed, w, idx_arr, dtype)[0, 0]
    else:
        val = npref.unpack_single(packed, w, idx_arr, dtype)[0, 0]
    if meta["codec"] == "ffor":
        val = np_dt.type(val + np_dt.type(meta["reference"]))
    transform = header.get("transform")
    if transform is not None:
        return apply_inverse_transform(np.asarray([val], np_dt), transform)[0]
    return val
