"""FLT table container: multiple named FastLanes-compressed columns per file.

The reference crate compresses single 1024-value blocks; around it, table
storage is Vortex's job. This is that layer for this framework: a flat file
holding N named columns, each an independent chunk stream in the exact FLT
wire format (fio._encode_chunk), so per-column reads touch only that
column's bytes and decode on host (here) or device (fio_device semantics
apply per chunk).

The byte format is the JAX package's (fastlanes_tpu/fio_table.py): this
module is the PyTorch port's own copy of that writer and reader (host NumPy
only), and a test pins that both write the same bytes for the same input.

Layout: magic FLTTAB1 | u32 header_len | header JSON | concatenated payloads
Header: {version, columns: {name: {dtype, n_blocks, n_values?, chunk_blocks,
         chunks: [...]}}} — chunk offsets are absolute within the payload
         area, so columns can be read independently and in any order.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Dict, Optional

import numpy as np

from . import fio
from .core import layout
from .utils.trace import spanned

MAGIC = b"FLTTAB1"
_VERSION = 1


class StringColumn:
    """Device-decoded string column: u32 dictionary codes on the GPU plus
    the sorted host dictionary. The dictionary is sorted ascending, so code
    order == lexicographic order — string predicates (eq/lt/ge/...) push
    down as integer code compares without materializing a single string
    (see analytics.scan_where / group_stats)."""

    def __init__(self, codes, dictionary: np.ndarray):
        self.codes = codes          # device tensor, (B, 1024) or flat
        self.dictionary = dictionary  # np unicode array, sorted ascending

    @property
    def n_dict(self) -> int:
        return int(self.dictionary.size)

    def __len__(self) -> int:
        return int(self.codes.shape[0])

    def code_of(self, value: str) -> int:
        """Exact-match code of `value`, or -1 if absent."""
        i = int(np.searchsorted(self.dictionary, value))
        if i < self.dictionary.size and self.dictionary[i] == value:
            return i
        return -1

    def materialize(self) -> np.ndarray:
        """Gather the strings on the host (one device fetch of the codes)."""
        codes = self.codes
        if hasattr(codes, "cpu"):  # a torch tensor, wherever it lies
            codes = codes.cpu().numpy()
        return self.dictionary[np.asarray(codes).astype(np.int64)]

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"StringColumn(shape={tuple(self.codes.shape)}, "
                f"n_dict={self.n_dict})")


def _encode_str_dict(dictionary: np.ndarray) -> bytes:
    """Dictionary blob: u32 LE offsets (n_dict+1) || concatenated UTF-8."""
    encoded = [s.encode("utf-8") for s in dictionary.tolist()]
    offs = np.zeros(len(encoded) + 1, "<u4")
    if encoded:
        np.cumsum([len(b) for b in encoded], out=offs[1:])
    return offs.tobytes() + b"".join(encoded)


def _load_str_dict(f, base_off: int, col: dict) -> np.ndarray:
    sd = col["str_dict"]
    f.seek(base_off + sd["offset"])
    raw = f.read(sd["nbytes"])
    n = sd["n_dict"]
    if len(raw) < 4 * (n + 1):
        raise ValueError("truncated string dictionary blob")
    offs = np.frombuffer(raw[: 4 * (n + 1)], "<u4").astype(np.int64)
    data = raw[4 * (n + 1):]
    if offs.size and offs[-1] > len(data):
        raise ValueError("truncated string dictionary blob")
    return np.array([data[offs[i]:offs[i + 1]].decode("utf-8")
                     for i in range(n)])


def _factorize_strings(name: str, arr: np.ndarray):
    """String column -> (sorted unicode dictionary, flat u32 codes)."""
    if arr.ndim != 1:
        raise ValueError(f"string column {name!r} must be 1-D, got {arr.shape}")
    if arr.dtype.kind == "S":
        arr = np.char.decode(arr, "utf-8")
    else:
        arr = arr.astype(np.str_)
    dictionary, inverse = np.unique(arr, return_inverse=True)
    return dictionary, inverse.astype(np.uint32)



def write_table(path: str, columns: Dict[str, np.ndarray], dtypes=None,
                codec: str = "auto", chunk_blocks: int = 1024) -> dict:
    """Compress named columns into one table file. `dtypes` optionally maps
    column name -> dtype (default: each array's own unsigned dtype)."""
    dtypes = dtypes or {}
    cols_meta, payloads, offset = {}, [], 0
    for name, arr in columns.items():
        # nullable input: np.ma masked arrays (any dtype) or object arrays
        # holding None (strings) — values forward-fill, the mask becomes a
        # per-block validity bitmap blob
        arr, null_mask = fio.extract_null_mask(arr)
        if null_mask is not None:
            arr = fio.fill_nulls(arr, null_mask)
        arr = np.asarray(arr)
        transform = None
        vtype = None
        str_blob = None
        # logical-type normalization: bools ride u8, temporal types ride
        # their int64 storage (sorted timestamps delta-compress tightly);
        # the vtype restores the logical dtype on read
        logical = None
        if arr.dtype == np.bool_:
            logical = "bool"
            arr = arr.astype(np.uint8)
        elif arr.dtype.kind in ("M", "m"):  # datetime64 / timedelta64
            logical = str(arr.dtype)
            arr = arr.view(np.int64)
        if arr.dtype.kind in ("U", "S", "O"):
            # string column: sorted dictionary blob + u32 codes riding the
            # standard integer chunk machinery (codes of sorted dictionaries
            # compare like the strings themselves)
            if name in dtypes:
                raise ValueError(f"string column {name!r} chooses its own wire dtype")
            if codec in ("alp", "alprd"):
                raise ValueError(
                    f"string column {name!r} cannot use the float codec {codec!r}")
            dictionary, codes = _factorize_strings(name, arr)
            str_blob = _encode_str_dict(dictionary)
            n_dict = int(dictionary.size)
            vtype = "str"
            dtype = "u32"
            blocks, n_values = fio.pad_to_blocks(codes, dtype)
            zsrc, zkind = codes.reshape(-1).astype(np.uint32), "int"
            encode_one = lambda part, dt=dtype: fio._encode_chunk(part, dt, codec)  # noqa: E731
        elif arr.dtype.kind == "f":  # float column -> ALP (see fio.write_file)
            if name in dtypes:
                raise ValueError(f"float column {name!r} chooses its own wire dtype")
            if codec not in ("auto", "alp", "alprd"):
                raise ValueError(
                    f"float column {name!r} uses the 'alp'/'alprd' codecs, "
                    f"not {codec!r}")
            vtype = "f32" if arr.dtype == np.float32 else "f64"
            dtype = "u32" if vtype == "f32" else "u64"
            zsrc, zkind = arr.reshape(-1), vtype  # pre-pad: true values only
            blocks, n_values = fio._pad_to_blocks_float(arr)
            encode_one = lambda part, dt=dtype: fio._encode_chunk_float(  # noqa: E731
                part, dt, codec)
        else:
            presigned = None
            if name not in dtypes and arr.dtype.kind == "i":
                presigned = arr  # zone stats: the logical signed domain
                arr, transform = fio.choose_signed_transform(arr, chunk_blocks)
            dtype = layout.canon_dtype(dtypes.get(name, arr.dtype))
            blocks, n_values = fio.pad_to_blocks(arr, dtype)
            zsrc = (presigned.reshape(-1) if transform is not None
                    else blocks.reshape(-1)[:n_values])
            if dtype == "u64":  # limb compares run in int64 order
                zsrc = zsrc.view(np.int64)
            zkind = "int"
            encode_one = lambda part, dt=dtype: fio._encode_chunk(part, dt, codec)  # noqa: E731
        zmask = None if null_mask is None else null_mask.reshape(-1)
        chunks = []
        for start in range(0, blocks.shape[0], chunk_blocks):
            part = blocks[start:start + chunk_blocks]
            meta, payload = encode_one(part)
            a = start * layout.BLOCK
            b = min((start + len(part)) * layout.BLOCK, zsrc.size)
            st = fio.zonemaps.stats_of(
                zsrc[a:b], None if zmask is None else zmask[a:b], zkind)
            if st:
                meta["stats"] = st
            meta.update(n_blocks=len(part), offset=offset, nbytes=len(payload))
            chunks.append(meta)
            payloads.append(payload)
            offset += len(payload)
        col = {"dtype": dtype, "n_blocks": int(blocks.shape[0]),
               "chunk_blocks": chunk_blocks, "chunks": chunks}
        if n_values is not None:
            col["n_values"] = n_values
        if transform is not None:
            col["transform"] = transform
        if vtype is not None:
            col["vtype"] = vtype
        elif logical is not None:
            col["vtype"] = logical
        if str_blob is not None:
            col["str_dict"] = {"offset": offset, "nbytes": len(str_blob),
                               "n_dict": n_dict}
            payloads.append(str_blob)
            offset += len(str_blob)
        if null_mask is not None:
            nblob = fio.encode_validity(null_mask, int(blocks.shape[0]))
            col["nulls"] = {"offset": offset, "nbytes": len(nblob),
                            "n_null": int(null_mask.sum())}
            payloads.append(nblob)
            offset += len(nblob)
        cols_meta[name] = col

    header = {"version": _VERSION, "columns": cols_meta}
    hdr = json.dumps(header).encode()
    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(struct.pack("<I", len(hdr)))
        f.write(hdr)
        for payload in payloads:
            f.write(payload)
    return header


class TableWriter:
    """Streaming table writer: append equal-length row batches; a column's
    chunk encodes and spills to disk as soon as `chunk_blocks` blocks
    accumulate, so numeric memory stays O(chunk) regardless of table size.
    String columns buffer u32 codes (4 B/value) against an insertion-order
    dictionary and encode at close(), when the final dictionary can be
    sorted and the codes remapped (sorted codes == lexicographic order is
    the predicate-pushdown invariant). Nullable batches (np.ma / object
    None) accumulate a packed validity bitmap; null fills carry the last
    valid value ACROSS batches. Output is byte-identical to write_table of
    the concatenated columns.

        with TableWriter(path) as w:
            for batch in batches:
                w.append({"qty": ..., "cur": ...})
        # header available as w.header after the with-block
    """

    def __init__(self, path: str, dtypes=None, codec: str = "auto",
                 chunk_blocks: int = 1024):
        import tempfile

        self.path = path
        self.dtypes = dtypes or {}
        self.codec = codec
        self.chunk_blocks = chunk_blocks
        self.header = None
        self._cols = None  # name -> state dict
        self._spill = tempfile.NamedTemporaryFile(
            dir=os.path.dirname(os.path.abspath(path)) or ".",
            suffix=".spill", delete=False)
        self._spill_off = 0
        self._closed = False

    # -- per-column state ---------------------------------------------------

    def _init_col(self, name: str, arr: np.ndarray) -> dict:
        st = {"kind": None, "dtype": None, "logical": None, "transform": None,
              "buf": [], "masks": [], "n_values": 0, "n_null": 0,
              "chunks": [], "validity": bytearray(), "carry": None,
              "str_map": {}, "any_null": False, "n_blocks": 0,
              "lead_null": 0}  # values buffered before any valid one
        if arr.dtype == np.bool_:
            st["kind"], st["logical"], st["dtype"] = "int", "bool", "u8"
            st["transform"] = False  # unsigned storage, no transform probe
        elif arr.dtype.kind in ("M", "m"):
            # temporal: int64 storage; the signed-transform probe applies
            st["kind"], st["logical"], st["dtype"] = "int", str(arr.dtype), \
                "u64"
        elif arr.dtype.kind in ("U", "S", "O"):
            if name in self.dtypes:
                raise ValueError(
                    f"string column {name!r} chooses its own wire dtype")
            if self.codec in ("alp", "alprd"):
                raise ValueError(f"string column {name!r} cannot use the "
                                 f"float codec {self.codec!r}")
            st["kind"], st["dtype"] = "str", "u32"
            st["transform"] = False  # codes are unsigned
        elif arr.dtype.kind == "f":
            if name in self.dtypes:
                raise ValueError(
                    f"float column {name!r} chooses its own wire dtype")
            if self.codec not in ("auto", "alp", "alprd"):
                raise ValueError(
                    f"float column {name!r} uses the 'alp'/'alprd' codecs, "
                    f"not {self.codec!r}")
            st["kind"] = "float"
            st["vtype"] = "f32" if arr.dtype == np.float32 else "f64"
            st["dtype"] = "u32" if st["vtype"] == "f32" else "u64"
        else:
            st["kind"] = "int"
            if name in self.dtypes:
                st["dtype"] = layout.canon_dtype(self.dtypes[name])
                st["transform"] = False  # explicit wire dtype: reinterpret
            elif arr.dtype.kind == "i" or st["logical"]:
                st["dtype"] = layout.canon_dtype(
                    np.dtype(f"uint{arr.dtype.itemsize * 8}"))
                st["transform"] = None  # chosen at first flush probe
            else:
                st["dtype"] = layout.canon_dtype(arr.dtype)
                st["transform"] = False
        return st

    def _normalize(self, name: str, st: dict, arr) -> np.ndarray:
        """One batch -> the column's buffered domain (pre-transform values
        for ints, floats as-is, u32 insertion-order codes for strings);
        accumulates the null mask and carries fills across batches."""
        arr, mask = fio.extract_null_mask(arr)
        arr = np.asarray(arr)
        if st["logical"] == "bool":
            if arr.dtype != np.bool_ and set(np.unique(arr)) - {0, 1}:
                raise ValueError(f"column {name!r} started bool")
            arr = arr.astype(np.uint8)
        elif st["logical"]:
            if str(arr.dtype) != st["logical"]:
                raise ValueError(f"column {name!r} started {st['logical']}, "
                                 f"got {arr.dtype}")
            arr = arr.view(np.int64)
        if arr.ndim != 1:
            raise ValueError("TableWriter.append takes flat 1-D batches")
        if mask is not None:
            if not st["any_null"]:
                st["any_null"] = True
                # the bitmap starts lazily: backfill the all-valid prefix of
                # already-flushed blocks (no per-column RAM until a null)
                st["validity"] = bytearray(b"\xff" * (st["n_blocks"] * 128))
            st["n_null"] += int(mask.sum())
            arr = fio.fill_nulls(arr, mask)
            # leading nulls of THIS batch take the carried last valid value
            if st["carry"] is not None and mask[0]:
                lead = int(np.argmax(~mask)) if not mask.all() else len(mask)
                arr = arr.copy()
                arr[:lead] = st["carry"]
        st["masks"].append(np.zeros(len(arr), bool) if mask is None else mask)
        all_null = mask is not None and len(arr) and mask.all()
        no_carry = st["carry"] is None
        if len(arr) and not (no_carry and all_null):
            st["carry"] = arr[-1]
        if st["kind"] == "str":
            if no_carry and all_null:
                # placeholder codes: nothing enters the dictionary until a
                # real value arrives (rewritten below)
                st["lead_null"] += len(arr)
                return np.zeros(len(arr), np.uint32)
            if arr.dtype.kind == "S":
                arr = np.char.decode(arr, "utf-8")
            codes = np.empty(len(arr), np.uint32)
            smap = st["str_map"]
            for i, s in enumerate(arr.tolist()):
                s = str(s)
                code = smap.get(s)
                if code is None:
                    code = smap[s] = len(smap)
                codes[i] = code
            if st["lead_null"] and len(codes):
                # first valid value arrived: buffered placeholders become
                # its code, matching write_table's global forward-fill
                st["buf"] = [np.full_like(b, codes[0]) for b in st["buf"]]
                st["lead_null"] = 0
            return codes
        if no_carry and all_null:
            st["lead_null"] += len(arr)  # zeros for now, rewritten below
        elif st["lead_null"] and len(arr):
            st["buf"] = [np.full_like(b, arr[0]) for b in st["buf"]]
            st["lead_null"] = 0
        return arr

    # -- chunk plumbing -----------------------------------------------------

    def _buffered(self, st) -> int:
        return sum(len(b) for b in st["buf"])

    def _take(self, st, n: int) -> np.ndarray:
        """Pop exactly n values (or all, padded by repeat) off the buffer."""
        flat = np.concatenate(st["buf"]) if len(st["buf"]) != 1 else st["buf"][0]
        take, rest = flat[:n], flat[n:]
        st["buf"] = [rest] if len(rest) else []
        return take

    def _take_mask(self, st, n: int) -> np.ndarray:
        flat = (np.concatenate(st["masks"]) if len(st["masks"]) != 1
                else st["masks"][0])
        take, rest = flat[:n], flat[n:]
        st["masks"] = [rest] if len(rest) else []
        return take

    def _flush_chunk(self, name: str, st: dict, final: bool):
        """Encode one chunk (full, or the padded tail when `final`) and
        spill its payload; string columns only drain at close()."""
        cb = self.chunk_blocks
        have = self._buffered(st)
        n_take = min(have, cb * layout.BLOCK)
        vals = self._take(st, n_take)
        mask = self._take_mask(st, n_take)
        # zone stats BEFORE padding/transform: same domain and values as
        # write_table's per-chunk slices, so the output stays byte-identical
        if st["kind"] == "float":
            zstats = fio.zonemaps.stats_of(vals, mask, st["vtype"])
        else:
            # transform None (probe pending) or zigzag/viewu: vals ARE the
            # logical domain; transform False: the carrier reinterpretation
            zsrc = (vals if st["transform"] is not False
                    else vals.astype(layout.np_dtype(st["dtype"]),
                                     copy=False))
            if st["dtype"] == "u64":  # limb compares run in int64 order
                zsrc = zsrc.view(np.int64)
            zstats = fio.zonemaps.stats_of(zsrc, mask, "int")
        pad = (-len(vals)) % layout.BLOCK
        if pad:
            fill = vals[-1:] if len(vals) else np.zeros(1, vals.dtype)
            vals = np.concatenate([vals, np.repeat(fill, pad)])
        n_blocks = len(vals) // layout.BLOCK
        if st["kind"] == "float":
            blocks = vals.reshape(n_blocks, layout.BLOCK)
            meta, payload = fio._encode_chunk_float(blocks, st["dtype"],
                                                    self.codec)
        else:
            if st["transform"] is None:  # first flush: probe the transform
                _t_arr, st["transform"] = fio.choose_signed_transform(
                    vals, cb)
            if st["transform"] == "zigzag":
                from . import transforms

                vals = transforms.zigzag_encode_np(vals.view(
                    np.dtype(f"int{vals.dtype.itemsize * 8}")))
            elif st["transform"] == "viewu":
                vals = vals.view(np.dtype(f"uint{vals.dtype.itemsize * 8}"))
            blocks = vals.astype(layout.np_dtype(st["dtype"]),
                                 copy=False).reshape(n_blocks, layout.BLOCK)
            meta, payload = fio._encode_chunk(blocks, st["dtype"], self.codec)
        if zstats:
            meta["stats"] = zstats
        meta.update(n_blocks=n_blocks, spill=self._spill_off,
                    nbytes=len(payload))
        self._spill.write(payload)
        self._spill_off += len(payload)
        st["chunks"].append(meta)
        st["n_blocks"] += n_blocks
        if st["any_null"]:  # bitmap only materializes once a null exists
            st["validity"] += fio.encode_validity(mask, n_blocks)

    # -- public API ----------------------------------------------------------

    def append(self, batch: dict) -> None:
        if self._closed:
            raise ValueError("TableWriter is closed")
        if self._cols is None:
            self._cols = {name: self._init_col(name, np.asarray(
                fio.extract_null_mask(arr)[0])) for name, arr in batch.items()}
        if set(batch) != set(self._cols):
            raise ValueError(f"append needs all columns {sorted(self._cols)}")
        lengths = set()
        for name, arr in batch.items():
            st = self._cols[name]
            vals = self._normalize(name, st, arr)
            lengths.add(len(vals))
            st["buf"].append(vals)
            st["n_values"] += len(vals)
        if len(lengths) != 1:
            raise ValueError(f"batch columns have unequal lengths {lengths}")
        for name, st in self._cols.items():
            if st["kind"] == "str":
                continue  # drains at close (dictionary remap)
            while self._buffered(st) >= self.chunk_blocks * layout.BLOCK:
                self._flush_chunk(name, st, final=False)

    def close(self) -> dict:
        if self._closed:
            return self.header
        self._closed = True
        try:
            cols = self._cols or {}
            # finalize string columns: sorted dictionary + code remap
            str_blobs = {}
            for name, st in cols.items():
                if st["kind"] != "str":
                    continue
                if st["lead_null"] and not st["str_map"]:
                    st["str_map"][""] = 0  # all-null column: '' like write_table
                words = np.array(list(st["str_map"]), dtype=np.str_)
                order = np.argsort(words, kind="stable")
                remap = np.empty(len(words), np.uint32)
                remap[order] = np.arange(len(words), dtype=np.uint32)
                st["buf"] = [remap[b.astype(np.int64)] if len(b) else b
                             for b in st["buf"]]
                str_blobs[name] = (_encode_str_dict(words[order]),
                                   int(len(words)))
            # drain every buffer (string chunks + numeric tails)
            for name, st in cols.items():
                while self._buffered(st):
                    self._flush_chunk(name, st, final=True)
                if st["n_values"] and st["n_values"] % layout.BLOCK == 0 \
                        and st["n_blocks"] * layout.BLOCK != st["n_values"]:
                    raise AssertionError("chunk accounting is off")
            self._spill.flush()
            # assemble the final file: header, then per-column payloads in
            # write_table's order (chunks, str dict blob, validity blob)
            cols_meta, plan, offset = {}, [], 0
            for name, st in cols.items():
                chunks = []
                for meta in st["chunks"]:
                    meta = dict(meta)
                    spill_at = meta.pop("spill")
                    nbytes = meta.pop("nbytes")
                    meta["offset"] = offset  # key order matches write_table
                    meta["nbytes"] = nbytes
                    offset += nbytes
                    plan.append(("spill", spill_at, nbytes))
                    chunks.append(meta)
                col = {"dtype": st["dtype"], "n_blocks": st["n_blocks"],
                       "chunk_blocks": self.chunk_blocks, "chunks": chunks,
                       "n_values": st["n_values"]}
                if st["transform"]:
                    col["transform"] = st["transform"]
                if st["kind"] == "float":
                    col["vtype"] = st["vtype"]
                elif st["kind"] == "str":
                    col["vtype"] = "str"
                elif st["logical"]:
                    col["vtype"] = st["logical"]
                if name in str_blobs:
                    blob, n_dict = str_blobs[name]
                    col["str_dict"] = {"offset": offset, "nbytes": len(blob),
                                       "n_dict": n_dict}
                    plan.append(("raw", blob, len(blob)))
                    offset += len(blob)
                if st["any_null"]:
                    blob = bytes(st["validity"])
                    col["nulls"] = {"offset": offset, "nbytes": len(blob),
                                    "n_null": st["n_null"]}
                    plan.append(("raw", blob, len(blob)))
                    offset += len(blob)
                cols_meta[name] = col
            self.header = {"version": _VERSION, "columns": cols_meta}
            hdr = json.dumps(self.header).encode()
            with open(self.path, "wb") as f:
                f.write(MAGIC)
                f.write(struct.pack("<I", len(hdr)))
                f.write(hdr)
                with open(self._spill.name, "rb") as spill:
                    for kind, src, nbytes in plan:
                        if kind == "raw":
                            f.write(src)
                        else:
                            spill.seek(src)
                            f.write(spill.read(nbytes))
            return self.header
        finally:
            self._spill.close()
            os.unlink(self._spill.name)

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            self.close()
        else:  # error path: drop the spill file, leave no partial output
            self._closed = True
            self._spill.close()
            try:
                os.unlink(self._spill.name)
            except OSError:
                pass
        return False


@spanned("header")
def read_table_header(path: str) -> dict:
    fio.HEADER_PARSES += 1
    with open(path, "rb") as f:
        if f.read(len(MAGIC)) != MAGIC:
            raise ValueError("not an FLT table file")
        (hlen,) = struct.unpack("<I", f.read(4))
        header = json.loads(f.read(hlen).decode())
    if header["version"] != _VERSION:
        raise ValueError(f"unsupported FLT table version {header['version']}")
    return header


def _read_column(f, col: dict, base_off: int, start: int,
                 stop: Optional[int]) -> np.ndarray:
    dtype = col["dtype"]
    n = col["n_blocks"]
    full = start == 0 and stop is None
    stop = n if stop is None else min(stop, n)
    if not 0 <= start <= stop:
        raise IndexError(f"bad block range [{start}, {stop})")
    blocks = fio.read_chunk_range(f, col["chunks"], base_off,
                                  col["chunk_blocks"], start, stop, dtype)
    blocks = fio.apply_inverse_transform(blocks, col.get("transform"))
    if "nulls" in col and blocks.size:
        f.seek(base_off + col["nulls"]["offset"] + start * 128)
        valid = fio.decode_validity(f.read((stop - start) * 128),
                                    stop - start)
        blocks = np.ma.MaskedArray(blocks, mask=~valid)
    if full and "n_values" in col:
        blocks = blocks.reshape(-1)[:col["n_values"]]
    vt = col.get("vtype")
    if vt == "bool":
        return blocks.astype(bool)  # masked arrays keep their mask
    if vt is not None and vt.startswith(("datetime64", "timedelta64")):
        # datetime64[...] / timedelta64[...]: int64 storage -> logical dtype
        data = np.ma.getdata(blocks).view(np.dtype(vt))
        if isinstance(blocks, np.ma.MaskedArray):
            return np.ma.MaskedArray(data, mask=np.ma.getmaskarray(blocks))
        return data
    if col.get("vtype") == "str":
        dictionary = _load_str_dict(f, base_off, col)
        codes = np.ma.getdata(blocks)
        if codes.size and int(codes.max()) >= dictionary.size:
            raise ValueError("corrupt string column: code beyond dictionary")
        out = dictionary[codes.astype(np.int64)]
        if isinstance(blocks, np.ma.MaskedArray):
            return np.ma.MaskedArray(out, mask=np.ma.getmaskarray(blocks))
        return out
    return blocks


def _col_meta(header: dict, name: str) -> dict:
    try:
        return header["columns"][name]
    except KeyError:
        raise KeyError(f"no column {name!r}; have {sorted(header['columns'])}") from None


def read_column(path: str, name: str, start: int = 0,
                stop: Optional[int] = None) -> np.ndarray:
    """Decode blocks [start, stop) of one column — touches only its covering
    chunks. Full reads of flat-written columns are trimmed to exact length."""
    table = fio.header_of(path, table=True)
    col = _col_meta(table.header, name)
    with open(path, "rb") as f:
        return _read_column(f, col, table.base, start, stop)


def read_table(path: str, names=None) -> Dict[str, np.ndarray]:
    """Decode several (default: all) columns, parsing the header once."""
    table = fio.header_of(path, table=True)
    names = list(table.header["columns"]) if names is None else list(names)
    with open(path, "rb") as f:
        return {name: _read_column(f, _col_meta(table.header, name), table.base, 0, None)
                for name in names}
