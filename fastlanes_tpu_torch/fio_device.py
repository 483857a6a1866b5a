"""Device-side FLT reads: host IO ships only compressed bytes; the GPU
decodes.

The port of fastlanes_tpu/fio_device.py: for a width-W u32 column only W/32
of the raw bytes cross PCIe, and the CUDA decode kernels
(kernels/cuda_codecs.py) expand them to full values in device memory. One
file (`read_blocks_device`, `read_file_device`), many files with cross-file
batched launches (`read_files_device`), a pipelined stream of files
(`iter_files_device`) and one column of a table file (`read_column_device`).

Every entry takes `device=None`: None means the GPU, and raises
RuntimeError when there is none; `device="cpu"` runs the plain PyTorch
versions on the host. Results are native unsigned torch tensors (u64
included: the port has no limb planes), signed after a zigzag/viewu
transform, float32/float64 for a float column, so `tensor.cpu().numpy()`
has the dtype and bytes of the host `fio.read_file`.

Codecs: bitpack, ffor, delta, zdelta, rle, dict, alp, alprd: every codec
`fio.write_file(codec="auto")` can choose. The float codecs run the same
`unpack` kernel on their integer streams and then alp.decode_device /
alp.rd_decode_device (plain torch: one IEEE division or a shift/or, and one
scatter of the exceptions).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import alp as alp_mod
from . import fio, transforms
from .core import layout
from .kernels import cuda_codecs as ck
from .ops import _engine as eng
from .ops import ffor as ops_ffor
from .parallel import shard
from .utils import trace


class NullableColumn:
    """Device-decoded nullable column: decoded values (tensor or
    StringColumn) plus a device validity mask (True = present). The filler
    values at null positions are real neighbours (fio null compression);
    consumers must gate on `valid`."""

    def __init__(self, values, valid):
        self.values = values
        self.valid = valid

    @property
    def n_null(self) -> int:
        return int(self.valid.numel() - int(self.valid.sum()))

    def materialize(self) -> np.ma.MaskedArray:
        """Host masked array (one device fetch of values + mask)."""
        from . import fio_table

        mask = ~self.valid.cpu().numpy()
        if isinstance(self.values, fio_table.StringColumn):
            return np.ma.MaskedArray(self.values.materialize(), mask=mask)
        return np.ma.MaskedArray(self.values.cpu().numpy(), mask=mask)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"NullableColumn(valid_shape={tuple(self.valid.shape)}, "
                f"n_null={self.n_null})")


def _host_tensor(arr: np.ndarray) -> torch.Tensor:
    """Host buffer -> CPU tensor of the same dtype and bytes.
    `np.frombuffer` views of file bytes are read-only, which
    `torch.from_numpy` refuses, so those are copied first."""
    arr = np.ascontiguousarray(arr)
    if not arr.flags.writeable:
        arr = arr.copy()
    return torch.from_numpy(arr)


@trace.spanned("h2d")
def _to_device(arr: np.ndarray, device) -> torch.Tensor:
    """Host buffer -> tensor on `device` (same dtype and bytes)."""
    return _host_tensor(arr).to(device)


@trace.spanned("h2d")
def _rows_to_device(parts, device) -> torch.Tensor:
    """The host arrays `parts`, stacked along axis 0, as ONE tensor on
    `device`: each part is copied into its rows of the device tensor, so a
    run reaches the card without a host-side concatenation of its chunks.
    (With the concatenation and one large copy, a batched 42 MB ffor read on
    an H100 was slower than the chunk-by-chunk read in two paired runs;
    PERF.md, section 5. Two pairs are no proof and no gain is claimed.)"""
    first = _host_tensor(parts[0])
    rows = sum(p.shape[0] for p in parts)
    out = torch.empty((rows, *first.shape[1:]), dtype=first.dtype, device=device)
    at = 0
    for part in parts:
        out[at:at + part.shape[0]].copy_(_host_tensor(part))
        at += part.shape[0]
    return out


def _decode_chunk_device(meta: dict, raw, n_blocks: int, dtype: str, device,
                         natural=False):
    nl = layout.lanes(dtype)
    np_dt = layout.np_dtype(dtype)
    w = meta["width"]
    codec = meta["codec"]
    plen = layout.packed_len(dtype, w)

    if codec == "rle":
        return _decode_rle_batched([(meta, raw)], dtype, device)
    if codec == "dict":
        return _decode_dict_batched([(meta, raw)], dtype, device)
    if codec == "alp":
        return _decode_alp_batched([(meta, raw)], dtype, device)
    if codec == "alprd":
        np_float = fio._VTYPES[meta["vtype"]]
        packed_r, packed_i, exc_pos, exc_left = fio._split_alprd_payload(
            meta, raw, n_blocks, dtype)
        rights = ck.unpack(_to_device(packed_r, device), w, dtype)
        left_idx = ck.unpack(_to_device(packed_i, device), meta["idx_width"],
                             "u16")
        return alp_mod.rd_decode_device(
            left_idx, rights, np.asarray(meta["dict"], np.uint32), w,
            np_float, exc_pos, exc_left)
    if codec in ("delta", "zdelta"):
        base_np, packed_np = _parse_delta_payload(raw, n_blocks, dtype, nl,
                                                  np_dt, plen)
        return _decode_packed_device(
            codec, _to_device(packed_np, device), _to_device(base_np, device),
            w, None, dtype, natural=natural)
    if codec in ("bitpack", "ffor"):
        packed = _to_device(
            np.frombuffer(raw, np_dt, count=n_blocks * plen).reshape(n_blocks, plen),
            device)
        return _decode_packed_device(codec, packed, None, w,
                                     meta.get("reference"), dtype)
    raise ValueError(f"unknown codec {codec!r}")


def _parse_delta_payload(raw, n_blocks, dtype, nl, np_dt, plen):
    """Host views of a delta/zdelta chunk payload: (base, packed) numpy."""
    base = np.frombuffer(raw, np_dt, count=n_blocks * nl).reshape(n_blocks, nl)
    packed = np.frombuffer(raw, np_dt, count=n_blocks * plen,
                           offset=n_blocks * nl * np_dt.itemsize)
    return base, packed.reshape(n_blocks, plen)


def _decode_packed_device(codec, packed, base, w, ref_val, dtype,
                          natural=False):
    """Device decode of a parsed (possibly multi-chunk batched) payload.
    `natural=True` (delta-family only) keeps the transposed-domain image,
    with no untranspose relayout; callers must be order-insensitive."""
    if codec == "delta":
        if natural:
            return ck.undelta_pack(packed, base, w, dtype)
        return ck.undelta_pack_orig(packed, base, w, dtype)
    if codec == "zdelta":
        if natural:
            return ck.unzdelta_pack(packed, base, w, dtype)
        return ck.unzdelta_pack_orig(packed, base, w, dtype)
    if codec == "bitpack":
        return ck.unpack(packed, w, dtype)
    if codec == "ffor":
        # one scalar (a Python int) or one reference per block (a tensor)
        ref = ref_val if isinstance(ref_val, torch.Tensor) else int(ref_val)
        return ck.unfor_pack(packed, ref, w, dtype)
    raise ValueError(f"unknown codec {codec!r}")


#: codecs whose payloads batch across chunks (same width) into ONE kernel
#: launch and one host-to-device transfer: every integer codec (alp chunks
#: batch too, under their own signature; alprd chunks do not). rle always
#: batches (the run-index stream is W=1 by construction; run values
#: concatenate into one flat gather). A run of ffor chunks carries its
#: per-chunk references as one (B,) per-block reference beside the payload.
_BATCHABLE = ("bitpack", "ffor", "delta", "zdelta", "rle", "dict")


def _group_sig(meta):
    if meta["codec"] in _BATCHABLE:
        return (meta["codec"], meta["width"])
    if meta["codec"] == "alp":
        # alp chunks batch when the whole decode recipe matches; exception
        # positions are chunk-relative and get block offsets when merged
        return ("alp", meta["width"], meta["e"], meta["f"],
                meta["reference"], meta["vtype"])
    return None


def _decode_alp_batched(run, dtype, device):
    """One unpack launch + one scale/scatter pass for a run of alp chunks
    sharing (width, e, f, reference, vtype)."""
    meta0 = run[0][0]
    np_float = fio._VTYPES[meta0["vtype"]]
    packeds, poss, vals_list = [], [], []
    block_off = 0
    for meta, raw in run:
        packed, exc_pos, exc_val = fio._split_alp_payload(
            meta, raw, meta["n_blocks"], dtype, np_float)
        packeds.append(packed)
        poss.append(np.asarray(exc_pos, np.int64) + block_off * layout.BLOCK)
        vals_list.append(exc_val)
        block_off += meta["n_blocks"]
    shifted = ck.unpack(_rows_to_device(packeds, device), meta0["width"], dtype)
    return alp_mod.decode_device(
        shifted, meta0["e"], meta0["f"], meta0["reference"], np_float,
        np.concatenate(poss), np.concatenate(vals_list))


def _gather_flat(values_np: np.ndarray, idx: torch.Tensor, offsets: np.ndarray,
                 dtype: str, device):
    """out[b, i] = values[offsets[b] + idx[b, i]]: one device gather from a
    flat host value stream (see ops/_engine.take_flat)."""
    return eng.take_flat(_to_device(values_np, device), idx,
                         _to_device(offsets.astype(np.int64), device), dtype)


def _decode_dict_batched(run, dtype, device):
    """All dict chunks of a run decode in ONE u16 unpack launch + ONE
    gather: concatenated code streams index a flat concatenated dictionary
    via per-chunk offsets (the rle flat-run-stream trick)."""
    dicts, packeds, n_blocks_each = [], [], []
    for meta, raw in run:
        dictionary, packed = fio._split_dict_payload(
            meta, raw, meta["n_blocks"], dtype)
        dicts.append(dictionary)
        packeds.append(packed)
        n_blocks_each.append(meta["n_blocks"])
    pi = _rows_to_device(packeds, device)
    codes = ck.unpack(pi, run[0][0]["width"], "u16")
    sizes = np.array([d.size for d in dicts], np.int64)
    chunk_offsets = np.cumsum(sizes) - sizes
    block_offsets = np.repeat(chunk_offsets, n_blocks_each)
    return _gather_flat(np.concatenate(dicts), codes, block_offsets, dtype, device)


def _decode_rle_batched(run, dtype, device):
    """All rle chunks of a run decode in ONE index-decode launch + ONE
    gather: per-chunk host payload splits, then concatenated index streams
    and a flat run-value stream with global offsets."""
    pis, bvs, all_counts, rvs = [], [], [], []
    for meta, raw in run:
        counts, basev, packed_idx, run_values = fio._split_rle_payload(
            meta, raw, meta["n_blocks"], dtype)
        pis.append(packed_idx)
        bvs.append(basev)
        all_counts.append(counts)
        rvs.append(run_values)
    pi = _rows_to_device(pis, device)
    bv = _rows_to_device(bvs, device)
    return _rle_gather(pi, bv, np.concatenate(all_counts), np.concatenate(rvs),
                       dtype, device)


def _rle_gather(pi, bv, counts, run_values, dtype, device):
    idx = ck.undelta_pack_orig(pi, bv, 1, "u16")
    # gather: per-block run index + the block's offset into the flat run
    # value stream = one vectorized device gather. No per-block host loop,
    # and memory stays at the exact run count.
    offsets = np.cumsum(counts) - counts
    return _gather_flat(run_values, idx, offsets, dtype, device)


@trace.spanned("decode")
def _decode_chunks_grouped(covering, dtype, device, natural=False):
    """Decode a list of (meta, raw) chunks, batching consecutive runs with
    the same (codec, width) signature into one kernel launch. Returns
    device tensors in chunk order (merged runs yield one).
    `natural=True`: delta-family chunks keep the transposed-domain image
    (order-insensitive consumers only)."""
    parts = []
    i = 0
    while i < len(covering):
        meta, raw = covering[i]
        sig = _group_sig(meta)
        j = i + 1
        while sig is not None and j < len(covering) and \
                _group_sig(covering[j][0]) == sig:
            j += 1
        if j - i == 1:
            parts.append(_decode_chunk_device(meta, raw, meta["n_blocks"],
                                              dtype, device, natural=natural))
        else:
            parts.append(_decode_run_batched(sig, covering[i:j], dtype, device,
                                             natural=natural))
        i = j
    return parts


def _decode_run_batched(sig, run, dtype, device, natural=False):
    """Decode a run of same-signature (meta, raw) chunks in ONE kernel
    launch; returns the merged (sum-of-n_blocks, 1024) output."""
    nl = layout.lanes(dtype)
    np_dt = layout.np_dtype(dtype)
    codec = sig[0]
    # the chunks' payloads land in one device tensor, then one launch
    if codec == "rle":
        return _decode_rle_batched(run, dtype, device)
    if codec == "dict":
        return _decode_dict_batched(run, dtype, device)
    if codec == "alp":
        return _decode_alp_batched(run, dtype, device)
    w = sig[1]
    plen = layout.packed_len(dtype, w)
    base = ref = None
    if codec in ("delta", "zdelta"):
        pairs = [_parse_delta_payload(r, m["n_blocks"], dtype, nl, np_dt,
                                      plen) for m, r in run]
        base = _rows_to_device([p[0] for p in pairs], device)
        packed = _rows_to_device([p[1] for p in pairs], device)
    else:  # bitpack, ffor
        packed = _rows_to_device(
            [np.frombuffer(r, np_dt, count=m["n_blocks"] * plen)
             .reshape(m["n_blocks"], plen) for m, r in run], device)
        if codec == "ffor":
            # each chunk's reference, reduced mod 2^T as the scalar form
            # reduces it, once per block of the chunk
            refs = [ops_ffor.ref_int(m["reference"], dtype) for m, _ in run]
            ref = _to_device(np.repeat(np.array(refs, dtype=np_dt),
                                       [m["n_blocks"] for m, _ in run]), device)
    return _decode_packed_device(codec, packed, base, w, ref, dtype,
                                 natural=natural)


_FLOAT_DTYPES = {"f32": torch.float32, "f64": torch.float64}


def _concat_parts(parts, dtype, device, vtype=None):
    """Concatenate decoded chunk outputs along the block axis. No parts give
    an empty tensor of the column's dtype (float for a float `vtype`)."""
    if not parts:
        return torch.zeros((0, layout.BLOCK), device=device,
                           dtype=_FLOAT_DTYPES.get(vtype) or eng.torch_dtype(dtype))
    if len(parts) == 1:
        return parts[0]
    if parts[0].dtype.is_floating_point:  # alp/alprd column: real floats
        return torch.cat(parts, dim=0)
    return eng.from_vec(torch.cat([eng.to_vec(p, dtype) for p in parts], dim=0),
                        dtype)


def _covering(chunks, chunk_blocks: int, start: int, stop: int, part=None):
    """The chunks that cover blocks [start, stop): (their indices, the first
    block and the end block of what they give inside the range). With a
    mesh `part`, this rank's share of them: a contiguous run of the
    covering chunks (parallel.shard._chunk_span); a rank with none gives
    the empty range at `stop`."""
    idxs = [ci for ci, meta in enumerate(chunks)
            if ci * chunk_blocks < stop and ci * chunk_blocks + meta["n_blocks"] > start]
    lo, hi = shard._chunk_span(part, len(idxs))
    idxs = idxs[lo:hi]
    if not idxs:
        return idxs, stop, stop
    last = idxs[-1]
    return (idxs, max(start, idxs[0] * chunk_blocks),
            min(stop, last * chunk_blocks + chunks[last]["n_blocks"]))


def _read_chunks_device(f, chunks, base_off: int, chunk_blocks: int, idxs,
                        first: int, end: int, dtype: str, device, vtype=None):
    """Device twin of fio.read_chunk_range: reads and decodes only the chunks
    `idxs` (see `_covering`), consecutive same-(codec, width) chunks in ONE
    batched launch (_decode_chunks_grouped), and trims to blocks
    [first, end)."""
    if not idxs:
        return _concat_parts([], dtype, device, vtype)
    covering = []
    with trace.span("read"):
        for ci in idxs:
            f.seek(base_off + chunks[ci]["offset"])
            covering.append((chunks[ci], f.read(chunks[ci]["nbytes"])))
    parts = _decode_chunks_grouped(covering, dtype, device)
    blocks = _concat_parts(parts, dtype, device, vtype)
    at = idxs[0] * chunk_blocks
    return blocks[first - at:end - at]


def _apply_transform_device(blocks, transform, dtype: str):
    if transform is None:
        return blocks
    if transform == "zigzag":
        return transforms.zigzag_decode(blocks)
    if transform == "viewu":
        return blocks.view(eng.signed_dtype(dtype))
    raise ValueError(f"unknown transform {transform!r}")


def _trim_flat(blocks, n_values, first: int = 0):
    """Blocks from block `first` on, flat and cut at the column's
    `n_values` (unchanged when it has none)."""
    if n_values is None:
        return blocks
    return blocks.reshape(-1)[:_values_from(n_values, first)]


def _values_from(n_values, first: int):
    """The values of a flat column from block `first` on (None: no cut)."""
    return None if n_values is None else max(0, n_values - first * layout.BLOCK)


def _wrap_column_nulls(result, path, base_off, nulls_meta, start, stop,
                       n_values, device):
    """Attach the device validity mask for blocks [start, stop); `n_values`
    trims the mask like the values (full flat reads)."""
    valid = fio.read_validity_range(path, nulls_meta, base_off, start, stop)
    if n_values is not None:
        valid = valid.reshape(-1)[:n_values]
    return NullableColumn(result, _to_device(valid, device))


def _read_blocks(path: str, start: int, stop: Optional[int], device, part):
    """read_blocks_device's work: (this rank's blocks, or the whole range
    without a part; the first block of them, for the flat trim)."""
    file = fio.header_of(path, table=False)
    header = file.header
    dtype = header["dtype"]
    n = header["n_blocks"]
    stop = n if stop is None else min(stop, n)
    if not 0 <= start <= stop:
        raise IndexError(f"bad block range [{start}, {stop})")
    base_off = file.base
    idxs, first, end = _covering(header["chunks"], header["chunk_blocks"], start, stop,
                                 part)
    with open(path, "rb") as f:
        blocks = _read_chunks_device(f, header["chunks"], base_off, header["chunk_blocks"],
                                     idxs, first, end, dtype, device, header.get("vtype"))
    out = _apply_transform_device(blocks, header.get("transform"), dtype)
    if "nulls" in header and stop > start:
        out = _wrap_column_nulls(out, path, base_off, header["nulls"], first, end, None,
                                 device)
    return out, first


@trace.entry
def read_blocks_device(path: str, start: int = 0, stop: Optional[int] = None,
                       device=None, mesh=None):
    """Decode blocks [start, stop) of an FLT file on the accelerator.

    Returns a tensor of shape (stop-start, 1024) on `device` (None = the
    GPU; raises without one), or a NullableColumn for a nullable column.
    With `mesh` (parallel.make_mesh), the chunks that cover the range split
    over its ranks (parallel/shard.py): each rank reads and decodes only its
    own and returns its LOCAL part, on the mesh's device; the parts in rank
    order, concatenated along the first axis, are the read without a mesh.
    No collective."""
    device, part = shard._placement(device, mesh)
    return _read_blocks(path, start, stop, device, part)[0]


@trace.entry
def read_file_device(path: str, device=None, mesh=None):
    """Whole-file device decode; flat-written columns come back flat and
    trimmed to their exact original length (see fio.write_file). With
    `mesh`, this rank's local part (see read_blocks_device): its chunks'
    values, the last part cut at the column's length."""
    device, part = shard._placement(device, mesh)
    header = fio.header_of(path, table=False).header
    blocks, first = _read_blocks(path, 0, None, device, part)
    nv = header.get("n_values")
    if isinstance(blocks, NullableColumn):
        return NullableColumn(_trim_flat(blocks.values, nv, first),
                              _trim_flat(blocks.valid, nv, first))
    return _trim_flat(blocks, nv, first)


def _file_result(path, header, parts, device, first: int = 0, end=None):
    """Decoded chunk parts of one file, blocks [first, end) (the whole file
    by default) -> what read_file_device returns for it: transform applied,
    flat columns trimmed, nulls wrapped."""
    dtype = header["dtype"]
    end = header["n_blocks"] if end is None else end
    blocks = _concat_parts(parts, dtype, device, header.get("vtype"))
    blocks = _apply_transform_device(blocks, header.get("transform"), dtype)
    result = _trim_flat(blocks, header.get("n_values"), first)
    if "nulls" in header:
        result = _wrap_column_nulls(
            result, path, fio.header_of(path).base, header["nulls"],
            first, end, _values_from(header.get("n_values"), first), device)
    return result


@trace.entry
def read_files_device(paths, device=None, mesh=None) -> dict:
    """Whole-file device decode of MANY FLT files with CROSS-FILE batched
    launches: every chunk sharing a (dtype, codec, width[, alp recipe])
    signature, whichever file it came from, decodes in ONE kernel launch,
    and the per-file outputs are sliced back out. A 100-shard dataset of
    same-codec columns costs one decode launch and one slice per file.
    ffor chunks merge too: a merged run carries one reference per block
    beside the payload (kernels.cuda_codecs.unfor_pack), where the JAX
    package keeps ffor chunk by chunk. Returns {path: decoded} with the
    per-file semantics of read_file_device (transform applied, flat columns
    trimmed, nullable columns wrapped). Duplicate paths decode once. With
    `mesh`, each file's chunks split over the ranks and every value is this
    rank's local part of that file (see read_file_device)."""
    device, part = shard._placement(device, mesh)
    paths = list(dict.fromkeys(paths))  # dedupe, keep order
    headers, file_chunks, spans = {}, {}, {}
    for path in paths:
        header, idxs, raws, span = _read_raw_file(path, part)
        headers[path], spans[path] = header, span
        file_chunks[path] = [(ci, header["chunks"][ci], raw) for ci, raw in zip(idxs, raws)]

    # group every batchable chunk across files by (dtype, signature); slots
    # keep (path, chunk index) so merged outputs route back in order
    groups, singles = {}, []
    for path in paths:
        dtype = headers[path]["dtype"]
        for ci, meta, raw in file_chunks[path]:
            sig = _group_sig(meta)
            if sig is None:
                singles.append((path, ci, meta, raw))
            else:
                groups.setdefault((dtype, sig), []).append((path, ci, meta, raw))

    decoded = {}  # (path, ci) -> device part
    with trace.span("decode"):
        for (dtype, sig), members in groups.items():
            if len(members) == 1:
                singles.append(members[0])
                continue
            merged = _decode_run_batched(sig, [(m, r) for _, _, m, r in members],
                                         dtype, device)
            off = 0
            for path, ci, meta, _ in members:
                n = meta["n_blocks"]
                decoded[(path, ci)] = merged[off:off + n]
                off += n
        for path, ci, meta, raw in singles:
            decoded[(path, ci)] = _decode_chunk_device(
                meta, raw, meta["n_blocks"], headers[path]["dtype"], device)

    return {path: _file_result(
        path, headers[path], [decoded[(path, ci)] for ci, _, _ in file_chunks[path]],
        device, *spans[path]) for path in paths}


def _read_raw_file(path: str, part=None):
    """Host side of the pipeline: the header, the indices and raw bytes of
    the chunks read (this rank's share with a mesh `part`, else all) and
    the blocks [first, end) they hold."""
    file = fio.header_of(path, table=False)
    header = file.header
    idxs, first, end = _covering(header["chunks"], header["chunk_blocks"], 0,
                                 header["n_blocks"], part)
    raws = []
    with trace.span("read"), open(path, "rb") as f:
        for ci in idxs:
            meta = header["chunks"][ci]
            f.seek(file.base + meta["offset"])
            raws.append(f.read(meta["nbytes"]))
    return header, idxs, raws, (first, end)


def iter_files_device(paths, device=None, prefetch: int = 2, mesh=None):
    """Pipelined multi-file device decode: yields (path, decoded) in order,
    with the host IO of upcoming files prefetched on one reader thread while
    the GPU decodes the current one (kernel launches are asynchronous, so
    the decode of file k overlaps the read of file k+1). The streaming form
    of read_file_device for feeding a consumer from many FLT files. The
    copies to the device are ordinary pageable ones on the current stream.
    With `mesh`, each yielded value is this rank's local part of the file
    (see read_file_device), and the reader thread reads only this rank's
    chunks."""
    import collections
    from concurrent.futures import ThreadPoolExecutor

    device, part = shard._placement(device, mesh)
    paths = list(paths)
    with ThreadPoolExecutor(max_workers=1) as ex:
        pending = collections.deque()
        it = iter(paths)
        for _ in range(max(1, prefetch)):
            p = next(it, None)
            if p is not None:
                pending.append((p, ex.submit(_read_raw_file, p, part)))
        while pending:
            path, fut = pending.popleft()
            header, idxs, raws, span = fut.result()
            nxt = next(it, None)
            if nxt is not None:
                pending.append((nxt, ex.submit(_read_raw_file, nxt, part)))
            parts = _decode_chunks_grouped(
                [(header["chunks"][ci], raw) for ci, raw in zip(idxs, raws)],
                header["dtype"], device)
            yield path, _file_result(path, header, parts, device, *span)


@trace.entry
def read_column_device(path: str, name: str, start: int = 0,
                       stop: Optional[int] = None, device=None, mesh=None):
    """Decode one column of an FLTTAB table file on the accelerator: touches
    only the covering chunks, applies the column's transform, and (for full
    reads of flat-written columns) trims to exact length. Returns a tensor,
    a `fio_table.StringColumn` (u32 codes on the device, the sorted
    dictionary on the host) or a NullableColumn around either. Logical
    dtypes (bool, datetime64, timedelta64) come back as their integer
    storage; `fio_table.read_column` gives the host view. With `mesh`, this
    rank's local part (see read_blocks_device); a string column's part
    carries the whole dictionary."""
    from . import fio_table

    device, part = shard._placement(device, mesh)
    table = fio.header_of(path, table=True)
    col = fio_table._col_meta(table.header, name)
    dtype = col["dtype"]
    n = col["n_blocks"]
    full = start == 0 and stop is None
    stop = n if stop is None else min(stop, n)
    if not 0 <= start <= stop:
        raise IndexError(f"bad block range [{start}, {stop})")
    base_off = table.base
    idxs, first, end = _covering(col["chunks"], col["chunk_blocks"], start, stop, part)
    with open(path, "rb") as f:
        blocks = _read_chunks_device(f, col["chunks"], base_off, col["chunk_blocks"],
                                     idxs, first, end, dtype, device, col.get("vtype"))
        dictionary = (fio_table._load_str_dict(f, base_off, col)
                      if col.get("vtype") == "str" else None)
    out = _apply_transform_device(blocks, col.get("transform"), dtype)
    n_values = col.get("n_values") if full else None
    out = _trim_flat(out, n_values, first)
    if dictionary is not None:
        # codes stay on the device; predicates run as code compares
        out = fio_table.StringColumn(out, dictionary)
    if "nulls" in col and stop > start:
        return _wrap_column_nulls(out, path, base_off, col["nulls"], first, end,
                                  _values_from(n_values, first), device)
    return out
