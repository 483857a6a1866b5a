"""Device-side FLT reads: host IO ships only compressed bytes; the GPU
decodes.

The port of fastlanes_tpu/fio_device.py for single-file reads: for a width-W
u32 column only W/32 of the raw bytes cross PCIe, and the CUDA decode kernels
(kernels/cuda_codecs.py) expand them to full values in device memory.

Every entry takes `device=None`: None means the GPU, and raises
RuntimeError when there is none; `device="cpu"` runs the plain PyTorch
versions on the host. Results are native unsigned torch tensors (u64
included: the port has no limb planes), signed after a zigzag/viewu
transform, so `tensor.cpu().numpy()` has the dtype and bytes of the host
`fio.read_file`.

Codecs: bitpack, ffor, delta, zdelta, rle, dict: every codec
`fio.write_file(codec="auto")` can choose for an integer column. Float
columns (alp, alprd) are not ported yet and raise NotImplementedError.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import fio, transforms
from .core import layout
from .kernels import cuda_codecs as ck
from .ops import _engine as eng
from .ops import ffor as ops_ffor


class NullableColumn:
    """Device-decoded nullable column: decoded values plus a device validity
    mask (True = present). The filler values at null positions are real
    neighbours (fio null compression); consumers must gate on `valid`."""

    def __init__(self, values, valid):
        self.values = values
        self.valid = valid

    @property
    def n_null(self) -> int:
        return int(self.valid.numel() - int(self.valid.sum()))

    def materialize(self) -> np.ma.MaskedArray:
        """Host masked array (one device fetch of values + mask)."""
        mask = ~self.valid.cpu().numpy()
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


def _to_device(arr: np.ndarray, device) -> torch.Tensor:
    """Host buffer -> tensor on `device` (same dtype and bytes)."""
    return _host_tensor(arr).to(device)


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


def _not_ported(codec: str):
    return NotImplementedError(
        f"device decode of {codec!r} chunks is not ported to "
        "fastlanes_tpu_torch yet (ROADMAP.md, Queue 1: alp/alprd device "
        "decode); read the file with fastlanes_tpu_torch.fio.read_file")


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
    if codec in ("alp", "alprd"):
        raise _not_ported(codec)
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
#: launch and one host-to-device transfer: every integer codec. rle always
#: batches (the run-index stream is W=1 by construction; run values
#: concatenate into one flat gather). A run of ffor chunks carries its
#: per-chunk references as one (B,) per-block reference beside the payload.
_BATCHABLE = ("bitpack", "ffor", "delta", "zdelta", "rle", "dict")


def _group_sig(meta):
    if meta["codec"] in _BATCHABLE:
        return (meta["codec"], meta["width"])
    return None


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


def _concat_parts(parts, dtype, device):
    """Concatenate decoded chunk outputs along the block axis."""
    if not parts:
        return torch.zeros((0, layout.BLOCK), dtype=eng.torch_dtype(dtype),
                           device=device)
    if len(parts) == 1:
        return parts[0]
    return eng.from_vec(torch.cat([eng.to_vec(p, dtype) for p in parts], dim=0),
                        dtype)


def _read_chunks_device(f, chunks, base_off: int, chunk_blocks: int,
                        start: int, stop: int, dtype: str, device):
    """Device twin of fio.read_chunk_range: only covering chunks decode, and
    consecutive same-(codec, width) chunks decode in ONE batched launch
    (_decode_chunks_grouped)."""
    covering = []
    first_start = None
    for ci, meta in enumerate(chunks):
        c_start = ci * chunk_blocks
        c_stop = c_start + meta["n_blocks"]
        if c_stop <= start or c_start >= stop:
            continue
        if first_start is None:
            first_start = c_start
        f.seek(base_off + meta["offset"])
        covering.append((meta, f.read(meta["nbytes"])))
    if not covering:
        return _concat_parts([], dtype, device)
    parts = _decode_chunks_grouped(covering, dtype, device)
    blocks = _concat_parts(parts, dtype, device)
    # trim to the requested block range
    return blocks[start - first_start:stop - first_start]


def _apply_transform_device(blocks, transform, dtype: str):
    if transform is None:
        return blocks
    if transform == "zigzag":
        return transforms.zigzag_decode(blocks)
    if transform == "viewu":
        return blocks.view(eng.signed_dtype(dtype))
    raise ValueError(f"unknown transform {transform!r}")


def _trim_flat(blocks, n_values):
    if n_values is None:
        return blocks
    return blocks.reshape(-1)[:n_values]


def _wrap_column_nulls(result, path, base_off, nulls_meta, start, stop,
                       n_values, device):
    """Attach the device validity mask for blocks [start, stop); `n_values`
    trims the mask like the values (full flat reads)."""
    valid = fio.read_validity_range(path, nulls_meta, base_off, start, stop)
    if n_values is not None:
        valid = valid.reshape(-1)[:n_values]
    return NullableColumn(result, _to_device(valid, device))


def read_blocks_device(path: str, start: int = 0, stop: Optional[int] = None,
                       device=None):
    """Decode blocks [start, stop) of an FLT file on the accelerator.

    Returns a tensor of shape (stop-start, 1024) on `device` (None = the
    GPU; raises without one), or a NullableColumn for a nullable column."""
    device = eng.resolve_device(device)
    header = fio.read_header(path)
    if "vtype" in header:
        raise _not_ported(header["chunks"][0]["codec"] if header["chunks"] else "alp")
    dtype = header["dtype"]
    n = header["n_blocks"]
    stop = n if stop is None else min(stop, n)
    if not 0 <= start <= stop:
        raise IndexError(f"bad block range [{start}, {stop})")
    with open(path, "rb") as f:
        blocks = _read_chunks_device(f, header["chunks"], fio._payload_base(path),
                                     header["chunk_blocks"], start, stop, dtype,
                                     device)
    out = _apply_transform_device(blocks, header.get("transform"), dtype)
    if "nulls" in header and stop > start:
        return _wrap_column_nulls(out, path, fio._payload_base(path),
                                  header["nulls"], start, stop, None, device)
    return out


def read_file_device(path: str, device=None):
    """Whole-file device decode; flat-written columns come back flat and
    trimmed to their exact original length (see fio.write_file)."""
    header = fio.read_header(path)
    blocks = read_blocks_device(path, device=device)
    nv = header.get("n_values")
    if isinstance(blocks, NullableColumn):
        valid = blocks.valid
        if nv is not None:
            valid = valid.reshape(-1)[:nv]
        return NullableColumn(_trim_flat(blocks.values, nv), valid)
    return _trim_flat(blocks, nv)
