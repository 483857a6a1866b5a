"""Codec classes: encode/decode pipelines composed from the kernel wrappers.

The counterpart of fastlanes_tpu/models/codecs.py. The reference crate has
no encoder of its own: tests and benches compose transpose -> delta -> pack by
hand (reference delta.rs:80-96, benches/delta.rs:16-27). These classes are
that composition as first-class API, plus automatic width /
frame-of-reference / codec selection.

A column that lies in device memory is encoded there and decoded there
again. Width selection is a host decision (the packed shape depends on it),
so `encode` computes cheap device statistics (max / min in unsigned order),
pulls one scalar per probe to the host, and then calls the kernel wrapper
(kernels/cuda_codecs.py: the CUDA kernel for a CUDA tensor, the plain
version for a CPU tensor). RLE and dictionary encode detect runs and
distinct values on the host with numpy, which for a device tensor is a copy
back; their index and code streams are packed on the device.

Device rule: `encode`, `auto_encode` and `auto_costs` take `device=None`,
which means the GPU and raises RuntimeError without one; a numpy array or a
tensor elsewhere is moved to the resolved device. `decode` runs where the
payload lies. Payload bytes are identical to the Rust crate's packed output
for the same (codec, width, params).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from .. import alp as alp_mod
from .. import fio
from ..core import layout
from ..kernels import cuda_codecs as ck
from ..ops import _engine as eng
from ..ops import orig as ops_orig
from ..ops import single as ops_single


def bits_needed(max_value: int) -> int:
    """Smallest W with max_value < 2^W (0 for max_value == 0)."""
    return int(max_value).bit_length()


def _device_max(values, dtype) -> int:
    """Maximum in unsigned order as a Python int: one scalar to the host."""
    return eng.umax(eng.to_vec(values, dtype), dtype)


def _device_min(values, dtype) -> int:
    return eng.umin(eng.to_vec(values, dtype), dtype)


@dataclasses.dataclass
class Encoded:
    """A compressed batch of 1024-value blocks.

    payload is byte-identical to the Rust crate's packed output for the same
    (codec, width, params). `params` carries the FoR reference (a Python
    int) or tensors on the payload's device: the Delta per-block base, the
    RLE counts and run values, the dictionary."""

    codec: str
    dtype: str
    width: int
    n_blocks: int
    payload: Any
    params: Any = None

    @property
    def packed_bytes(self) -> int:
        """Payload bytes plus any array params (e.g. the delta base vectors:
        LANES words per block, which persistence must store). Counted from
        shapes: nothing is copied to the host."""
        elem = layout.bit_width(self.dtype) // 8
        n = self.n_blocks * layout.packed_len(self.dtype, self.width) * elem
        for val in (self.params or {}).values():
            if isinstance(val, torch.Tensor):
                n += val.numel() * val.element_size()
            elif isinstance(val, np.ndarray):
                n += val.nbytes
            # scalar metadata is header-sized, not payload
        return n

    @property
    def raw_bytes(self) -> int:
        return self.n_blocks * layout.BLOCK * (layout.bit_width(self.dtype) // 8)

    @property
    def compression_ratio(self) -> float:
        return self.raw_bytes / max(self.packed_bytes, 1)


def _on_device(values, dtype, device) -> torch.Tensor:
    """The caller's values as the unsigned tensor of `dtype` on the
    resolved device ((B, 1024) or (1024,))."""
    arr = eng.as_unsigned(values, dtype).to(eng.resolve_device(device))
    if arr.ndim not in (1, 2) or arr.shape[-1] != layout.BLOCK:
        raise ValueError(f"values must be (B, {layout.BLOCK}) or ({layout.BLOCK},), "
                         f"got {tuple(arr.shape)}")
    return arr


def _n_blocks_of(arr) -> int:
    return 1 if arr.ndim == 1 else arr.shape[0]


def _host_blocks(arr) -> np.ndarray:
    """(B, 1024) numpy copy of a values tensor, for the host-side encoders."""
    out = arr.cpu().numpy()
    return out[None] if out.ndim == 1 else out


class Codec:
    """Base codec interface: encode (B, 1024) blocks -> Encoded -> decode."""

    name: str = "base"

    def __init__(self, dtype, width: Optional[int] = None):
        self.dtype = layout.canon_dtype(dtype)
        self.width = None if width is None else layout.check_width(self.dtype, width)

    def encode(self, values, device=None) -> Encoded:  # pragma: no cover - abstract
        raise NotImplementedError

    def decode(self, enc: Encoded):  # pragma: no cover - abstract
        raise NotImplementedError


class BitPackedCodec(Codec):
    """Plain fixed-width bit-packing (BitPacking trait, bitpacking.rs:16-59)."""

    name = "bitpack"

    def encode(self, values, device=None) -> Encoded:
        arr = _on_device(values, self.dtype, device)
        w = self.width if self.width is not None else min(
            layout.bit_width(self.dtype), bits_needed(_device_max(arr, self.dtype)))
        return Encoded(self.name, self.dtype, w, _n_blocks_of(arr),
                       ck.pack(arr, w, self.dtype))

    def decode(self, enc: Encoded):
        return ck.unpack(enc.payload, enc.width, enc.dtype)

    def decode_single(self, enc: Encoded, index):
        return ops_single.unpack_single(enc.payload, enc.width, index, enc.dtype)


class FFoRCodec(Codec):
    """Frame-of-reference + pack (FoR trait, ffor.rs:4-18). reference = min
    (one scalar per batch), width covers (max - min)."""

    name = "ffor"

    def __init__(self, dtype, width: Optional[int] = None, reference: Optional[int] = None):
        super().__init__(dtype, width)
        self.reference = reference

    def encode(self, values, device=None) -> Encoded:
        arr = _on_device(values, self.dtype, device)
        ref = self.reference if self.reference is not None else _device_min(arr, self.dtype)
        if self.width is not None:
            w = self.width
        else:
            t = layout.bit_width(self.dtype)
            spread = (_device_max(arr, self.dtype) - ref) % (1 << t)
            w = min(t, bits_needed(spread))
        return Encoded(self.name, self.dtype, w, _n_blocks_of(arr),
                       ck.for_pack(arr, ref, w, self.dtype), params={"reference": ref})

    def decode(self, enc: Encoded):
        return ck.unfor_pack(enc.payload, enc.params["reference"], enc.width, enc.dtype)


class DeltaCodec(Codec):
    """Transpose -> per-lane delta -> pack; fused decode (the delta.rs:80-96
    pipeline as a class). Stores the per-lane base (first value of each
    lane's walk, i.e. row 0: transposed positions [0, LANES), since
    index(0, lane) == lane) so the first delta is zero and sorted data packs
    to gap width; decode returns values in original order."""

    name = "delta"
    zigzag = False

    def encode(self, values, device=None) -> Encoded:
        dt = self.dtype
        arr = _on_device(values, dt, device)
        if self.width is not None:
            w = self.width
        else:
            # width probe in the original domain (no transpose materialized)
            d = ops_orig.deltas_orig(arr, dt, zigzag=self.zigzag)
            w = min(layout.bit_width(dt), bits_needed(_device_max(d, dt)))
        payload, base = ck.delta_pack_orig(arr, w, dt, zigzag=self.zigzag)
        return Encoded(self.name, dt, w, _n_blocks_of(arr), payload,
                       params={"base": base})

    def decode(self, enc: Encoded):
        return ck.undelta_pack_orig(enc.payload, enc.params["base"],
                                    enc.width, enc.dtype)


class ZDeltaCodec(DeltaCodec):
    """Delta with zigzag'd deltas: Transpose -> Delta -> zigzag -> pack.
    Plain delta wraps small NEGATIVE steps to ~2^T (full width); zigzag
    keeps them small, so noisy-sorted data packs tightly."""

    name = "zdelta"
    zigzag = True

    def decode(self, enc: Encoded):
        return ck.unzdelta_pack_orig(enc.payload, enc.params["base"],
                                     enc.width, enc.dtype)


class RLECodec(Codec):
    """Run-length encoding via the run-index vector (FastLanes VLDB'23
    family; fio's `rle` chunks as a codec class). Run detection is host-side
    numpy; the index stream (u16, W=1) is delta-packed on the device.
    Decode runs on the device: the index stream through undelta_pack_orig
    (one kernel, original order) -> one gather into the flat run-value
    stream."""

    name = "rle"

    def __init__(self, dtype, width=None):
        super().__init__(dtype, None)

    def encode(self, values, device=None) -> Encoded:
        dt = self.dtype
        arr = _on_device(values, dt, device)
        counts, run_values, idx = fio._rle_parts(_host_blocks(arr))
        payload, base = ck.delta_pack_orig(torch.from_numpy(idx).to(arr.device), 1, "u16")
        return Encoded(self.name, dt, 1, idx.shape[0], payload, params={
            "base": base,
            "counts": torch.from_numpy(counts).to(arr.device),
            "run_values": torch.from_numpy(run_values).to(arr.device)})

    def decode(self, enc: Encoded):
        p = enc.params
        idx = ck.undelta_pack_orig(enc.payload, p["base"], 1, "u16")
        counts = p["counts"]
        return eng.take_flat(p["run_values"], idx, torch.cumsum(counts, 0) - counts,
                             enc.dtype)


class DictCodec(Codec):
    """Dictionary encoding (FastLanes-family DICT, VLDB'23; not in the Rust
    crate): sorted per-batch dictionary + u16 codes packed with the standard
    bitpack machinery (fio's `dict` chunks as a codec class). Encode finds the
    distinct values host-side (np.unique) and packs the codes on the device;
    decode is a u16 unpack and one gather. Sorted dictionary => code order
    == value order, so range predicates push down as code compares."""

    name = "dict"

    def __init__(self, dtype, width=None):
        super().__init__(dtype, None)

    def encode(self, values, device=None) -> Encoded:
        dt = self.dtype
        arr = _on_device(values, dt, device)
        dictionary, codes = fio._dict_parts(_host_blocks(arr))
        if dictionary.size > fio._DICT_MAX:
            raise ValueError(
                f"dict codec: {dictionary.size} distinct values exceed the "
                f"{fio._DICT_MAX}-entry dictionary (u16 code stream)")
        w = int(max(0, int(dictionary.size) - 1).bit_length())
        payload = ck.pack(torch.from_numpy(codes).to(arr.device), w, "u16")
        return Encoded(self.name, dt, w, codes.shape[0], payload, params={
            "dictionary": torch.from_numpy(dictionary).to(arr.device)})

    def decode(self, enc: Encoded):
        codes = ck.unpack(enc.payload, enc.width, "u16")
        dictionary = enc.params["dictionary"]
        offsets = torch.zeros(codes.shape[0], dtype=torch.int64, device=codes.device)
        return eng.take_flat(dictionary, codes, offsets, enc.dtype)


class ALPCodec(Codec):
    """ALP float compression driver (see fastlanes_tpu_torch.alp): host
    encode (float64 scaling + exact-roundtrip exception detection, then the
    `pack` kernel on the device), device decode (unpack -> unshift -> one
    IEEE division -> exception scatter). `dtype` here is the VALUE dtype
    ('f32'/'f64'); the wire dtype is u32/u64. The exceptions stay on the
    host as numpy arrays, as alp.decode_device takes them."""

    name = "alp"

    def __init__(self, dtype="f32", width=None):
        if str(dtype) not in ("f32", "f64", "float32", "float64"):
            raise ValueError(f"ALPCodec takes 'f32'/'f64', got {dtype!r}")
        self.vtype = "f32" if str(dtype) in ("f32", "float32") else "f64"
        self.dtype = "u32" if self.vtype == "f32" else "u64"
        self.width = width

    def encode(self, values, device=None) -> Encoded:
        device = eng.resolve_device(device)
        if isinstance(values, torch.Tensor):
            values = values.cpu().numpy()
        arr = np.asarray(values)
        want = np.float32 if self.vtype == "f32" else np.float64
        if arr.dtype != want:
            raise ValueError(f"expected {want.__name__} values, got {arr.dtype}")
        if arr.ndim not in (1, 2) or arr.shape[-1] != layout.BLOCK:
            raise ValueError(f"values must be (B, {layout.BLOCK}) or "
                             f"({layout.BLOCK},); arbitrary lengths go through "
                             f"fio.write_file (it pads)")
        enc = alp_mod.encode_np(arr)
        w = enc["width"]
        ints = torch.from_numpy(np.ascontiguousarray(enc["ints"])).to(device)
        return Encoded(self.name, self.dtype, w, 1 if arr.ndim == 1 else arr.shape[0],
                       ck.pack(ints, w, self.dtype), params={
                           "e": enc["e"], "f": enc["f"],
                           "reference": enc["reference"],
                           "exc_pos": enc["exc_pos"], "exc_val": enc["exc_val"],
                           "vtype": self.vtype, "shape": arr.shape})

    def decode(self, enc: Encoded):
        p = enc.params
        np_float = np.float32 if p["vtype"] == "f32" else np.float64
        shifted = ck.unpack(enc.payload, enc.width, enc.dtype)
        out = alp_mod.decode_device(shifted, p["e"], p["f"], p["reference"],
                                    np_float, p["exc_pos"], p["exc_val"])
        return out.reshape(tuple(p["shape"]))


_CODECS = {c.name: c for c in (BitPackedCodec, FFoRCodec, DeltaCodec, ZDeltaCodec,
                               RLECodec, DictCodec, ALPCodec)}


def get_codec(name: str, dtype, **kw) -> Codec:
    try:
        cls = _CODECS[name]
    except KeyError:
        raise ValueError(
            f"unknown codec {name!r}; have {sorted(_CODECS)}") from None
    return cls(dtype, **kw)


def _auto_plan(arr, dt):
    """One device probe pass shared by cost model and winner encode.

    Returns (costs, widths, vmin): `costs[name]` is the EXACT payload+params
    byte count `Encoded.packed_bytes` would report for that codec (payload =
    n_blocks * packed_len(W) * elem bytes; delta/zdelta add their per-block
    (B, LANES) base, ffor's int reference is free). Each probe pulls one
    scalar to the host."""
    t = layout.bit_width(dt)
    nl = layout.lanes(dt)
    elem = t // 8
    n_blocks = _n_blocks_of(arr)

    def payload_bytes(w):
        return n_blocks * layout.packed_len(dt, w) * elem

    vmax = _device_max(arr, dt)
    vmin = _device_min(arr, dt)
    widths = {
        "bitpack": min(t, bits_needed(vmax)),
        "ffor": min(t, bits_needed((vmax - vmin) % (1 << t))),
    }
    # delta widths probed in the ORIGINAL domain: no transpose materialized
    d = ops_orig.deltas_orig(arr, dt)
    widths["delta"] = min(t, bits_needed(_device_max(d, dt)))
    del d
    zz = ops_orig.deltas_orig(arr, dt, zigzag=True)
    widths["zdelta"] = min(t, bits_needed(_device_max(zz, dt)))
    del zz
    widths["rle"] = 1
    base_bytes = n_blocks * nl * elem
    # rle exact bytes: the W=1 idx stream is 128 B/block for EVERY dtype,
    # plus the u16 base (128 B/block), int64 counts (8 B/block), and the run
    # values at elem bytes each (run count = one cheap device reduction)
    vec = eng.to_vec(arr, dt)
    n_runs = int((vec[..., 1:] != vec[..., :-1]).sum()) + n_blocks
    # dict: distinct count via ONE device sort. The count of neighbours that
    # differ is the same in any total order, so the signed order of the bit
    # pattern serves
    s = torch.sort(vec.reshape(-1)).values
    n_dict = int((s[1:] != s[:-1]).sum()) + 1
    del s
    widths["dict"] = max(0, n_dict - 1).bit_length()
    costs = {
        "bitpack": payload_bytes(widths["bitpack"]),
        "ffor": payload_bytes(widths["ffor"]),
        "delta": payload_bytes(widths["delta"]) + base_bytes,
        "zdelta": payload_bytes(widths["zdelta"]) + base_bytes,
        "rle": n_blocks * (128 + 128 + 8) + n_runs * elem,
        "dict": (n_dict * elem
                 + n_blocks * layout.packed_len("u16", widths["dict"]) * 2
                 if n_dict <= fio._DICT_MAX else float("inf")),
    }
    return costs, widths, vmin


def auto_costs(values, dtype, device=None) -> dict:
    """Exact projected packed_bytes per codec for this batch (the auto_encode
    cost model, exposed for inspection/testing)."""
    dt = layout.canon_dtype(dtype)
    costs, _, _ = _auto_plan(_on_device(values, dt, device), dt)
    return costs


# tie-break order: prefer the cheapest DECODE on equal bytes (bitpack needs
# no params, ffor one scalar add, delta a prefix sum, zdelta adds unzigzag,
# rle and dict add a gather)
_TIE_ORDER = {"bitpack": 0, "ffor": 1, "delta": 2, "zdelta": 3, "rle": 4,
              "dict": 5}


def auto_encode(values, dtype, device=None) -> Encoded:
    """Pick the smallest-output codec among bitpack/ffor/delta/zdelta/rle/dict.

    Deterministic: exact byte costs from one probe pass (see _auto_plan),
    ties broken toward the simpler decode."""
    dt = layout.canon_dtype(dtype)
    arr = _on_device(values, dt, device)
    costs, widths, vmin = _auto_plan(arr, dt)
    name = min(costs, key=lambda k: (costs[k], _TIE_ORDER[k]))
    w = widths[name]
    n_blocks = _n_blocks_of(arr)
    if name == "bitpack":
        return Encoded("bitpack", dt, w, n_blocks, ck.pack(arr, w, dt))
    if name == "ffor":
        return Encoded("ffor", dt, w, n_blocks, ck.for_pack(arr, vmin, w, dt),
                       params={"reference": vmin})
    if name == "rle":
        return RLECodec(dt).encode(arr, device=arr.device)  # host-side run detection
    if name == "dict":
        return DictCodec(dt).encode(arr, device=arr.device)  # host-side np.unique
    payload, base = ck.delta_pack_orig(arr, w, dt, zigzag=name == "zdelta")
    return Encoded(name, dt, w, n_blocks, payload, params={"base": base})
