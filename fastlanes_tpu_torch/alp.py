"""ALP: Adaptive Lossless floating-Point compression.

The NumPy encoder and decoder of the ALP and ALP_RD float codecs (Afroozeh,
Kuffo & Boncz, SIGMOD 2023), which fio.py needs to write and read the whole
FLT byte format, and the device decoders (`decode_device`,
`rd_decode_device`) on torch tensors. It is the PyTorch port's own copy of
fastlanes_tpu/alp.py. The integer-domain division helpers of that module
(`_div_pow10_f32_device`, `_div_pow10_f64_limbs`) exist because a TPU has no
correctly rounded divide; a CPU and a Hopper GPU divide correctly rounded in
f32 and f64 (torch's eager tensor / tensor; nothing on the path is built with
fast-math), so `decode_device` is the spec's one IEEE division as written.
One trap: torch divides a CUDA tensor by a PYTHON scalar as a multiply by
the reciprocal, which is not that division; see `decode_device`.

Scheme (self-consistent spec):

  encode:  ints = round(v * 10^e * 10^-f)            (host, float64 math)
  decode:  v'   = float(ints) / 10^(e-f)             (value dtype, ONE
                                                      correctly rounded
                                                      IEEE division)
  exceptions: every position where decode(encode(v)) != v bitwise (NaN,
  inf, overflow, precision loss) stores the original value verbatim and is
  patched after decode; its slot in the int stream holds a filler so it
  never widens the packed width.

10^(e-f) is exactly representable in the value dtype over the whole search
range (5^10 < 2^24 for f32, 5^18 < 2^53 for f64), so for |ints| inside the
exact-conversion range the IEEE division yields the correctly rounded
quotient. The integer stream is FFoR'd (shifted by its min) and bit-packed
with the integer codecs. float32 columns ride a u32 payload, float64 columns
a u64 payload.
"""

from __future__ import annotations

import numpy as np
import torch

# exponent search space (the ALP paper's ranges): 10^e exactly representable
# in the float64 encode domain
_MAX_E = {4: 10, 8: 18}
# f64 |ints| bound: exact int64->f64 conversion domain (f32 uses the
# tighter |i * 10^f| < 2^24 bound computed in _ok_mask)
_INT_BOUND = {8: 2 ** 52}


def _pow10(k: int, np_float) -> np.floating:
    """10^k in the value dtype — exact over the search range (see module
    docstring)."""
    return np_float(np.float64(10.0) ** k)


def _encode_ints(values64: np.ndarray, e: int, f: int) -> np.ndarray:
    """round(v * 10^e / 10^f) in float64, as int64 (non-finite/overflow
    positions produce garbage here and are filtered by _ok_mask)."""
    with np.errstate(over="ignore", invalid="ignore"):
        scaled = values64 * (np.float64(10.0) ** e) * (np.float64(10.0) ** -f)
    scaled = np.where(np.isfinite(scaled), scaled, 0.0)
    scaled = np.clip(scaled, -(2.0 ** 62), 2.0 ** 62)
    return np.round(scaled).astype(np.int64)


def _decode_np(ints: np.ndarray, e: int, f: int, np_float) -> np.ndarray:
    """ONE correctly rounded IEEE division: v = i / 10^(e-f).

    Spec note (round 3): this replaced the older multiply-then-divide chain
    (i * 10^f, then / 10^e). For every in-range f32 value the two are
    bit-identical (all intermediates exact, single rounding either way);
    for f64 the single-division form avoids a second rounding when
    i * 10^f exceeds 2^53; a device decoder has only ONE rounding to
    reproduce, with exact operands (|i| <= 2^52, 10^d = 2^d * 5^d exact
    in f64 for d <= 18)."""
    return (ints.astype(np_float) / _pow10(e - f, np_float)).astype(np_float)


def _ok_mask(values: np.ndarray, ints: np.ndarray, e: int, f: int) -> np.ndarray:
    """Positions the spec reproduces exactly AND whose int fits the device
    domain. NaN/inf fail the equality (NaN != NaN) and become exceptions.

    f32 in-range bound: |i * 10^f| < 2^24, so the scaled int is exact in
    both int32 and f32.
    f64 bound: |i| <= 2^52 (exact int64->f64 conversion; host and device
    then run the identical f64 op sequence)."""
    np_float = values.dtype.type
    if values.dtype.itemsize == 4:
        bound = ((1 << 24) - 1) // (10 ** f)
    else:
        bound = _INT_BOUND[8]
    dec = _decode_np(ints, e, f, np_float)
    # bitwise equality: value equality AND matching sign bit (-0.0 == +0.0
    # numerically but must round-trip its sign)
    ok = (dec == values) & (np.signbit(dec) == np.signbit(values))
    return ok & (ints >= -bound) & (ints <= bound)


def choose_ef(sample: np.ndarray) -> tuple[int, int]:
    """Pick (e, f) minimizing estimated bits/value on a sample: packed width
    of the FFoR'd ints plus the exception overhead (position + raw value).
    Deterministic: ties break toward smaller e, then smaller f."""
    itemsize = sample.dtype.itemsize
    vals64 = sample.astype(np.float64)
    best = (float("inf"), 0, 0)
    for e in range(_MAX_E[itemsize] + 1):
        for f in range(e + 1):
            ints = _encode_ints(vals64, e, f)
            ok = _ok_mask(sample, ints, e, f)
            n_exc = int(sample.size - np.count_nonzero(ok))
            if n_exc == sample.size:
                continue
            good = ints[ok]
            spread = int(good.max() - good.min()) if good.size else 0
            width = spread.bit_length()
            bits = width + n_exc / sample.size * (itemsize * 8 + 32)
            if bits < best[0] - 1e-9:
                best = (bits, e, f)
    return best[1], best[2]


def encode_np(values: np.ndarray, e=None, f=None) -> dict:
    """Encode a float32/float64 array. Returns
    {e, f, reference, width, ints, exc_pos, exc_val}: `ints` is the FFoR'd
    (min-shifted) non-negative unsigned stream ready for bit-packing
    (uint32 for f32, uint64 for f64); exceptions carry original values."""
    if values.dtype not in (np.float32, np.float64):
        raise ValueError(f"ALP encodes float32/float64, got {values.dtype}")
    if e is None or f is None:
        flat = values.reshape(-1)
        sample = np.ascontiguousarray(flat[:: max(1, flat.size // 2048)][:2048])
        e, f = choose_ef(sample)
    ints = _encode_ints(values.astype(np.float64), e, f)
    ok = _ok_mask(values, ints, e, f)
    exc_pos = np.flatnonzero(~ok).astype(np.uint32)
    exc_val = values.reshape(-1)[exc_pos]
    good = ints.reshape(-1)[ok.reshape(-1)]
    fill = np.int64(good[0]) if good.size else np.int64(0)
    ints = ints.reshape(-1).copy()
    ints[exc_pos] = fill
    ints = ints.reshape(values.shape)
    ref = int(ints.min()) if ints.size else 0
    shifted = ints - np.int64(ref)
    width = int(shifted.max()).bit_length() if shifted.size else 0
    u_dt = np.uint32 if values.dtype == np.float32 else np.uint64
    return {
        "e": int(e), "f": int(f), "reference": ref, "width": width,
        "ints": shifted.astype(u_dt), "exc_pos": exc_pos, "exc_val": exc_val,
    }


def decode_np(shifted: np.ndarray, e: int, f: int, reference: int,
              np_float, exc_pos=None, exc_val=None) -> np.ndarray:
    """Inverse of encode_np: unshift, multiply by FACTOR in the value dtype,
    patch exceptions."""
    ints = shifted.astype(np.int64) + np.int64(reference)
    out = np.ascontiguousarray(_decode_np(ints, e, f, np_float))
    if exc_pos is not None and len(exc_pos):
        flat = out.reshape(-1)
        flat[np.asarray(exc_pos, np.int64)] = exc_val
        out = flat.reshape(out.shape)
    return out


def _exc_index(exc_pos, device) -> torch.Tensor:
    """Exception positions (uint32 on the wire) as an int64 index tensor."""
    return torch.from_numpy(np.asarray(exc_pos).astype(np.int64)).to(device)


def _host_values(arr: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.array(arr)).to(device)  # np.array copies


def decode_device(shifted: torch.Tensor, e: int, f: int, reference: int,
                  np_float, exc_pos=None, exc_val=None) -> torch.Tensor:
    """Device twin of decode_np on a tensor: unshift -> convert -> ONE
    correctly rounded IEEE division -> scatter-patch, bit-exact with the
    host spec. `shifted` is the unpacked unsigned payload (uint32 for f32,
    uint64 for f64; the signed tensor with the same bits is accepted);
    returns float32 / float64 of the same shape on the same device.

    The int -> float step is exact only inside the encoder's bounds
    (|i * 10^f| < 2^24 for f32 through int32, |i| <= 2^52 for f64 through
    int64), so it converts from the SIGNED integer after the wrapping add of
    `reference`, never from the unsigned payload."""
    if np.dtype(np_float) == np.float64:
        int_dt, float_dt, bits = torch.int64, torch.float64, 64
    else:
        int_dt, float_dt, bits = torch.int32, torch.float32, 32
    if shifted.dtype.itemsize * 8 != bits or shifted.dtype.is_floating_point:
        raise ValueError(f"expected a {bits}-bit integer payload for "
                         f"{np.dtype(np_float).name}, got {shifted.dtype}")
    ref = int(reference) & ((1 << bits) - 1)
    if ref >= 1 << (bits - 1):
        ref -= 1 << bits
    ints = shifted.view(int_dt) + ref  # wraps mod 2^bits
    # The divisor is a TENSOR on the payload's device, never a Python number:
    # torch's CUDA kernel for `tensor / python_scalar` multiplies by the
    # reciprocal (two roundings, one ulp off for a fifth of the decimal
    # values at d=1, measured on an H100), while tensor / tensor is the IEEE
    # division the spec asks for.
    pow10 = torch.tensor(float(_pow10(e - f, np_float)), dtype=float_dt,
                         device=shifted.device)
    out = ints.to(float_dt) / pow10
    if exc_pos is not None and len(exc_pos):
        vals = _host_values(np.asarray(exc_val, np_float), out.device)
        out.view(-1).index_copy_(0, _exc_index(exc_pos, out.device), vals)
    return out


# ---------------------------------------------------------------------------
# ALP_RD: the "real doubles" fallback (ALP paper §4.3) for floats that are
# NOT decimal-like (the plain ALP scheme would emit ~100% exceptions).
# Each value's bit pattern splits at a cut point into a LEFT part (sign +
# exponent + top mantissa bits — few distinct values on real data, so
# dictionary-coded at ceil(log2(dict)) bits) and a RIGHT part (low mantissa
# bits, near-entropy, stored bit-packed verbatim). Decode is pure integer
# ops: value_bits = (dict[left_idx] << right_bits) | right. Always
# lossless; compression comes from the left dictionary.

_RD_MAX_DICT = 8  # left dictionary entries (3-bit indices, per the paper)


def rd_choose_cut(bits: np.ndarray, total_bits: int) -> int:
    """Pick right-part width minimizing estimated bits/value: right_bits +
    index bits + exception overhead. Candidate cuts keep the left part
    <= 32 bits (the dictionary-entry domain; lefts > 16 bits cost 32-bit
    exception storage on the wire, priced in below)."""
    flat = bits.reshape(-1)
    sample = flat[:: max(1, flat.size // 2048)][:2048]
    best = (float("inf"), total_bits - 1)
    for right_bits in range(max(total_bits - 32, 1), total_bits):
        left_bits = total_bits - right_bits
        lefts, counts = np.unique(sample >> right_bits, return_counts=True)
        order = np.argsort(counts)[::-1]
        in_dict = counts[order[:_RD_MAX_DICT]].sum()
        exc_rate = 1.0 - in_dict / sample.size
        idx_bits = max(1, int(np.ceil(np.log2(min(len(lefts), _RD_MAX_DICT) + 1e-9)))
                       ) if len(lefts) > 1 else 1
        exc_store = 16 if left_bits <= 16 else 32
        cost = right_bits + idx_bits + exc_rate * (exc_store + 32)
        if cost < best[0] - 1e-9:
            best = (cost, right_bits)
    return best[1]


def rd_encode_np(values: np.ndarray) -> dict:
    """Encode float32/float64 via the left/right split. Returns
    {right_bits, dict (uint16/uint32 lefts), left_idx (uint16), rights
    (uint of value size), exc_pos (uint32), exc_left (uint32)} — exceptions
    are positions whose LEFT part is outside the dictionary; their left
    value is stored verbatim and their left_idx slot is 0."""
    if values.dtype not in (np.float32, np.float64):
        raise ValueError(f"ALP_RD encodes float32/float64, got {values.dtype}")
    t = values.dtype.itemsize * 8
    u_dt = np.uint32 if t == 32 else np.uint64
    bits = values.view(u_dt)
    right_bits = rd_choose_cut(bits, t)
    lefts = (bits >> u_dt(right_bits)).reshape(-1)
    rights = bits & u_dt((1 << right_bits) - 1)
    uniq, counts = np.unique(lefts, return_counts=True)
    order = np.argsort(counts)[::-1][:_RD_MAX_DICT]
    dictionary = np.sort(uniq[order])  # deterministic wire order
    pos = np.searchsorted(dictionary, lefts)
    pos = np.clip(pos, 0, len(dictionary) - 1)
    hit = dictionary[pos] == lefts
    exc_pos = np.flatnonzero(~hit).astype(np.uint32)
    exc_left = lefts[~hit].astype(np.uint32)  # left <= 32 bits
    left_idx = np.where(hit, pos, 0).astype(np.uint16)
    return {
        "right_bits": int(right_bits),
        "dict": dictionary.astype(np.uint32),
        "left_idx": left_idx.reshape(values.shape),
        "rights": rights,
        "exc_pos": exc_pos,
        "exc_left": exc_left,
    }


def rd_decode_np(left_idx, rights, dictionary, right_bits: int, np_float,
                 exc_pos=None, exc_left=None) -> np.ndarray:
    t = np.dtype(np_float).itemsize * 8
    u_dt = np.uint32 if t == 32 else np.uint64
    lefts = dictionary.astype(u_dt)[left_idx.astype(np.int64)]
    if exc_pos is not None and len(exc_pos):
        flat = lefts.reshape(-1)
        flat[np.asarray(exc_pos, np.int64)] = exc_left.astype(u_dt)
        lefts = flat.reshape(left_idx.shape)
    bits = (lefts << u_dt(right_bits)) | rights.astype(u_dt)
    return bits.view(np_float)



def rd_decode_device(left_idx: torch.Tensor, rights: torch.Tensor, dictionary,
                     right_bits: int, np_float, exc_pos=None,
                     exc_val=None) -> torch.Tensor:
    """Device twin of rd_decode_np: dictionary gather + exception lefts
    scattered + shift/or + a view to the float dtype. `left_idx` is the
    unpacked uint16 index stream, `rights` the unpacked uint32/uint64 right
    parts, `dictionary` the host uint32 lefts, `exc_val` the exception
    lefts. All integer work runs on the signed tensors with the same bits
    (left shift and `or` do not see the sign)."""
    f64 = np.dtype(np_float) == np.float64
    if f64 and right_bits < 32:
        raise ValueError("f64 ALP_RD cut keeps right_bits >= 32")
    int_dt, float_dt = ((torch.int64, torch.float64) if f64
                        else (torch.int32, torch.float32))
    device = rights.device
    # lefts are < 2^32: int64 holds them as they are, int32 as bit patterns
    table = np.asarray(dictionary, np.uint32)
    table = table.astype(np.int64) if f64 else table.view(np.int32)
    lefts = torch.take(_host_values(table, device),
                       left_idx.view(torch.int16).to(torch.int64))
    if exc_pos is not None and len(exc_pos):
        ev = np.asarray(exc_val, np.uint32)
        ev = ev.astype(np.int64) if f64 else ev.view(np.int32)
        lefts.view(-1).index_copy_(0, _exc_index(exc_pos, device),
                                   _host_values(ev, device))
    bits = (lefts << right_bits) | rights.view(int_dt)
    return bits.view(float_dt)
