"""Dtype engine: uniform integer vector ops over signed bit patterns.

The torch counterpart of fastlanes_tpu/ops/_engine.py. torch's unsigned
dtypes wider than 8 bits have no shifts or arithmetic on the CPU, so a "vec"
here is the SIGNED tensor of the same width holding the same bits
(`uint32 -> .view(torch.int32)`), for all four widths including 64: there
are no limb pairs inside the port. Two's-complement add, sub and left shift
wrap mod 2^T exactly like the unsigned ops; a right shift on a signed tensor
is arithmetic, so `shr` masks the copied sign bits off after every shift.

All shift amounts and masks are Python constants (the row loop is unrolled
like the reference's `seq_t!`), and shifts are always called with
0 <= k < T (reference src/macros.rs:74-93 / 142-165). The `*_dyn` variants
used by unpack_single take a tensor of shift amounts.

Order is the one thing a signed view gets wrong: a value at or above
2^(T-1) is negative there. `umax`/`umin` flip the top bit before the signed
reduction, which maps the unsigned order onto the signed one.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import layout

UNSIGNED = {"u8": torch.uint8, "u16": torch.uint16, "u32": torch.uint32,
            "u64": torch.uint64}
SIGNED = {"u8": torch.int8, "u16": torch.int16, "u32": torch.int32,
          "u64": torch.int64}


def resolve_device(device) -> torch.device:
    """The port's device rule: None means the GPU and raises without one;
    the CPU is used only when asked for by name."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "fastlanes_tpu_torch runs on a CUDA device by default and "
                "torch.cuda.is_available() is false; pass device='cpu' to "
                "run the plain PyTorch versions on the host")
        return torch.device("cuda")
    return torch.device(device)


def torch_dtype(dtype) -> torch.dtype:
    """The public (unsigned) torch dtype of a FastLanes dtype."""
    return UNSIGNED[layout.canon_dtype(dtype)]


def signed_dtype(dtype) -> torch.dtype:
    return SIGNED[layout.canon_dtype(dtype)]


def _signed_const(value: int, t: int) -> int:
    """A T-bit unsigned Python int as the signed int with the same bits
    (masks such as 2^64 - 1 do not fit an int64 scalar otherwise)."""
    value &= (1 << t) - 1
    return value - (1 << t) if value >= 1 << (t - 1) else value


# ---------------------------------------------------------------------------
# boundary conversion: user array <-> vec


def as_unsigned(arr, dtype) -> torch.Tensor:
    """A user-facing array as the public unsigned tensor of `dtype`.

    Accepts torch tensors and numpy arrays of the native unsigned width; for
    u64 also the uint32 image with a trailing limb axis of 2 (little-endian
    lo, hi), which is the byte image of the uint64 buffer and becomes a
    plain `view`. Numpy input lands on the CPU."""
    dtype = layout.canon_dtype(dtype)
    want = UNSIGNED[dtype]
    if isinstance(arr, np.ndarray):
        if not arr.flags.writeable:
            arr = arr.copy()  # torch.from_numpy refuses read-only buffers
        arr = torch.from_numpy(np.ascontiguousarray(arr))
    elif not isinstance(arr, torch.Tensor):
        raise TypeError(f"expected a torch.Tensor or numpy array, got {type(arr).__name__}")
    if dtype == "u64" and arr.dtype == torch.uint32:
        if arr.ndim == 0 or arr.shape[-1] != 2:
            raise ValueError("u64 limb arrays must have trailing axis 2 (lo, hi)")
        if arr.numel() == 0:  # a W=0 payload: nothing to view
            return torch.empty(arr.shape[:-1], dtype=torch.uint64, device=arr.device)
        return arr.contiguous().view(torch.uint64).squeeze(-1)
    if arr.dtype != want:
        if dtype == "u64":
            raise ValueError(
                f"u64 values must be uint64 or uint32 limb pairs, got {arr.dtype}")
        raise ValueError(f"expected {want} array for dtype {dtype}, got {arr.dtype}")
    return arr


def to_vec(arr, dtype) -> torch.Tensor:
    """User-facing array -> engine representation (signed bit pattern)."""
    return as_unsigned(arr, dtype).view(signed_dtype(dtype))


def from_vec(vec: torch.Tensor, dtype) -> torch.Tensor:
    """Engine representation -> public unsigned tensor (same bytes)."""
    return vec.view(torch_dtype(dtype))


def promote_shape(vec: torch.Tensor):
    """Ensure a leading batch axis; returns (vec2d, had_batch)."""
    if vec.ndim == 1:
        return vec[None], False
    return vec, True


def squeeze_shape(vec: torch.Tensor, had_batch: bool):
    return vec if had_batch else vec[0]


# ---------------------------------------------------------------------------
# static-constant ops (k, mask are Python ints)


def zeros(shape, dtype, device) -> torch.Tensor:
    return torch.zeros(shape, dtype=signed_dtype(dtype), device=device)


def const(value: int, dtype, device) -> torch.Tensor:
    """0-d vec holding `value` mod 2^T."""
    t = layout.bit_width(dtype)
    return torch.tensor(_signed_const(int(value), t), dtype=signed_dtype(dtype),
                        device=device)


def shl(x, k: int, dtype):
    """x << k, 0 <= k < T (wraps mod 2^T)."""
    return x if k == 0 else x << k


def shr(x, k: int, dtype):
    """x >> k (logical), 0 <= k < T: arithmetic shift, then drop the k
    copies of the sign bit."""
    if k == 0:
        return x
    t = layout.bit_width(dtype)
    return (x >> k) & ((1 << (t - k)) - 1)


def orr(x, y, dtype):
    return x | y


def and_const(x, mask: int, dtype):
    return x & _signed_const(mask, layout.bit_width(dtype))


def add(x, y, dtype):
    """Wrapping add mod 2^T."""
    return x + y


def sub(x, y, dtype):
    """Wrapping sub mod 2^T."""
    return x - y


# ---------------------------------------------------------------------------
# column slicing on the last axis (works for (B, N) and (N,) tensors)


def cols(x, start: int, n: int, dtype):
    return x[..., start:start + n]


def concat_cols(pieces, dtype):
    return torch.cat(pieces, dim=-1)


def take_cols(x, idx, dtype):
    """Gather columns of the last axis by an integer index tensor."""
    return torch.index_select(x, -1, idx)


def take_flat(table, idx, offsets, dtype):
    """out[b, i] = table[offsets[b] + idx[b, i]]: one gather from a flat
    value stream (rle run values, dict entries). The gather runs on the
    signed bit pattern (torch's unsigned dtypes have no index kernels on
    every backend)."""
    flat_idx = idx.to(torch.int64) + offsets.to(torch.int64)[:, None]
    return from_vec(torch.take(to_vec(table, dtype), flat_idx), dtype)


# ---------------------------------------------------------------------------
# dynamic-shift ops (k is an integer tensor; used by unpack_single)


def shr_dyn(x, k, dtype):
    """Logical right shift by a tensor of amounts k in [0, T): arithmetic
    shift, then a mask of the low T-k bits (built without a shift by T)."""
    t = layout.bit_width(dtype)
    k = k.to(x.dtype)
    low = torch.full_like(k, (1 << (t - 1)) - 1) >> (k - 1).clamp(min=0)
    return torch.where(k == 0, x, (x >> k.clamp(max=t - 1)) & low)


def shl_dyn(x, k, dtype):
    """Left shift by a tensor of amounts k in [0, T]; 0 where k >= T."""
    t = layout.bit_width(dtype)
    k = k.to(x.dtype)
    return torch.where(k >= t, torch.zeros_like(x), x << k.clamp(max=t - 1))


def where(cond, x, y, dtype):
    return torch.where(cond, x, y)


# ---------------------------------------------------------------------------
# unsigned order over the signed bit pattern


def _sign_bit(dtype) -> int:
    return -(1 << (layout.bit_width(dtype) - 1))


def umax(vec, dtype) -> int:
    """Largest value of `vec` in UNSIGNED order, as a Python int in
    [0, 2^T) (a u64 maximum does not fit an int64 scalar). One scalar
    leaves the device."""
    return int((vec ^ _sign_bit(dtype)).max()) - _sign_bit(dtype)


def umin(vec, dtype) -> int:
    """Smallest value of `vec` in unsigned order, as a Python int."""
    return int((vec ^ _sign_bit(dtype)).min()) - _sign_bit(dtype)
