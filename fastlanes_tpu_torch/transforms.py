"""Value transforms applied before/after the FastLanes codecs.

Zigzag maps signed integers to unsigned so small-magnitude values (positive
or negative) get small codes: u = (v << 1) ^ (v >> (T-1)) (arithmetic
shift); v = (u >> 1) ^ -(u & 1). A pre-transform, not a wire-format change:
the packed bytes remain standard FastLanes for the mapped unsigned values.

Both numpy (host IO path) and torch (device path) implementations. The torch
pair computes on the signed bit pattern of the same width, because the
unsigned torch dtypes wider than 8 bits have no shifts: the logical right
shift is an arithmetic shift followed by a mask.
"""

from __future__ import annotations

import numpy as np
import torch

_SIGNED = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
_UNSIGNED = {1: torch.uint8, 2: torch.uint16, 4: torch.uint32, 8: torch.uint64}


def zigzag_encode_np(values: np.ndarray) -> np.ndarray:
    """Signed array -> same-width unsigned zigzag codes."""
    if values.dtype.kind != "i":
        raise ValueError(f"zigzag encodes signed integers, got {values.dtype}")
    t = values.dtype.itemsize * 8
    u = values.astype(np.dtype(f"uint{t}"))
    return ((u << 1) ^ (values >> (t - 1)).astype(u.dtype))


def zigzag_decode_np(codes: np.ndarray) -> np.ndarray:
    """Unsigned zigzag codes -> signed array of the same width."""
    if codes.dtype.kind != "u":
        raise ValueError(f"zigzag decodes unsigned codes, got {codes.dtype}")
    t = codes.dtype.itemsize * 8
    s = np.dtype(f"int{t}")
    return ((codes >> 1) ^ (-(codes & 1).astype(s)).astype(codes.dtype)).astype(s)


def zigzag_encode(values: torch.Tensor) -> torch.Tensor:
    """torch twin: signed tensor -> same-width unsigned zigzag codes."""
    if values.dtype not in _SIGNED.values():
        raise ValueError(f"zigzag encodes signed integers, got {values.dtype}")
    t = values.element_size() * 8
    out = (values << 1) ^ (values >> (t - 1))
    return out.view(_UNSIGNED[values.element_size()])


def zigzag_unsigned(deltas: torch.Tensor) -> torch.Tensor:
    """Wrapping unsigned deltas -> zigzag codes (fastlanes_tpu/ops/orig.py
    `_zigzag_vec`): the same bits read as signed are the signed steps."""
    if deltas.dtype not in _UNSIGNED.values():
        raise ValueError(f"expected unsigned deltas, got {deltas.dtype}")
    return zigzag_encode(deltas.view(_SIGNED[deltas.element_size()]))


def zigzag_decode(codes: torch.Tensor) -> torch.Tensor:
    """torch twin: unsigned zigzag codes -> signed tensor of the same width."""
    if codes.dtype not in _UNSIGNED.values():
        raise ValueError(f"zigzag decodes unsigned codes, got {codes.dtype}")
    return zigzag_decode_bits(codes.view(_SIGNED[codes.element_size()]))


def zigzag_decode_bits(s: torch.Tensor) -> torch.Tensor:
    """(u >> 1) ^ -(u & 1) on the signed bit pattern `s` of the codes: the
    arithmetic shift's copied sign bit is masked off to make it logical."""
    t = s.element_size() * 8
    return ((s >> 1) & ((1 << (t - 1)) - 1)) ^ -(s & 1)
