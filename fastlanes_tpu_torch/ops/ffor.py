"""torch FFoR codec: fused frame-of-reference + bit-pack and its inverse
(reference src/ffor.rs:24-50). The reference is a scalar, or one value per
block as a (B,) / (B, 1) array, unlike Delta's per-lane base."""

from __future__ import annotations

import numpy as np
import torch

from ..core import layout
from . import _engine as eng
from .bitpack import (_row_fn_of, assemble_blocks, check_packed, check_values,
                      pack_words, unpack_row_stream, words_to_packed)

_SIGNED_BY_SIZE = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def ref_int(reference, dtype) -> int:
    """The scalar reference as a Python int in [0, 2^T): a host int wraps
    mod 2^T like the Rust reference's wrapping ops; a one-element tensor or
    numpy value is read out."""
    t = layout.bit_width(dtype)
    if isinstance(reference, torch.Tensor):
        if reference.numel() != 1:
            raise ValueError("unfor_pack takes one scalar reference")
        if reference.dtype in eng.UNSIGNED.values():  # .item() via the signed bits
            reference = reference.view(_SIGNED_BY_SIZE[reference.element_size()])
        reference = reference.reshape(()).item()
    elif isinstance(reference, (np.ndarray, np.generic)):
        arr = np.asarray(reference)
        if arr.dtype == np.uint32 and layout.canon_dtype(dtype) == "u64" and arr.size == 2:
            arr = np.ascontiguousarray(arr).view(np.uint64)  # (lo, hi) limb pair
        if arr.size != 1:
            raise ValueError("unfor_pack takes one scalar reference")
        reference = arr.reshape(()).item()
    return int(reference) % (1 << t)


def is_per_block(reference, dtype) -> bool:
    """True for an array of per-block references (more than one entry; a
    two-entry uint32 array for u64 is one scalar's limb pair)."""
    if isinstance(reference, torch.Tensor):
        return reference.numel() != 1
    if isinstance(reference, np.ndarray):
        limb_pair = (reference.dtype == np.uint32 and reference.size == 2
                     and layout.canon_dtype(dtype) == "u64")
        return reference.size != 1 and not limb_pair
    return False


def ref_vec(reference, dtype, like):
    """The reference as a vec that broadcasts over (B, LANES) rows of
    `like`: a 0-d constant, or (B, 1) for per-block references."""
    if not is_per_block(reference, dtype):
        return eng.const(ref_int(reference, dtype), dtype, like.device)
    vec = eng.to_vec(reference, dtype).to(like.device).reshape(-1, 1)
    if vec.shape[0] != like.shape[0]:
        raise ValueError(
            f"per-block reference has {vec.shape[0]} entries for {like.shape[0]} blocks")
    return vec


def for_pack(values, reference, width: int, dtype):
    """FoR::for_pack (ffor.rs:24-36): pack(v.wrapping_sub(reference)). A value
    below the reference wraps mod 2^T and is then masked to W bits."""
    dtype = layout.canon_dtype(dtype)
    vec, had_batch = eng.promote_shape(eng.to_vec(values, dtype))
    check_values(vec)
    ref = ref_vec(reference, dtype, vec)
    row_src = _row_fn_of(vec, dtype)
    words = pack_words(lambda row: eng.sub(row_src(row), ref, dtype), width, dtype)
    out = words_to_packed(words, vec, dtype)
    return eng.from_vec(eng.squeeze_shape(out, had_batch), dtype)


def unfor_pack(packed, reference, width: int, dtype):
    """FoR::unfor_pack (ffor.rs:38-50): unpack + wrapping_add(reference), fused."""
    dtype = layout.canon_dtype(dtype)
    vec, had_batch = eng.promote_shape(eng.to_vec(packed, dtype))
    check_packed(vec, width, dtype)
    ref = ref_vec(reference, dtype, vec)
    rows = {row: eng.add(elem, ref, dtype)
            for row, elem in unpack_row_stream(vec, width, dtype)}
    out = eng.squeeze_shape(assemble_blocks(rows, dtype), had_batch)
    return eng.from_vec(out, dtype)
