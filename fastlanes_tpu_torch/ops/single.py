"""torch unpack_single: O(1) random access into packed blocks via the
inverse index tables (reference src/bitpacking.rs:131-232).

Per queried index at most two packed words of each block are read (lo/hi
stitch, bitpacking.rs:164-178). Vectorized over both the batch-of-blocks
axis and the index axis, so `unpack_single` doubles as a batched `take` for
packed columns. It is a gather of plain tensor ops on the payload's device;
the JAX package has no Pallas kernel for it either.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import layout
from . import _engine as eng
from .bitpack import check_packed


def unpack_single(packed, width: int, index, dtype):
    """Gather elements `index` (scalar or integer array) from packed blocks.

    packed: (B, plen) or (plen,) of the native dtype (u64 also as the
    (..., 2) uint32 limb image).
    index:  () or (K,) integers in [0, 1024): int, numpy array or tensor.
    Returns (B, K), squeezed like the inputs.
    """
    dtype = layout.canon_dtype(dtype)
    t = layout.bit_width(dtype)
    nl = layout.lanes(dtype)
    layout.check_width(dtype, width)

    vec, had_batch = eng.promote_shape(eng.to_vec(packed, dtype))
    check_packed(vec, width, dtype)
    device = vec.device

    if not isinstance(index, torch.Tensor):
        index = torch.from_numpy(np.asarray(index, dtype=np.int64))
    scalar_idx = index.ndim == 0
    idx = index.reshape(-1).to(device=device, dtype=torch.int64)

    if width == 0:
        out = eng.zeros((vec.shape[0], idx.shape[0]), dtype, device)
    else:
        lane = torch.from_numpy(layout.lanes_by_index(dtype)).to(device)[idx].to(torch.int64)
        row = torch.from_numpy(layout.rows_by_index(dtype)).to(device)[idx].to(torch.int64)
        if width == t:
            out = eng.take_cols(vec, nl * row + lane, dtype)
        else:
            start_bit = row * width
            start_word = start_bit // t
            lo_shift = start_bit % t
            remaining = t - lo_shift

            lo_word = eng.take_cols(vec, nl * start_word + lane, dtype)
            lo = eng.shr_dyn(lo_word, lo_shift, dtype)

            plen = layout.packed_len(dtype, width)
            hi_idx = torch.clamp(nl * (start_word + 1) + lane, max=plen - 1)
            hi_word = eng.take_cols(vec, hi_idx, dtype)
            hi = eng.shl_dyn(hi_word, remaining, dtype)

            stitched = eng.orr(lo, hi, dtype)
            out = eng.and_const(eng.where(remaining < width, stitched, lo, dtype),
                                (1 << width) - 1, dtype)

    out = eng.squeeze_shape(out, had_batch)
    if scalar_idx:
        out = out[..., 0]
    return eng.from_vec(out, dtype)
