"""Original-order encode: the semantics of fastlanes_tpu/ops/orig.py's encode
duals (`deltas_orig`, `delta_pack_orig`), plain PyTorch.

FLT delta/zdelta chunks store TRANSPOSED blocks: transposed(r, l) =
orig[seg_of_lane[l]*T + r] (transpose.rs:29-36), so a (B, LANES, T) view of
the original-order block plus one lane-axis gather exposes every transposed
row as a minor-axis slice. The reference's `od`/`gat`/`rep` formulations of
the decode side are TPU lowerings and are not carried over; results here are
bit-identical to them.
"""

from __future__ import annotations

import functools

import torch

from .. import transforms
from ..core import layout
from . import _engine as eng
from .bitpack import check_values, pack_words, words_to_packed


@functools.lru_cache(maxsize=None)
def _seg_of_lane(dtype) -> tuple:
    """transposed(r, l) = orig[_seg_of_lane[l]*T + r]."""
    t = layout.bit_width(dtype)
    return tuple(int(layout.transpose_index(layout.index(0, lane, dtype)) // t)
                 for lane in range(layout.lanes(dtype)))


def _orig_rows(vec, dtype):
    """(B, 1024) original order -> (B, LANES, T) with [:, l, r] =
    transposed(r, l): reshape + one lane-axis gather."""
    t = layout.bit_width(dtype)
    nl = layout.lanes(dtype)
    seg = torch.tensor(_seg_of_lane(dtype), dtype=torch.int64, device=vec.device)
    return torch.index_select(vec.reshape(vec.shape[0], nl, t), 1, seg)


def _zigzag_vec(d):
    return transforms.zigzag_encode(d).view(d.dtype)


def deltas_orig(values, dtype, *, zigzag: bool = False):
    """The delta image (rows 1..T-1; row 0 against the per-block base is
    zero) computed from ORIGINAL-order values without a transpose. Order is
    lane-major: meant for width selection (its maximum), not the wire.
    Returns a (B, LANES, T-1) unsigned tensor."""
    dtype = layout.canon_dtype(dtype)
    vec, _ = eng.promote_shape(eng.to_vec(values, dtype))
    check_values(vec)
    p3 = _orig_rows(vec, dtype)
    d = eng.sub(p3[..., 1:], p3[..., :-1], dtype)
    if zigzag:
        d = _zigzag_vec(d)
    return eng.from_vec(d, dtype)


def delta_pack_orig(values, width, dtype, *, zigzag: bool = False):
    """ORIGINAL-order values -> (packed, base): transpose + per-lane delta
    (+ zigzag) + pack. base is the per-block transposed row 0 ((B, LANES),
    the FLT delta-chunk convention), so delta row 0 is zero."""
    dtype = layout.canon_dtype(dtype)
    layout.check_width(dtype, width)
    nl = layout.lanes(dtype)
    vec, had_batch = eng.promote_shape(eng.to_vec(values, dtype))
    check_values(vec)
    p3 = _orig_rows(vec, dtype)
    base = p3[..., 0].contiguous()

    def row_fn(r):
        if r == 0:
            return eng.zeros((vec.shape[0], nl), dtype, vec.device)
        d = eng.sub(p3[..., r], p3[..., r - 1], dtype)
        return _zigzag_vec(d) if zigzag else d

    packed = words_to_packed(pack_words(row_fn, width, dtype), vec, dtype)
    return (eng.from_vec(eng.squeeze_shape(packed, had_batch), dtype),
            eng.from_vec(eng.squeeze_shape(base, had_batch), dtype))
