"""torch Delta codec: per-lane running delta and prefix sum over transposed
blocks, with the fused delta_pack encoder and undelta_pack decoder
(reference src/delta.rs:24-63).

The per-lane sequential dependency of the reference (`prev` carried across
the T rows of a lane) is preserved, while the lane axis and block axis are
the vector dimensions, so LANES x B prefix sums run data-parallel."""

from __future__ import annotations

from ..core import layout
from . import _engine as eng
from .bitpack import (_row_fn_of, assemble_blocks, block_rows, check_packed,
                      check_values, pack_words, unpack_row_stream, words_to_packed)


def base_vec(base, dtype, like):
    """base: per-lane seeds, shared (LANES,) or per-block (B, LANES)
    (reference delta.rs:7), as a vec on the device of `like`."""
    nl = layout.lanes(dtype)
    vec = eng.to_vec(base, dtype)
    if vec.ndim not in (1, 2) or vec.shape[-1] != nl:
        raise ValueError(
            f"base must be ({nl},) shared or (B, {nl}) per-block, got {tuple(vec.shape)}")
    if vec.ndim == 2 and like.ndim == 2 and vec.shape[0] != like.shape[0]:
        raise ValueError(
            f"per-block base has {vec.shape[0]} rows for {like.shape[0]} blocks")
    if vec.device != like.device:
        raise ValueError(f"base lies on {vec.device}, the payload on {like.device}")
    return vec


def delta(values, base, dtype):
    """Delta::delta (delta.rs:24-33): out[idx] = next - prev, wrapping."""
    dtype = layout.canon_dtype(dtype)
    vec, had_batch = eng.promote_shape(eng.to_vec(values, dtype))
    check_values(vec)
    prev = base_vec(base, dtype, vec)
    rows = {}
    for row, nxt in block_rows(vec, dtype):
        rows[row] = eng.sub(nxt, prev, dtype)
        prev = nxt
    out = eng.squeeze_shape(assemble_blocks(rows, dtype), had_batch)
    return eng.from_vec(out, dtype)


def undelta(deltas, base, dtype):
    """Delta::undelta (delta.rs:36-45): per-lane prefix sum from base."""
    dtype = layout.canon_dtype(dtype)
    vec, had_batch = eng.promote_shape(eng.to_vec(deltas, dtype))
    prev = base_vec(base, dtype, vec)
    rows = {}
    for row, d in block_rows(vec, dtype):
        prev = eng.add(d, prev, dtype)
        rows[row] = prev
    out = eng.squeeze_shape(assemble_blocks(rows, dtype), had_batch)
    return eng.from_vec(out, dtype)


def undelta_pack(packed, base, width: int, dtype):
    """Fused Delta::undelta_pack (delta.rs:48-63): prefix-sum inside the
    unpack row stream, one pass."""
    dtype = layout.canon_dtype(dtype)
    vec, had_batch = eng.promote_shape(eng.to_vec(packed, dtype))
    check_packed(vec, width, dtype)
    prev = base_vec(base, dtype, vec)
    rows = {}
    for row, elem in unpack_row_stream(vec, width, dtype):
        prev = eng.add(elem, prev, dtype)
        rows[row] = prev
    out = eng.squeeze_shape(assemble_blocks(rows, dtype), had_batch)
    return eng.from_vec(out, dtype)


def delta_pack(values, base, width: int, dtype):
    """Fused encode: pack(delta(values, base)) in one pass (the composition
    the reference leaves to callers, delta.rs:80-96). The state carried down
    a lane is the previous row's unmasked value, not its delta."""
    dtype = layout.canon_dtype(dtype)
    vec, had_batch = eng.promote_shape(eng.to_vec(values, dtype))
    check_values(vec)
    prev = [base_vec(base, dtype, vec)]
    row_src = _row_fn_of(vec, dtype)

    def row_fn(row):
        nxt = row_src(row)
        out = eng.sub(nxt, prev[0], dtype)
        prev[0] = nxt
        return out

    out = words_to_packed(pack_words(row_fn, width, dtype), vec, dtype)
    return eng.from_vec(eng.squeeze_shape(out, had_batch), dtype)
