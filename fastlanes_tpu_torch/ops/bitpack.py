"""torch bit-packing ops: batched, plain PyTorch (CPU or CUDA tensors).

The counterpart of fastlanes_tpu/ops/bitpack.py (reference src/macros.rs
35-98 / 101-174 driven by src/bitpacking.rs:65-106):

  * the per-lane loop of the reference becomes the vector axis: every op
    below acts on (B, LANES) slabs;
  * the reference's unrolled `seq_t!` row loop is a Python loop over T rows
    with constant shifts, masks and word indices;
  * `index(row, lane)` makes each transposed row a *contiguous* slice of the
    flat block (core/layout.py), so there are no gathers, only static column
    slices and one concatenation.

The kernel-body hooks of the reference macros (`|$idx, $elem|`) survive as
`pack_words` (over a row function) and the `unpack_row_stream` generator,
which delta.py and ffor.py compose into fused encoders and decoders like
delta.rs:25-63 / ffor.rs:24-50. These functions are the plain versions that
the CUDA kernels in kernels/cuda_codecs.py are held against.
"""

from __future__ import annotations

from ..core import layout
from . import _engine as eng


def _mask_bits(width_bits: int, t: int) -> int:
    """mask(width) from reference macros.rs:141-143."""
    if width_bits == t:
        return (1 << t) - 1
    return (1 << (width_bits % t)) - 1


def pack_words(row_fn, width: int, dtype):
    """Run the pack loop over a row stream; returns the list of W word vecs.

    `row_fn(row)` returns the (B, LANES) vec of transposed row `row`, masked
    or not: masking to W bits happens here (macros.rs:74-76). Rows are asked
    for in order, once each, so a stateful `row_fn` (the delta hook) works.
    Mirrors reference macros.rs:35-98.
    """
    dtype = layout.canon_dtype(dtype)
    t = layout.bit_width(dtype)
    layout.check_width(dtype, width)

    if width == 0:
        return []
    if width == t:
        # W == T: straight copy in row order (macros.rs:54-59)
        return [row_fn(row) for row in range(t)]

    mask = (1 << width) - 1
    words = []
    tmp = None
    for row in range(t):
        src = eng.and_const(row_fn(row), mask, dtype)
        shift = (row * width) % t
        if row == 0:
            tmp = src
        else:
            tmp = eng.orr(tmp, eng.shl(src, shift, dtype), dtype)
        curr_word = (row * width) // t
        next_word = ((row + 1) * width) // t
        if next_word > curr_word:
            words.append(tmp)
            remaining = ((row + 1) * width) % t
            # carry bits that did not fit (macros.rs:89-93); width-remaining < T
            tmp = eng.shr(src, width - remaining, dtype)
    assert len(words) == width
    return words


def words_to_packed(words, vec, dtype):
    """The W word vecs of `pack_words` as one (B, plen) vec; `(B, 0)` for
    W == 0 (`vec` is the (B, 1024) input, for the batch size and device)."""
    if not words:
        return eng.zeros((vec.shape[0], 0), dtype, vec.device)
    return eng.concat_cols(words, dtype)


def unpack_row_stream(packed_vec, width: int, dtype):
    """Yield (row, (B, LANES) vec) in transposed row order from a packed vec.

    The vectorized analogue of the reference unpack! macro's kernel-body hook
    (macros.rs:101-174); fused consumers iterate this stream.
    """
    dtype = layout.canon_dtype(dtype)
    t = layout.bit_width(dtype)
    nl = layout.lanes(dtype)
    layout.check_width(dtype, width)

    def get_word(w):
        return eng.cols(packed_vec, nl * w, nl, dtype)

    if width == 0:
        zero = eng.zeros((*packed_vec.shape[:-1], nl), dtype, packed_vec.device)
        for row in range(t):
            yield row, zero
        return

    if width == t:
        for row in range(t):
            yield row, get_word(row)
        return

    src = get_word(0)
    for row in range(t):
        curr_word = (row * width) // t
        next_word = ((row + 1) * width) // t
        shift = (row * width) % t
        if next_word > curr_word:
            remaining = ((row + 1) * width) % t
            current_bits = width - remaining
            tmp = eng.and_const(eng.shr(src, shift, dtype), _mask_bits(current_bits, t), dtype)
            if next_word < width:
                src = get_word(next_word)
                stitched = eng.shl(eng.and_const(src, _mask_bits(remaining, t), dtype),
                                   current_bits, dtype)
                tmp = eng.orr(tmp, stitched, dtype)
        else:
            tmp = eng.and_const(eng.shr(src, shift, dtype), _mask_bits(width, t), dtype)
        yield row, tmp


def assemble_blocks(rows_by_row: dict, dtype):
    """Reassemble T (B, LANES) row vecs into flat (B, 1024) blocks.

    Inverse of the contiguous-row-slice decomposition: column group k of the
    (8, 128)-tiled block holds o = row_order_by_offset[k], so the flat block
    is a single static concatenation, no scatter.
    """
    dtype = layout.canon_dtype(dtype)
    order = layout.row_order_by_offset(dtype)
    pieces = []
    for s in range(8):
        for o in order:
            pieces.append(rows_by_row[o * 8 + s])
    return eng.concat_cols(pieces, dtype)


def block_rows(values_vec, dtype):
    """Yield (row, (B, LANES) vec) of a flat block vec, in transposed row order
    (the iterate!/pack! read pattern, macros.rs:12-32)."""
    dtype = layout.canon_dtype(dtype)
    nl = layout.lanes(dtype)
    for row in range(layout.bit_width(dtype)):
        yield row, eng.cols(values_vec, layout.row_offset(row), nl, dtype)


def _row_fn_of(values_vec, dtype):
    nl = layout.lanes(dtype)
    return lambda row: eng.cols(values_vec, layout.row_offset(row), nl, dtype)


def check_values(vec):
    if vec.shape[-1] != layout.BLOCK:
        raise ValueError(
            f"values must have shape (..., {layout.BLOCK}), got {tuple(vec.shape)}")


def pack(values, width: int, dtype):
    """BitPacking::pack, batched: (B, 1024) -> (B, 1024*W//T).

    W=0 gives `(B, 0)` and W=T the row-order copy; both fall out of
    `pack_words`. For u64 pass uint64 or the (..., 2) uint32 limb image; the
    result is always the native unsigned tensor."""
    return pack_map(None, values, width, dtype)


def pack_map(fn, values, width: int, dtype):
    """pack(fn(values)) with `fn` applied per transposed row slice: the
    fused-encode entry. `fn` is elementwise on a (B, LANES) signed-pattern
    vec of the dtype's width and returns one (None: plain pack).
    `delta_pack` / `for_pack` are its specialised forms (reference
    delta.rs:25-33, ffor.rs:24-35)."""
    dtype = layout.canon_dtype(dtype)
    vec, had_batch = eng.promote_shape(eng.to_vec(values, dtype))
    check_values(vec)
    base_row = _row_fn_of(vec, dtype)
    row_fn = base_row if fn is None else (lambda row: fn(base_row(row)))
    out = words_to_packed(pack_words(row_fn, width, dtype), vec, dtype)
    return eng.from_vec(eng.squeeze_shape(out, had_batch), dtype)


def check_packed(vec, width: int, dtype):
    plen = layout.packed_len(dtype, width)
    if vec.shape[-1] != plen:
        raise ValueError(
            f"packed must have shape (..., {plen}) for {dtype} W={width}, "
            f"got {tuple(vec.shape)}")


def unpack(packed, width: int, dtype):
    """BitPacking::unpack, batched: (B, 1024*W//T) -> (B, 1024).

    W=0 gives zeros and W=T is the copy of the LANES-wide word groups to
    their row offsets (macros.rs:126-132); both fall out of the row stream.
    For u64 pass uint64 or the (..., 2) uint32 limb image; the result is
    always the native unsigned tensor."""
    dtype = layout.canon_dtype(dtype)
    vec, had_batch = eng.promote_shape(eng.to_vec(packed, dtype))
    check_packed(vec, width, dtype)
    rows = dict(unpack_row_stream(vec, width, dtype))
    out = eng.squeeze_shape(assemble_blocks(rows, dtype), had_batch)
    return eng.from_vec(out, dtype)
