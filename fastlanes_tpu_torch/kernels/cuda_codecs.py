"""CUDA kernels for the FastLanes codecs: the hot compute path.

The counterpart of fastlanes_tpu/kernels/pallas_codecs.py for an NVIDIA
Hopper GPU. Each wrapper below replaces one Pallas TPU kernel, built there
from `_unpack_body` (pallas_codecs.py:213-268) or `_pack_body` (:271-289):

  unpack         replaces pallas_codecs.unpack         (:635-653)
  unfor_pack     replaces pallas_codecs.unfor_pack     (:721-735)
  undelta_pack   replaces pallas_codecs.undelta_pack   (:656-671)
  unzdelta_pack  replaces pallas_codecs.unzdelta_pack  (:674-703)
  pack           replaces pallas_codecs.pack           (:611-625)
  delta_pack     replaces pallas_codecs.delta_pack     (:706-718)
  for_pack       replaces pallas_codecs.for_pack       (:898-909)

The seven are two templated kernels in csrc/codecs.cu (built by
kernels/build.py), one for decode and one for encode. Bound: memory traffic
only. A launch moves B*1024*W/8 packed bytes and B*1024*T/8 value bytes
(+ B*LANES*T/8 for a per-block base), with a few integer operations per
value. The design answers that bound with one thread per (block, lane): the
lane's words, its running sum or previous value and the word under
construction stay in registers, every global load and store is contiguous
across the lanes of a block, and nothing is staged or re-read.

Beside each kernel stands its plain PyTorch version (`*_plain`, built from
ops/). A wrapper takes the plain version only for a tensor that lies on the
CPU; for a CUDA tensor it launches the kernel or raises. `LAUNCHES[name]`
counts the kernel launches of each wrapper.

The original-order entries (`*_orig`) are transpose/untranspose gather +
kernel, the reference's own `compose` strategy. `pack_map` takes a Python
producer, which cannot enter a compiled kernel: it is the plain version on
every device, as it is ops-only in the JAX package (pallas_codecs.py:738-744).
"""

from __future__ import annotations

import torch

from .. import transforms
from ..core import layout
from ..ops import _engine as eng
from ..ops import bitpack as ops_bitpack
from ..ops import delta as ops_delta
from ..ops import ffor as ops_ffor
from ..ops import transpose as ops_transpose
from . import build

#: kernel launches per wrapper (plain integers; reset by assigning 0)
LAUNCHES = {"unpack": 0, "unfor_pack": 0, "undelta_pack": 0, "unzdelta_pack": 0,
            "pack": 0, "delta_pack": 0, "for_pack": 0}

#: op codes of the C entries fl_decode and fl_encode (csrc/codecs.cu)
_DECODE_OP = {"unpack": 0, "unfor_pack": 1, "undelta_pack": 2, "unzdelta_pack": 3}
_ENCODE_OP = {"pack": 0, "delta_pack": 1, "for_pack": 2}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# plain PyTorch versions (CPU path; held against the kernels on the card)


def unpack_plain(packed, width, dtype):
    return ops_bitpack.unpack(packed, width, dtype)


def unfor_pack_plain(packed, reference, width, dtype):
    return ops_ffor.unfor_pack(packed, reference, width, dtype)


def undelta_pack_plain(packed, base, width, dtype):
    return ops_delta.undelta_pack(packed, base, width, dtype)


def unzdelta_pack_plain(packed, base, width, dtype):
    """unpack -> unzigzag -> per-lane prefix sum from the ops layer."""
    dtype = layout.canon_dtype(dtype)
    zz = ops_bitpack.unpack(packed, width, dtype)
    deltas = transforms.zigzag_decode(zz).view(eng.torch_dtype(dtype))
    return ops_delta.undelta(deltas, base, dtype)


def pack_plain(values, width, dtype):
    return ops_bitpack.pack(values, width, dtype)


def delta_pack_plain(values, base, width, dtype):
    return ops_delta.delta_pack(values, base, width, dtype)


def for_pack_plain(values, reference, width, dtype):
    return ops_ffor.for_pack(values, reference, width, dtype)


# ---------------------------------------------------------------------------
# kernel launch


def _launch(name, src2d, base, reference, width, dtype):
    """Launch the kernel `name` on a checked, contiguous 2-D CUDA tensor:
    (B, plen) -> (B, 1024) for a decode kernel, (B, 1024) -> (B, plen) for
    an encode kernel. `base` is None or a checked CUDA tensor."""
    t = layout.bit_width(dtype)
    nl = layout.lanes(dtype)
    n_blocks = src2d.shape[0]
    encode = name in _ENCODE_OP
    out_cols = layout.packed_len(dtype, width) if encode else layout.BLOCK
    out = torch.empty((n_blocks, out_cols), dtype=src2d.dtype, device=src2d.device)
    if out.numel() == 0:
        return out  # an empty batch, or W=0 packed: nothing to write, no launch
    base_ptr, base_stride = None, 0
    if base is not None:
        base_ptr = base.data_ptr()
        base_stride = nl if base.ndim == 2 else 0
    lib = build.load()
    entry, op = (lib.fl_encode, _ENCODE_OP[name]) if encode else \
        (lib.fl_decode, _DECODE_OP[name])
    with torch.cuda.device(src2d.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = entry(op, t, src2d.data_ptr() or None, out.data_ptr(), base_ptr,
                    reference, n_blocks, width, base_stride, stream or None)
    if err != 0:
        raise RuntimeError(
            f"CUDA launch of {name} ({dtype} W={width} B={n_blocks}) failed: "
            f"{lib.fl_error_string(err).decode()} ({err})")
    LAUNCHES[name] += 1
    return out


def _prep_source(src, width, dtype, encode):
    """-> (dtype, unsigned 2-D tensor, had_batch), shape-checked: (B, 1024)
    values for an encode kernel, (B, plen) packed words for a decode one."""
    dtype = layout.canon_dtype(dtype)
    layout.check_width(dtype, width)
    arr = eng.as_unsigned(src, dtype)
    if arr.ndim not in (1, 2):
        what = "values must be (1024,) or (B, 1024)" if encode else \
            "packed must be (plen,) or (B, plen)"
        raise ValueError(f"{what}, got {tuple(arr.shape)}")
    had_batch = arr.ndim == 2
    if not had_batch:
        arr = arr[None]
    if encode:
        ops_bitpack.check_values(arr)
    else:
        ops_bitpack.check_packed(arr, width, dtype)
    return dtype, arr, had_batch


def _prep_base(base, dtype, src2d):
    """Base for the kernel: unsigned, contiguous, on the source's device,
    (LANES,) shared or (B, LANES) per-block. A numpy base follows the
    source to its device; a tensor on another device raises."""
    if not isinstance(base, torch.Tensor):
        base = eng.as_unsigned(base, dtype).to(src2d.device)
    vec = ops_delta.base_vec(base, dtype, src2d)
    return eng.from_vec(vec, dtype).contiguous()


def _run(name, plain_fn, src, param, width, dtype):
    dtype, arr, had_batch = _prep_source(src, width, dtype, name in _ENCODE_OP)
    if name in ("unfor_pack", "for_pack"):
        # the kernels take one scalar, on either device
        param = ops_ffor.ref_int(param, dtype)
    if arr.device.type == "cpu":
        args = (arr,) if param is None else (arr, param)
        out = plain_fn(*args, width, dtype)
    elif arr.device.type == "cuda":
        arr = arr.contiguous()
        base, reference = None, 0
        if name in ("unfor_pack", "for_pack"):
            reference = param
        elif name not in ("unpack", "pack"):
            base = _prep_base(param, dtype, arr)
        out = _launch(name, arr, base, reference, width, dtype)
    else:
        raise RuntimeError(f"{name}: unsupported device {arr.device}")
    return out if had_batch else out[0]


# ---------------------------------------------------------------------------
# public entries (transposed order), same names and argument order as the
# Pallas module


def unpack(packed, width, dtype):
    """BitPacking::unpack over a batch: (B, plen) -> (B, 1024)."""
    return _run("unpack", unpack_plain, packed, None, width, dtype)


def unfor_pack(packed, reference, width, dtype):
    """FoR::unfor_pack: unpack + wrapping add of the scalar reference."""
    return _run("unfor_pack", unfor_pack_plain, packed, reference, width, dtype)


def undelta_pack(packed, base, width, dtype):
    """Delta::undelta_pack: unpack + per-lane running sum seeded by `base`
    ((LANES,) shared or (B, LANES) per-block)."""
    return _run("undelta_pack", undelta_pack_plain, packed, base, width, dtype)


def unzdelta_pack(packed, base, width, dtype):
    """Fused zdelta decode: unpack -> unzigzag -> per-lane running sum."""
    return _run("unzdelta_pack", unzdelta_pack_plain, packed, base, width, dtype)


def pack(values, width, dtype):
    """BitPacking::pack over a batch: (B, 1024) -> (B, plen). W=0 gives
    `(B, 0)` without a launch."""
    return _run("pack", pack_plain, values, None, width, dtype)


def delta_pack(values, base, width, dtype):
    """Fused pack(delta(values, base)): per-lane wrapping delta seeded by
    `base` ((LANES,) shared or (B, LANES) per-block), then pack."""
    return _run("delta_pack", delta_pack_plain, values, base, width, dtype)


def for_pack(values, reference, width, dtype):
    """FoR::for_pack: wrapping subtract of the scalar reference, then pack."""
    return _run("for_pack", for_pack_plain, values, reference, width, dtype)


def pack_map(fn, values, width, dtype):
    """Fused-encode entry with a Python producer applied per row slice (see
    ops.bitpack.pack_map): plain PyTorch on every device."""
    return ops_bitpack.pack_map(fn, values, width, dtype)


# -- original-order entries: kernel + transpose/untranspose gather. FLT
#    delta/zdelta/rle chunks store transposed blocks; the decode entries
#    return ORIGINAL order and the encode entry takes it.


def unpack_orig(packed, width, dtype):
    """unpack straight to original order (macros.rs:101-174 composed with
    transpose.rs:18-22)."""
    return ops_transpose.untranspose(unpack(packed, width, dtype), dtype)


def undelta_pack_orig(packed, base, width, dtype):
    """Delta decode to original order (delta.rs:48-63 composed with
    transpose.rs:18-22): the sorted-column file-read path."""
    return ops_transpose.untranspose(undelta_pack(packed, base, width, dtype), dtype)


def unzdelta_pack_orig(packed, base, width, dtype):
    """zdelta decode to original order."""
    return ops_transpose.untranspose(unzdelta_pack(packed, base, width, dtype), dtype)


def delta_pack_orig(values, width, dtype, *, zigzag=False):
    """ENCODE dual: ORIGINAL-order values -> (packed, base) for the
    delta/zdelta wire format, in the reference's `compose` form
    (pallas_codecs.py:874-895): transpose gather, base = row 0 of each
    transposed block, then the delta_pack kernel; with zigzag, the plain
    delta, zigzag, then the pack kernel. The returned base owns its memory."""
    dtype = layout.canon_dtype(dtype)
    layout.check_width(dtype, width)
    nl = layout.lanes(dtype)
    tr = ops_transpose.transpose(eng.as_unsigned(values, dtype), dtype)
    base = tr[..., :nl].contiguous()
    if not zigzag:
        return delta_pack(tr, base, width, dtype), base
    zz = transforms.zigzag_unsigned(ops_delta.delta(tr, base, dtype))
    return pack(zz, width, dtype), base
