"""CUDA kernels for the FastLanes codecs: the hot compute path.

The counterpart of fastlanes_tpu/kernels/pallas_codecs.py for an NVIDIA
Hopper GPU. Each wrapper below replaces one TPU kernel. Seven are built
there from `_unpack_body` (pallas_codecs.py:213-268) or `_pack_body`
(:271-289) and work in TRANSPOSED order:

  unpack         replaces pallas_codecs.unpack         (:635-653)
  unfor_pack     replaces pallas_codecs.unfor_pack     (:721-735)
  undelta_pack   replaces pallas_codecs.undelta_pack   (:656-671)
  unzdelta_pack  replaces pallas_codecs.unzdelta_pack  (:674-703)
  pack           replaces pallas_codecs.pack           (:611-625)
  delta_pack     replaces pallas_codecs.delta_pack     (:706-718)
  for_pack       replaces pallas_codecs.for_pack       (:898-909)

Four read or write ORIGINAL order in the same pass. On the TPU the in-kernel
relayout was tried in benchmarks/exp_untranspose_pallas.py (six kernel
bodies, `pl.pallas_call` at :292) and refused by the compiler, so the package
entries run a kernel and a second gather pass; here they are one kernel:

  unpack_orig         replaces _kernel_pD/_kernel_pF (:164/:261), entry pallas_codecs.py:805
  undelta_pack_orig   replaces _kernel_pB/_kernel_pE/_kernel_pG (:98/:171/:267), entry :820
  unzdelta_pack_orig  the same bodies with the unzigzag hook, entry :841
  delta_pack_orig     the encode dual (entry :861-895; _kernel_pA :91 is its relayout)

The eleven are four templated kernels in csrc/codecs.cu (built by
kernels/build.py) around one decode and one encode row loop. Bound: memory
traffic only. A launch moves B*1024*W/8 packed bytes and B*1024*T/8 value
bytes (+ B*LANES*T/8 for a per-block base), with a few integer operations
per value, so a kernel reaches the bound only if each warp-wide access moves
whole sectors. The decode and encode kernels give one thread PER =
4 / sizeof(T) adjacent lanes (4 for u8, 2 for u16, 1 for u32/u64): those
lanes are one aligned 32-bit word in every word group, base row and
transposed row, so the thread loads and stores 32-bit words and a warp moves
128 bytes per access for every dtype; the row loops run lane-wise on the
word (SWAR). In original order a u8/u16 thread turns its row words into
words of consecutive values of one lane with a byte transpose in registers
and stores them straight out (decode), or loads its lanes' consecutive
values and turns them back into row words (encode). u32/u64 lane segments
are 128/512 bytes: their decode copies the packed words into shared memory
lane-major and gives each thread 4 rows of one lane to compute and store as
16-byte runs (a running sum is a scan over a lane's threads); their encode
stages the values in shared memory and moves them in with consecutive
threads on consecutive words. Every source and base goes to the kernels
16-byte aligned (`_aligned`).

Beside each kernel stands its plain PyTorch version (`*_plain`, built from
ops/). A wrapper takes the plain version only for a tensor that lies on the
CPU; for a CUDA tensor it launches the kernel or raises. `LAUNCHES[name]`
counts the kernel launches of each wrapper, `LAUNCHES_BY_DTYPE[name, dtype]`
the same launches by dtype.

`pack_map` takes a Python producer, which cannot enter a compiled kernel: it
is the plain version on every device, as it is ops-only in the JAX package
(pallas_codecs.py:738-744).

`warmup` (pallas_codecs.py:926-983) loads the kernel library and launches
each requested (kernel, dtype, width) once: the cold start of a server.
"""

from __future__ import annotations

import torch

from .. import transforms
from ..core import layout
from ..ops import _engine as eng
from ..ops import bitpack as ops_bitpack
from ..ops import delta as ops_delta
from ..ops import ffor as ops_ffor
from ..ops import orig as ops_orig
from ..ops import transpose as ops_transpose
from . import build

#: kernel -> (C entry, op code, order code) of csrc/codecs.cu. Order 0 is
#: transposed, 1 original.
_KERNELS = {
    "unpack": ("fl_decode", 0, 0), "unfor_pack": ("fl_decode", 1, 0),
    "undelta_pack": ("fl_decode", 2, 0), "unzdelta_pack": ("fl_decode", 3, 0),
    "unpack_orig": ("fl_decode", 0, 1), "undelta_pack_orig": ("fl_decode", 2, 1),
    "unzdelta_pack_orig": ("fl_decode", 3, 1),
    "pack": ("fl_encode", 0, 0), "delta_pack": ("fl_encode", 1, 0),
    "for_pack": ("fl_encode", 2, 0), "delta_pack_orig": ("fl_encode", 1, 1),
}
_ZIGZAG_ENCODE_OP = 3  # delta_pack_orig(zigzag=True)
#: FastLanes blocks one CUDA block of the u32/u64 original-order decode takes
#: (OrigOut<T>::NB of csrc/codecs.cu): the edges of its grid, which the card
#: tests and chip_smoke.py probe
ORIG_DECODE_BLOCKS_PER_CTA = {"u32": 4, "u64": 2}

#: kernel launches per wrapper (plain integers; reset by assigning 0)
LAUNCHES = {name: 0 for name in _KERNELS}
#: the same launches per (wrapper, dtype); a pair appears at its first launch
LAUNCHES_BY_DTYPE = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    LAUNCHES_BY_DTYPE.clear()


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


def unpack_orig_plain(packed, width, dtype):
    return ops_transpose.untranspose(unpack_plain(packed, width, dtype), dtype)


def undelta_pack_orig_plain(packed, base, width, dtype):
    return ops_transpose.untranspose(undelta_pack_plain(packed, base, width, dtype), dtype)


def unzdelta_pack_orig_plain(packed, base, width, dtype):
    return ops_transpose.untranspose(unzdelta_pack_plain(packed, base, width, dtype), dtype)


def delta_pack_orig_plain(values, width, dtype, *, zigzag=False):
    return ops_orig.delta_pack_orig(values, width, dtype, zigzag=zigzag)


# ---------------------------------------------------------------------------
# kernel launch


def _launch(name, src2d, base, reference, width, dtype, zigzag=False):
    """Launch the kernel `name` on a checked, contiguous 2-D CUDA tensor:
    (B, plen) -> (B, 1024) for a decode kernel, (B, 1024) -> (B, plen) for
    an encode kernel. `base` is None or a checked CUDA tensor; `reference`
    a Python int or a checked (B,) CUDA tensor. `delta_pack_orig` returns
    (packed, base), the base a (B, LANES) output of the same launch."""
    t = layout.bit_width(dtype)
    nl = layout.lanes(dtype)
    n_blocks = src2d.shape[0]
    entry, op, order = _KERNELS[name]
    encode = entry == "fl_encode"
    makes_base = name == "delta_pack_orig"
    if makes_base and zigzag:
        op = _ZIGZAG_ENCODE_OP
    out_cols = layout.packed_len(dtype, width) if encode else layout.BLOCK
    out = torch.empty((n_blocks, out_cols), dtype=src2d.dtype, device=src2d.device)
    if makes_base:
        base = torch.empty((n_blocks, nl), dtype=src2d.dtype, device=src2d.device)
    result = (out, base) if makes_base else out
    # an empty batch, or W=0 packed, has nothing to write and launches
    # nothing; delta_pack_orig at W=0 still launches, for the base
    if n_blocks == 0 or (out.numel() == 0 and not makes_base):
        return result
    base_ptr, base_stride = None, 0
    if base is not None:
        base_ptr = base.data_ptr()
        base_stride = nl if base.ndim == 2 else 0
    ref_ptr, ref_stride = None, 0
    if isinstance(reference, torch.Tensor):
        ref_ptr, ref_stride, reference = reference.data_ptr(), 1, 0
    lib = build.load()
    with torch.cuda.device(src2d.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, entry)(
            op, order, t, src2d.data_ptr() or None, out.data_ptr() or None, base_ptr,
            base_stride, ref_ptr, ref_stride, reference, n_blocks, width, stream or None)
    if err != 0:
        raise RuntimeError(
            f"CUDA launch of {name} ({dtype} W={width} B={n_blocks}) failed: "
            f"{lib.fl_error_string(err).decode()} ({err})")
    LAUNCHES[name] += 1
    LAUNCHES_BY_DTYPE[name, dtype] = LAUNCHES_BY_DTYPE.get((name, dtype), 0) + 1
    return result


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
    """Base for the kernel: unsigned, contiguous, aligned, on the source's
    device, (LANES,) shared or (B, LANES) per-block. A numpy base follows
    the source to its device; a tensor on another device raises."""
    if not isinstance(base, torch.Tensor):
        base = eng.as_unsigned(base, dtype).to(src2d.device)
    vec = ops_delta.base_vec(base, dtype, src2d)
    return _aligned(eng.from_vec(vec, dtype))


def _prep_reference(reference, dtype, src2d):
    """The reference of unfor_pack / for_pack: one scalar as a Python int in
    [0, 2^T), or per-block references ((B,) or (B, 1)) as a contiguous (B,)
    unsigned tensor on the source's device. A numpy array follows the source
    to its device; a tensor on another device or of another length raises."""
    if not ops_ffor.is_per_block(reference, dtype):
        return ops_ffor.ref_int(reference, dtype)
    ref = eng.as_unsigned(reference, dtype)
    if not isinstance(reference, torch.Tensor):
        ref = ref.to(src2d.device)
    ref = ref.reshape(-1).contiguous()
    if ref.shape[0] != src2d.shape[0]:
        raise ValueError(
            f"per-block reference has {ref.shape[0]} entries for {src2d.shape[0]} blocks")
    if ref.device != src2d.device:
        raise ValueError(f"reference lies on {ref.device}, the payload on {src2d.device}")
    return ref


def _aligned(arr):
    """Contiguous and 16-byte aligned, as the kernels' word accesses
    need: a u8/u16 thread reads its packed words or values and its base as
    32-bit words (up to 16 bytes in original order), and a view into the
    middle of a buffer may not be."""
    arr = arr.contiguous()
    return arr if arr.data_ptr() % 16 == 0 else arr.clone()


def _run(name, plain_fn, src, param, width, dtype, **plain_kwargs):
    entry = _KERNELS[name][0]
    dtype, arr, had_batch = _prep_source(src, width, dtype, entry == "fl_encode")
    if name in ("unfor_pack", "for_pack"):
        param = _prep_reference(param, dtype, arr)
    if arr.device.type == "cpu":
        args = (arr,) if param is None else (arr, param)
        out = plain_fn(*args, width, dtype, **plain_kwargs)
    elif arr.device.type == "cuda":
        base, reference = None, 0
        if name in ("unfor_pack", "for_pack"):
            reference = param
        elif param is not None:
            base = _prep_base(param, dtype, arr)
        out = _launch(name, _aligned(arr), base, reference, width, dtype, **plain_kwargs)
    else:
        raise RuntimeError(f"{name}: unsupported device {arr.device}")
    if had_batch:
        return out
    return tuple(o[0] for o in out) if isinstance(out, tuple) else out[0]


# ---------------------------------------------------------------------------
# public entries (transposed order), same names and argument order as the
# Pallas module


def unpack(packed, width, dtype):
    """BitPacking::unpack over a batch: (B, plen) -> (B, 1024)."""
    return _run("unpack", unpack_plain, packed, None, width, dtype)


def unfor_pack(packed, reference, width, dtype):
    """FoR::unfor_pack: unpack + wrapping add of the reference, one scalar
    or one per block ((B,) or (B, 1), on the payload's device)."""
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
    """FoR::for_pack: wrapping subtract of the reference (one scalar or one
    per block, as in `unfor_pack`), then pack."""
    return _run("for_pack", for_pack_plain, values, reference, width, dtype)


def pack_map(fn, values, width, dtype):
    """Fused-encode entry with a Python producer applied per row slice (see
    ops.bitpack.pack_map): plain PyTorch on every device."""
    return ops_bitpack.pack_map(fn, values, width, dtype)


# -- original-order entries, one kernel each. FLT delta/zdelta/rle chunks
#    store transposed blocks; the decode entries return ORIGINAL order and
#    the encode entry takes it.


def unpack_orig(packed, width, dtype):
    """unpack straight to original order (macros.rs:101-174 composed with
    transpose.rs:18-22)."""
    return _run("unpack_orig", unpack_orig_plain, packed, None, width, dtype)


def undelta_pack_orig(packed, base, width, dtype):
    """Delta decode to original order (delta.rs:48-63 composed with
    transpose.rs:18-22): the sorted-column file-read path."""
    return _run("undelta_pack_orig", undelta_pack_orig_plain, packed, base, width, dtype)


def unzdelta_pack_orig(packed, base, width, dtype):
    """zdelta decode to original order."""
    return _run("unzdelta_pack_orig", unzdelta_pack_orig_plain, packed, base, width, dtype)


def delta_pack_orig(values, width, dtype, *, zigzag=False):
    """ENCODE dual: ORIGINAL-order values -> (packed, base) for the
    delta/zdelta wire format. base = row 0 of each transposed block,
    (B, LANES); the deltas are taken against it (so delta row 0 is zero),
    zigzagged if asked, and packed. W=0 has no packed words, but the kernel
    still runs to produce the base. The returned base owns its memory."""
    return _run("delta_pack_orig", delta_pack_orig_plain, values, None, width, dtype,
                zigzag=zigzag)


def warmup(ops=("pack", "unpack"), dtypes=layout.DTYPES, widths=None, n_blocks=1024,
           device=None):
    """Make each requested (op, dtype, width) ready ahead of first use, the
    serving cold-start mitigation, and return how many were driven. `ops`
    are kernel names (any of the eleven), `widths=None` means 1..T of each
    dtype. On a CUDA device (None = the GPU; raises without one) this loads
    the kernel library and launches every entry once through its public
    wrapper on zero tensors of `n_blocks` blocks with a zero base or
    reference, then synchronises; `device="cpu"` runs the plain versions."""
    unknown = [op for op in ops if op not in _KERNELS]
    if unknown:
        raise ValueError(f"unknown op {unknown[0]!r}; have {sorted(_KERNELS)}")
    device = eng.resolve_device(device)
    if device.type == "cuda":
        build.load()
    count = 0
    for dt in dtypes:
        dt = layout.canon_dtype(dt)
        values = torch.zeros((n_blocks, layout.BLOCK), dtype=eng.torch_dtype(dt),
                             device=device)
        base = torch.zeros(layout.lanes(dt), dtype=values.dtype, device=device)
        for w in widths if widths is not None else range(1, layout.bit_width(dt) + 1):
            layout.check_width(dt, w)
            packed = torch.zeros((n_blocks, layout.packed_len(dt, w)), dtype=values.dtype,
                                 device=device)
            for op in ops:
                fn = globals()[op]  # the public wrapper of that kernel
                src = values if _KERNELS[op][0] == "fl_encode" else packed
                if op in ("pack", "unpack", "unpack_orig", "delta_pack_orig"):
                    fn(src, w, dt)
                elif op in ("for_pack", "unfor_pack"):
                    fn(src, 0, w, dt)
                else:
                    fn(src, base, w, dt)
                count += 1
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return count
