"""Runtime-width dispatch: the counterpart of the reference's
`unchecked_pack` / `unchecked_unpack` width match tables
(reference src/bitpacking.rs:82-95, 115-128, 186-203).

The reference monomorphizes 4 types x (T+1) widths = 124 kernel variants and
dispatches on the run-time width. The CUDA kernels take the width at run
time, so there is nothing to cache: `get` validates (op, dtype, width) and
returns a closure over the kernel wrapper (the six ops with a kernel: CUDA
tensor -> kernel, CPU tensor -> plain version) or over the plain op (the
rest). The one compile step the port has is the nvcc build of the kernel
library, and that is what `precompile` triggers."""

from __future__ import annotations

from ..core import layout
from ..kernels import build
from ..kernels import cuda_codecs as ck
from . import _engine as eng
from . import delta as delta_mod, single, transpose as transpose_mod

_OPS = {
    "pack": lambda w, dt: lambda values: ck.pack(values, w, dt),
    "unpack": lambda w, dt: lambda packed: ck.unpack(packed, w, dt),
    "undelta_pack": lambda w, dt: lambda packed, base: ck.undelta_pack(packed, base, w, dt),
    "delta_pack": lambda w, dt: lambda values, base: ck.delta_pack(values, base, w, dt),
    "for_pack": lambda w, dt: lambda values, ref: ck.for_pack(values, ref, w, dt),
    "unfor_pack": lambda w, dt: lambda packed, ref: ck.unfor_pack(packed, ref, w, dt),
    "unpack_single": lambda w, dt: lambda packed, idx: single.unpack_single(packed, w, idx, dt),
    "delta": lambda w, dt: lambda values, base: delta_mod.delta(values, base, dt),
    "undelta": lambda w, dt: lambda values, base: delta_mod.undelta(values, base, dt),
    "transpose": lambda w, dt: lambda values: transpose_mod.transpose(values, dt),
    "untranspose": lambda w, dt: lambda values: transpose_mod.untranspose(values, dt),
}


def get(op: str, dtype: str, width: int):
    """The callable for (op, dtype, width), width validated. 'u32' and
    'uint32' name the same dtype."""
    dtype = layout.canon_dtype(dtype)
    layout.check_width(dtype, width)
    if op not in _OPS:
        raise ValueError(f"unknown op {op!r}; have {sorted(_OPS)}")
    return _OPS[op](width, dtype)


def unchecked_pack(width: int, values, dtype):
    """Runtime-width pack (reference bitpacking.rs:76-95; width is validated
    here, unlike the Rust release build's debug_assert)."""
    return get("pack", dtype, width)(values)


def unchecked_unpack(width: int, packed, dtype):
    """Runtime-width unpack (reference bitpacking.rs:109-128)."""
    return get("unpack", dtype, width)(packed)


def unchecked_unpack_single(width: int, packed, index, dtype):
    """Runtime-width unpack_single (reference bitpacking.rs:182-203)."""
    return get("unpack_single", dtype, width)(packed, index)


def precompile(ops=("pack", "unpack"), dtypes=layout.DTYPES, n_blocks=1024,
               device=None):
    """Make every (op, dtype, width) variant ready and return their count:
    the analogue of the reference's 124 monomorphized variants. On a CUDA
    device (None = the GPU; raises without one) that builds and loads the
    kernel library; `device="cpu"` has nothing to compile. `n_blocks` is
    kept for the reference's signature: no variant depends on a shape."""
    if eng.resolve_device(device).type == "cuda":
        build.load()
    count = 0
    for dt in dtypes:
        for w in range(layout.bit_width(dt) + 1):
            for op in ops:
                get(op, dt, w)
                count += 1
    return count
