"""ctypes loader for the C++ host codec (built with g++ at first use).

The host half of the port: FLT writers and readers (fio.py) encode and
decode on the CPU through it while the GPU runs the CUDA kernels, and tests
hold it against the NumPy oracle, an independent implementation. The source
is the port's own copy of the JAX package's host codec, so the bytes are
that codec's.

The library is built into `fastlanes_tpu_torch/build/native-<key>/`, where
the key hashes the source, the compiler flags and what `-march=native`
means to this machine's g++. The build compiles PARTS parts in parallel,
each with the unrolled bodies of the widths W with W % PARTS == its number
(fastlanes_native.cpp, "Build"); a call with width W goes to part W % PARTS.
Processes that build at once take a file lock: one compiles into a
temporary directory and renames it into place, the others wait and load
what it built, so no process loads a part of an unfinished library.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time

import numpy as np

from ..core import layout

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "fastlanes_native.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "build")
PARTS = 8
#: -O2, not the JAX package's -O3 -funroll-loops: at -O3 g++ spends many
#: minutes on the unrolled u64 widths. The dynamic cost model lets -O2
#: vectorize the loops that need a runtime alias check (delta), which its
#: default model leaves scalar
CXX_FLAGS = ("-O2", "-fvect-cost-model=dynamic", "-march=native", "-std=c++17", "-shared",
             "-fPIC")

_DTYPE_CODE = {"u8": 0, "u16": 1, "u32": 2, "u64": 3}

_lock = threading.Lock()
_libs = None
#: seconds the last g++ build of this process took (None: loaded as built)
last_build_seconds = None


class NativeUnavailable(RuntimeError):
    pass


def _gxx(*args) -> str:
    try:
        proc = subprocess.run(["g++", *args], capture_output=True, text=True)
    except FileNotFoundError as e:
        raise NativeUnavailable(f"failed to build native codec: {e}") from e
    if proc.returncode != 0:
        raise NativeUnavailable(f"failed to build native codec: {proc.stderr}")
    return proc.stdout


def library_dir() -> str:
    """Where the built parts of this source live on this machine."""
    h = hashlib.sha256()
    with open(_SRC, "rb") as f:
        h.update(f.read())
    h.update(" ".join(CXX_FLAGS).encode() + b"|%d|" % PARTS)
    # -march=native differs between machines: a library built for another
    # CPU (a copied checkout) is never loaded
    h.update(_gxx("-march=native", "-Q", "--help=target").encode())
    h.update(_gxx("--version").encode())
    return os.path.join(BUILD_DIR, "native-" + h.hexdigest()[:20])


def _part_path(lib_dir: str, part: int) -> str:
    return os.path.join(lib_dir, f"libfastlanes_native_{part}.so")


def _compile(lib_dir: str) -> None:
    """All parts at once into a temporary directory, renamed into place."""
    global last_build_seconds
    tmp = f"{lib_dir}.{os.getpid()}.tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        ["g++", *CXX_FLAGS, f"-DFL_PARTS={PARTS}", f"-DFL_PART={part}", "-o",
         _part_path(tmp, part), _SRC], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for part in range(PARTS)]
    errors = [err for proc in procs for _out, err in [proc.communicate()] if proc.returncode]
    if errors:
        shutil.rmtree(tmp, ignore_errors=True)
        raise NativeUnavailable(f"failed to build native codec: {errors[0]}")
    if os.path.isdir(lib_dir):  # a forced rebuild: the old parts go once the new are in
        old = f"{lib_dir}.{os.getpid()}.old"
        os.replace(lib_dir, old)
        os.replace(tmp, lib_dir)
        shutil.rmtree(old, ignore_errors=True)
    else:
        os.replace(tmp, lib_dir)
    last_build_seconds = time.perf_counter() - t0


def build(force: bool = False) -> str:
    """Compile the library if it is missing, or always with `force` (under
    the same file lock); returns the directory of its parts."""
    try:
        lib_dir = library_dir()
        os.makedirs(BUILD_DIR, exist_ok=True)
        if os.path.isdir(lib_dir) and not force:
            return lib_dir
        with open(os.path.join(BUILD_DIR, "native.lock"), "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if force or not os.path.isdir(lib_dir):
                _compile(lib_dir)
        return lib_dir
    except OSError as e:
        raise NativeUnavailable(f"failed to build native codec: {e}") from e


def _bind(path: str):
    lib = ctypes.CDLL(path)
    c = ctypes.c_void_p
    lib.fl_pack.argtypes = [ctypes.c_int, ctypes.c_int, c, c, ctypes.c_long]
    lib.fl_unpack.argtypes = [ctypes.c_int, ctypes.c_int, c, c, ctypes.c_long]
    lib.fl_for_pack.argtypes = [ctypes.c_int, ctypes.c_int, c, ctypes.c_ulonglong, c,
                                ctypes.c_long]
    lib.fl_unfor_pack.argtypes = [ctypes.c_int, ctypes.c_int, c, ctypes.c_ulonglong, c,
                                  ctypes.c_long]
    lib.fl_delta.argtypes = [ctypes.c_int, c, c, c, ctypes.c_long]
    lib.fl_undelta.argtypes = [ctypes.c_int, c, c, c, ctypes.c_long]
    lib.fl_delta_pack.argtypes = [ctypes.c_int, ctypes.c_int, c, c, c, ctypes.c_long]
    lib.fl_undelta_pack.argtypes = [ctypes.c_int, ctypes.c_int, c, c, c, ctypes.c_long]
    lib.fl_transpose.argtypes = [ctypes.c_int, c, c, ctypes.c_long]
    lib.fl_untranspose.argtypes = [ctypes.c_int, c, c, ctypes.c_long]
    lib.fl_unpack_single.argtypes = [ctypes.c_int, ctypes.c_int, c, c, ctypes.c_long, c,
                                     ctypes.c_long]
    for fn in ("fl_pack", "fl_unpack", "fl_for_pack", "fl_unfor_pack", "fl_delta",
               "fl_undelta", "fl_delta_pack", "fl_undelta_pack", "fl_transpose",
               "fl_untranspose", "fl_unpack_single"):
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def _load() -> list:
    """The PARTS loaded parts (built on first use)."""
    global _libs
    with _lock:
        if _libs is None:
            lib_dir = build()
            _libs = [_bind(_part_path(lib_dir, part)) for part in range(PARTS)]
        return _libs


def _of_width(width: int):
    return _load()[int(width) % PARTS]


def available() -> bool:
    """True when the library builds and loads on this machine."""
    try:
        _load()
        return True
    except (NativeUnavailable, OSError):
        return False


def _prep(arr, dtype, last_dim):
    dt = layout.np_dtype(dtype)
    a = np.ascontiguousarray(arr, dtype=dt)
    if a.ndim == 1:
        a = a[None]
    if a.ndim != 2 or a.shape[1] != last_dim:
        raise ValueError(f"expected shape (B, {last_dim}), got {a.shape}")
    return a


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def _check(rc):
    if rc != 0:
        raise ValueError(f"native codec error {rc} (bad width or dtype)")


def aligned_empty(shape, np_dt, align=64):
    """np.empty whose data pointer is `align`-byte aligned: the library's
    non-temporal streaming-store decode needs it (full cache-line stores, no
    read for ownership)."""
    np_dt = np.dtype(np_dt)
    nbytes = int(np.prod(shape)) * np_dt.itemsize
    raw = np.empty(nbytes + align, np.uint8)
    off = (-raw.ctypes.data) % align
    return raw[off:off + nbytes].view(np_dt).reshape(shape)


def _out_buf(out, shape, dtype):
    """The caller's preallocated output when given (IO pipelines reuse
    buffers: a fresh np.empty per call page-faults its whole extent), else a
    64-byte-aligned new one, so large decodes take the non-temporal path."""
    np_dt = layout.np_dtype(dtype)
    if out is None:
        return aligned_empty(shape, np_dt)
    if (not isinstance(out, np.ndarray) or out.dtype != np_dt
            or out.shape != shape or not out.flags.c_contiguous):
        raise ValueError(f"out must be a C-contiguous {np_dt} array of shape {shape}")
    return out


def pack(values, width, dtype, out=None):
    dtype = layout.canon_dtype(dtype)
    lib = _of_width(width)
    v = _prep(values, dtype, layout.BLOCK)
    out = _out_buf(out, (v.shape[0], layout.packed_len(dtype, width)), dtype)
    _check(lib.fl_pack(_DTYPE_CODE[dtype], width, _ptr(v), _ptr(out), v.shape[0]))
    return out


def unpack(packed, width, dtype, out=None):
    dtype = layout.canon_dtype(dtype)
    lib = _of_width(width)
    p = _prep(packed, dtype, layout.packed_len(dtype, width))
    out = _out_buf(out, (p.shape[0], layout.BLOCK), dtype)
    _check(lib.fl_unpack(_DTYPE_CODE[dtype], width, _ptr(p), _ptr(out), p.shape[0]))
    return out


def for_pack(values, reference, width, dtype):
    dtype = layout.canon_dtype(dtype)
    lib = _of_width(width)
    v = _prep(values, dtype, layout.BLOCK)
    out = np.empty((v.shape[0], layout.packed_len(dtype, width)), layout.np_dtype(dtype))
    _check(lib.fl_for_pack(_DTYPE_CODE[dtype], width, _ptr(v), int(reference), _ptr(out),
                           v.shape[0]))
    return out


def unfor_pack(packed, reference, width, dtype):
    dtype = layout.canon_dtype(dtype)
    lib = _of_width(width)
    p = _prep(packed, dtype, layout.packed_len(dtype, width))
    out = aligned_empty((p.shape[0], layout.BLOCK), layout.np_dtype(dtype))
    _check(lib.fl_unfor_pack(_DTYPE_CODE[dtype], width, _ptr(p), int(reference), _ptr(out),
                             p.shape[0]))
    return out


def _prep_base(base, dtype, n_blocks):
    nl = layout.lanes(dtype)
    b = np.ascontiguousarray(base, dtype=layout.np_dtype(dtype))
    if b.ndim == 1:
        b = np.ascontiguousarray(np.broadcast_to(b[None], (n_blocks, nl)))
    if b.shape != (n_blocks, nl):
        raise ValueError(f"base must be ({n_blocks}, {nl}), got {b.shape}")
    return b


def delta(values, base, dtype):
    dtype = layout.canon_dtype(dtype)
    lib = _of_width(0)
    v = _prep(values, dtype, layout.BLOCK)
    bs = _prep_base(base, dtype, v.shape[0])
    out = np.empty_like(v)
    _check(lib.fl_delta(_DTYPE_CODE[dtype], _ptr(v), _ptr(bs), _ptr(out), v.shape[0]))
    return out


def undelta(values, base, dtype):
    dtype = layout.canon_dtype(dtype)
    lib = _of_width(0)
    v = _prep(values, dtype, layout.BLOCK)
    bs = _prep_base(base, dtype, v.shape[0])
    out = np.empty_like(v)
    _check(lib.fl_undelta(_DTYPE_CODE[dtype], _ptr(v), _ptr(bs), _ptr(out), v.shape[0]))
    return out


def delta_pack(values, base, width, dtype):
    dtype = layout.canon_dtype(dtype)
    lib = _of_width(width)
    v = _prep(values, dtype, layout.BLOCK)
    bs = _prep_base(base, dtype, v.shape[0])
    out = np.empty((v.shape[0], layout.packed_len(dtype, width)), layout.np_dtype(dtype))
    _check(lib.fl_delta_pack(_DTYPE_CODE[dtype], width, _ptr(v), _ptr(bs), _ptr(out),
                             v.shape[0]))
    return out


def undelta_pack(packed, base, width, dtype, out=None):
    dtype = layout.canon_dtype(dtype)
    lib = _of_width(width)
    p = _prep(packed, dtype, layout.packed_len(dtype, width))
    bs = _prep_base(base, dtype, p.shape[0])
    out = _out_buf(out, (p.shape[0], layout.BLOCK), dtype)
    _check(lib.fl_undelta_pack(_DTYPE_CODE[dtype], width, _ptr(p), _ptr(bs), _ptr(out),
                               p.shape[0]))
    return out


def transpose(values, dtype):
    dtype = layout.canon_dtype(dtype)
    lib = _of_width(0)
    v = _prep(values, dtype, layout.BLOCK)
    out = np.empty_like(v)
    _check(lib.fl_transpose(_DTYPE_CODE[dtype], _ptr(v), _ptr(out), v.shape[0]))
    return out


def untranspose(values, dtype):
    dtype = layout.canon_dtype(dtype)
    lib = _of_width(0)
    v = _prep(values, dtype, layout.BLOCK)
    out = np.empty_like(v)
    _check(lib.fl_untranspose(_DTYPE_CODE[dtype], _ptr(v), _ptr(out), v.shape[0]))
    return out


def unpack_single(packed, width, index, dtype):
    dtype = layout.canon_dtype(dtype)
    lib = _of_width(width)
    p = _prep(packed, dtype, layout.packed_len(dtype, width))
    idx = np.ascontiguousarray(np.atleast_1d(index), dtype=np.int64)
    if idx.size and (idx.min() < 0 or idx.max() >= layout.BLOCK):
        # the C side indexes raw buffers: a bad index would read out of bounds
        raise IndexError(f"element index out of range [0, {layout.BLOCK})")
    out = np.empty((p.shape[0], idx.shape[0]), layout.np_dtype(dtype))
    _check(lib.fl_unpack_single(_DTYPE_CODE[dtype], width, _ptr(p), _ptr(idx), idx.shape[0],
                                _ptr(out), p.shape[0]))
    return out
