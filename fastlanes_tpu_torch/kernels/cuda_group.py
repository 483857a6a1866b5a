"""CUDA kernel for the GROUP BY accumulator's feed (`analytics._GroupAcc`).

One launch adds one lockstep window into the per-group state: it reads the
key, value and mask once where they lie, turns each row into its group,
counts, sums (or float superaccumulator bins) and extremes in registers,
sums the rows of a warp that add at the same addresses, and adds them with
one atomic per address. Where the whole accumulator fits in the shared
memory one block may take (`fits_shared`), each block keeps a private copy
there and adds it into the device accumulator once (SHARED mode, one copy);
otherwise warps add straight into the accumulator's spread copies (GLOBAL
mode). The kernel is in csrc/group_acc.cu, built into the same library as
the codec kernels (kernels/build.py). It replaces no TPU kernel: the JAX
package's group accumulation is plain XLA scatters.

The plain version is `analytics._GroupAcc.feed_plain`, which a CPU
accumulator takes. For CUDA tensors `feed` launches the kernel or raises.
`LAUNCHES` counts the launches and `SHARED_LAUNCHES` those in SHARED mode;
neither is part of `cuda_codecs.LAUNCHES`.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from . import build

#: kernel launches (plain integers; reset by assigning 0)
LAUNCHES = 0
#: the launches that kept the accumulator in shared memory
SHARED_LAUNCHES = 0

#: value kind -> (code of csrc/group_acc.cu, int64 columns a slot, value dtypes)
KINDS = {
    "int": (0, 2, (torch.int8, torch.int16, torch.int32)),
    "i64": (1, 3, (torch.int64,)),
    "f32": (2, 4 + 2 * 32, (torch.int32,)),
    "f64": (3, 4 + 2 * 256 * 2, (torch.int64,)),
}
_KEY_DTYPES = (torch.int8, torch.int16, torch.int32)

_lock = threading.Lock()
_lib = None
_shared_bytes = {}  # device index -> the card's opt-in shared memory a block


def _load():
    """The kernel library with this module's entries bound (every pointer
    and the stream as c_void_p, so ctypes does not cut them to 32 bits)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = build.load()
            p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            # (kind, key_bytes, value_bytes, key, key_offset, value, mask,
            #  valid, k, add, mn, mx, spread, shared, stream)
            lib.fl_group_acc.argtypes = [i, i, i, p, ll, p, p, ll, i, p, p, p, i, i, p]
            lib.fl_group_acc.restype = i
            lib.fl_group_shared_bytes.argtypes = [i, ctypes.POINTER(i)]
            lib.fl_group_shared_bytes.restype = i
            _lib = lib
        return _lib


def shared_bytes(device) -> int:
    """The dynamic shared memory one block may take on the CUDA `device`:
    the card's opt-in limit (cudaDevAttrMaxSharedMemoryPerBlockOptin)."""
    index = torch.device(device).index
    if index is None:
        index = torch.cuda.current_device()
    if index not in _shared_bytes:
        lib = _load()
        got = ctypes.c_int(0)
        err = lib.fl_group_shared_bytes(index, ctypes.byref(got))
        if err != 0:
            raise RuntimeError(f"reading the shared memory of cuda:{index} failed: "
                               f"{lib.fl_error_string(err).decode()} ({err})")
        _shared_bytes[index] = got.value
    return _shared_bytes[index]


def fits_shared(k: int, n_cols: int, smem_bytes: int) -> bool:
    """Whether an accumulator of k groups and a trash slot, `n_cols` int64
    sums and a min and a max a slot, fits in `smem_bytes` of shared memory:
    the rule for SHARED mode."""
    return (k + 1) * (n_cols + 2) * 8 <= smem_bytes


def _check(name, t, dtypes, device, n):
    if not isinstance(t, torch.Tensor) or t.device != device:
        raise ValueError(f"group accumulator: {name} must be a tensor on {device}")
    if t.dtype not in dtypes:
        raise ValueError(f"group accumulator: {name} has dtype {t.dtype}, "
                         f"not one of {[str(d) for d in dtypes]}")
    if not t.is_contiguous():
        raise ValueError(f"group accumulator: {name} must be contiguous")
    if t.numel() < n:
        raise ValueError(f"group accumulator: {name} holds {t.numel()} elements, "
                         f"fewer than {n}")


def feed(key, key_offset: int, value, kind: str, valid: int, mask, k: int,
         add, mn, mx, spread: int, shared: bool) -> None:
    """Add the first `valid` rows into the accumulator (add, mn, mx) of
    `analytics._GroupAcc`: group = key + key_offset (a negative group
    indexes from the end), rows outside [0, k) or with a False `mask` into
    the trash slot k; `value` the flat value keys of `kind` ("int", "i64",
    "f32" or "f64" bits). add is (spread, k + 1, n_cols) int64, mn and mx
    (spread, k + 1), all flat. `shared` takes SHARED mode (spread 1, the
    accumulator within `fits_shared`). Launches on the current stream and
    does not synchronise; raises if the launch fails."""
    global LAUNCHES, SHARED_LAUNCHES
    code, n_cols, value_dtypes = KINDS[kind]
    device = add.device
    if device.type != "cuda":
        raise ValueError("group accumulator: the kernel takes CUDA tensors; a CPU "
                         "accumulator takes analytics._GroupAcc.feed_plain")
    if not 0 <= k < (1 << 31) - 1 or spread < 1 or (shared and spread != 1):
        raise ValueError(f"group accumulator: k={k}, spread={spread}, shared={shared}")
    slots = spread * (k + 1)
    _check("key", key, _KEY_DTYPES, device, valid)
    _check("value", value, value_dtypes, device, valid)
    if mask is not None:
        _check("mask", mask, (torch.bool,), device, valid)
    for name, t, n in (("add", add, slots * n_cols), ("mn", mn, slots), ("mx", mx, slots)):
        _check(name, t, (torch.int64,), device, n)
        if t.numel() != n:
            raise ValueError(f"group accumulator: {name} holds {t.numel()} elements, not {n}")
    if valid <= 0:
        return
    lib = _load()
    if shared and not fits_shared(k, n_cols, shared_bytes(device)):
        raise ValueError(f"group accumulator: {k} groups of {kind} do not fit in a "
                         "block's shared memory")
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.fl_group_acc(
            code, key.element_size(), value.element_size(), key.data_ptr(), key_offset,
            value.data_ptr(), None if mask is None else mask.data_ptr(), valid, k,
            add.data_ptr(), mn.data_ptr(), mx.data_ptr(), spread, int(shared), stream or None)
    if err != 0:
        raise RuntimeError(
            f"CUDA launch of the group accumulator ({kind}, k={k}, {valid} rows, "
            f"{'shared' if shared else 'global'}) failed: "
            f"{lib.fl_error_string(err).decode()} ({err})")
    LAUNCHES += 1
    if shared:
        SHARED_LAUNCHES += 1
