"""Build and load the CUDA kernel library.

`csrc/codecs.cu` is compiled with nvcc for sm_90a into
`fastlanes_tpu_torch/build/libfastlanes_cuda.so` at first use and loaded with
ctypes. The library has a plain C interface and includes no PyTorch header,
so the build takes seconds. It is rebuilt when the source's hash changes.
A failed build raises; nothing falls back to another path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCES = (os.path.join(_PKG, "csrc", "codecs.cu"),)
BUILD_DIR = os.path.join(_PKG, "build")
LIB_NAME = "libfastlanes_cuda.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_lib = None
#: seconds the last nvcc run of this process took (None: loaded from cache)
last_build_seconds = None
#: what ptxas said in that run: registers, shared memory and spills per kernel
last_build_log = None


def find_nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    if os.path.isfile("/usr/local/cuda/bin/nvcc"):
        return "/usr/local/cuda/bin/nvcc"
    raise RuntimeError("nvcc not found: the CUDA kernels of fastlanes_tpu_torch "
                       "are built from source with the CUDA toolkit")


def source_hash() -> str:
    h = hashlib.sha256()
    for path in SOURCES:
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()


def build(force: bool = False) -> str:
    """Compile the library if it is missing or stale; returns its path."""
    global last_build_seconds, last_build_log
    lib_path = os.path.join(BUILD_DIR, LIB_NAME)
    stamp_path = lib_path + ".sha256"
    want = source_hash()
    if not force and os.path.isfile(lib_path) and os.path.isfile(stamp_path):
        with open(stamp_path) as f:
            if f.read().strip() == want:
                return lib_path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp_path = f"{lib_path}.{os.getpid()}.tmp"
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp_path, *SOURCES]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        if os.path.exists(tmp_path):
            os.remove(tmp_path)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
    last_build_seconds = time.perf_counter() - t0
    last_build_log = proc.stderr
    os.replace(tmp_path, lib_path)
    with open(stamp_path, "w") as f:
        f.write(want)
    return lib_path


def load():
    """The loaded library (built on first call), with argtypes set: every
    pointer and the stream are c_void_p, or ctypes would pass them as 32-bit
    ints and cut them."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for entry in (lib.fl_decode, lib.fl_encode):
                # (op, order, tbits, src, out, base, base_stride, ref,
                #  ref_stride, reference, n_blocks, width, stream)
                entry.argtypes = [
                    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_ulonglong,
                    ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
                entry.restype = ctypes.c_int
            lib.fl_error_string.argtypes = [ctypes.c_int]
            lib.fl_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib
