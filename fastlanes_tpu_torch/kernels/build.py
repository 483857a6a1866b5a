"""Build and load the CUDA kernel library.

`csrc/codecs.cu` (the codec kernels) and `csrc/group_acc.cu` (the GROUP BY
accumulator's kernel) are compiled with nvcc for sm_90a into
`fastlanes_tpu_torch/build/libfastlanes_cuda.so` at first use and loaded with
ctypes. The library has a plain C interface and includes no PyTorch header,
so the build takes seconds. It is rebuilt when the sources' hash changes.
A failed build raises; nothing falls back to another path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCES = (os.path.join(_PKG, "csrc", "codecs.cu"), os.path.join(_PKG, "csrc", "group_acc.cu"))
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


def compile_library(sources, lib_path: str):
    """nvcc `sources` into the shared library `lib_path`; returns (seconds,
    what ptxas said). A failed build raises."""
    os.makedirs(os.path.dirname(lib_path), exist_ok=True)
    tmp_path = f"{lib_path}.{os.getpid()}.tmp"
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp_path, *sources]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        if os.path.exists(tmp_path):
            os.remove(tmp_path)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
    seconds = time.perf_counter() - t0
    os.replace(tmp_path, lib_path)
    return seconds, proc.stderr


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
    last_build_seconds, last_build_log = compile_library(SOURCES, lib_path)
    with open(stamp_path, "w") as f:
        f.write(want)
    return lib_path


def bind(lib_path: str):
    """ctypes handle of a built library with argtypes set: every pointer and
    the stream are c_void_p, or ctypes would pass them as 32-bit ints and
    cut them."""
    lib = ctypes.CDLL(lib_path)
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
    return lib


def load():
    """The loaded library (built on first call), bound as `bind` says."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = bind(build())
        return _lib


#: the C++ mangling of the kernels' element types
_MANGLED_DTYPE = {"h": "u8", "t": "u16", "j": "u32", "m": "u64", "y": "u64"}


def ptxas_usage(log: str) -> dict:
    """What `-Xptxas -v` reports per kernel instantiation, from a build log:
    {"decode_kernel<u8,0,1>": {"registers": n, "smem_bytes": n,
    "spill_store_bytes": n, "spill_load_bytes": n}}, the template's integer
    arguments in order."""
    usage, name = {}, None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '([^']+)'", line)
        if entry:
            kernel = re.search(r"\d+([a-z_]+_kernel)I(\w)((?:Li\d+E)*)E", entry.group(1))
            name = entry.group(1) if kernel is None else "%s<%s>" % (
                kernel.group(1), ",".join([_MANGLED_DTYPE.get(kernel.group(2), kernel.group(2))]
                                          + re.findall(r"Li(\d+)E", kernel.group(3))))
            usage[name] = {}
            continue
        if name is None:
            continue
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if spill:
            usage[name].update(spill_store_bytes=int(spill.group(1)),
                               spill_load_bytes=int(spill.group(2)))
        regs = re.search(r"Used (\d+) registers", line)
        if regs:
            usage[name]["registers"] = int(regs.group(1))
        smem = re.search(r"(\d+) bytes smem", line)
        if smem:
            usage[name]["smem_bytes"] = int(smem.group(1))
    return usage
