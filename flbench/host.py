"""What a run reports of the host it ran on, beside its metrics, to tell a
slow host from a slow program: the CPUs it may use and was seen on, the
load, how much of each data file is resident in the page cache, and the time
of a fixed piece of host work (`calibrate`), taken the same way in every
run."""

from __future__ import annotations

import ctypes
import os
import time

_PAGE = os.sysconf("SC_PAGE_SIZE")


def cpu_now():
    """The CPU the calling thread last ran on (/proc/self/stat), or None."""
    try:
        with open("/proc/thread-self/stat") as f:
            return int(f.read().rsplit(")", 1)[1].split()[36])
    except (OSError, IndexError, ValueError):
        return None


def loadavg():
    try:
        with open("/proc/loadavg") as f:
            return [float(x) for x in f.read().split()[:3]]
    except (OSError, ValueError):
        return None


def resident_share(path: str):
    """The share of a file's pages in the page cache (mincore), or None."""
    try:
        libc = ctypes.CDLL(None, use_errno=True)
        libc.mmap.restype = ctypes.c_void_p
        libc.mmap.argtypes = (ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int, ctypes.c_int,
                              ctypes.c_int, ctypes.c_long)
        libc.mincore.argtypes = (ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p)
        libc.munmap.argtypes = (ctypes.c_void_p, ctypes.c_size_t)
        size = os.path.getsize(path)
        if size == 0:
            return None
        fd = os.open(path, os.O_RDONLY)
        try:
            addr = libc.mmap(None, size, 1, 1, fd, 0)  # PROT_READ, MAP_SHARED
        finally:
            os.close(fd)
        if addr in (None, ctypes.c_void_p(-1).value):
            return None
        try:
            pages = (size + _PAGE - 1) // _PAGE
            vec = (ctypes.c_ubyte * pages)()
            if libc.mincore(ctypes.c_void_p(addr), size, vec) != 0:
                return None
            return sum(b & 1 for b in vec) / pages
        finally:
            libc.munmap(ctypes.c_void_p(addr), size)
    except (OSError, AttributeError):
        return None


def calibrate() -> dict:
    """Seconds of two fixed pieces of single-threaded host work, the kinds a
    call's host side does: a Python loop (the CPU alone), and NumPy passes
    that allocate and write 64 MiB (memory and the kernel's page handling)."""
    import numpy as np

    t0 = time.perf_counter()
    acc = 0
    for i in range(2_000_000):
        acc += i & 7
    t1 = time.perf_counter()
    a = np.arange(1 << 23, dtype=np.int64)
    for _ in range(8):
        b = a.copy()
        b += 1
    return {"python_s": t1 - t0, "numpy_s": time.perf_counter() - t1}


def describe(paths) -> dict:
    """The host's state at one moment, with each file's residency."""
    try:
        allowed = sorted(os.sched_getaffinity(0))
    except OSError:
        allowed = None
    return {"cpus_allowed": allowed, "cpu_count": os.cpu_count(), "loadavg": loadavg(),
            "resident": {os.path.basename(p): resident_share(p) for p in paths}}
