"""Benchmark timing helpers: wall time with the device synchronised.

The port of fastlanes_tpu/utils/timing.py: where the JAX package waits on
`jax.block_until_ready`, this waits with `torch.cuda.synchronize()` when the
result holds a CUDA tensor (CPU results are ready when returned)."""

from __future__ import annotations

import time

import numpy as np
import torch


def _tensors(out):
    if isinstance(out, torch.Tensor):
        yield out
    elif isinstance(out, (tuple, list)):
        for item in out:
            yield from _tensors(item)
    elif isinstance(out, dict):
        for item in out.values():
            yield from _tensors(item)


def _block_until_ready(out) -> None:
    """Wait until every CUDA tensor in `out` (a tensor, or tuples, lists and
    dicts of them) is computed."""
    if any(t.is_cuda for t in _tensors(out)):
        torch.cuda.synchronize()


def median_time(fn, *args, warmup: int = 3, iters: int = 10) -> float:
    """Median wall time of fn(*args) with device sync per iteration."""
    out = None
    for _ in range(warmup):
        out = fn(*args)
    _block_until_ready(out)
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        out = fn(*args)
        _block_until_ready(out)
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def throughput_ints(fn, n_ints: int, *args, **kw) -> float:
    """Integers/second of a codec call over n_ints total values."""
    return n_ints / median_time(fn, *args, **kw)
