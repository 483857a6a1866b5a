"""Spans of the host work of a query, on the profiler's clock.

Each stage of a read or a query (header parse, dictionary load, zone maps,
one lockstep window, file read, decode, staging copy to the device, masks,
accumulators, the wait of a fetch, a mesh's collective) opens a span named
`fl.<stage>`, and each public entry a root span `fl.<entry>` around them.
A span records exactly when a `torch.profiler.profile` is running, whoever
started it, so its ranges land in that profiler's trace beside the kernels
and copies they launch:

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        analytics.group_stats("t.flt", "k", "price")
    prof.export_chrome_trace("trace.json")   # fl.* ranges on the host rows

With no profiler running a span is one check and a shared null context.

A span is a `RecordFunction` of the profiler's function scope
(`torch._C._profiler._RecordFunctionFast`), not of the user scope that
`torch.profiler.record_function` opens: the profiler copies every
user-scope range that launches device work onto the device's timeline,
where it would read as device activity from its first launch to its last.
A span never synchronises, never allocates on the device and never reads a
tensor."""

from __future__ import annotations

import contextlib
import functools

import torch
from torch._C._profiler import _RecordFunctionFast

#: what `span` returns with no profiler running
_OFF = contextlib.nullcontext()


def span(name: str):
    """The context of one pass through the stage `name`: the profiler's
    range `fl.<name>` while a profiler runs, else a shared null context."""
    if torch.autograd._profiler_enabled():
        return _RecordFunctionFast("fl." + name)
    return _OFF


def spanned(name: str):
    """Decorate a function: each call is one span `fl.<name>`."""
    def decorate(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return wrapped

    return decorate


def entry(fn):
    """Decorate a public entry: each call opens the root span
    `fl.<function name>` around the stages it runs, and the call's header
    scope (fio.header_scope: each file's header parsed once a call). The
    signature is kept (functools.wraps)."""
    from ..fio import header_scope  # here: fio imports this module

    name = fn.__name__

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with span(name), header_scope():
            return fn(*args, **kwargs)

    return wrapped
