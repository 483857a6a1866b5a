"""What the program's own spans say of a traced run: the ranges `fl.<stage>`
and `fl.<entry>` that fastlanes_tpu_torch opens around the host stages of a
call and around each public entry (fastlanes_tpu_torch/utils/trace.py),
which `trace.collect` keeps among the host operators (`Trace.ops`).

A span's self time is its length less the union of the `fl.` spans inside
it. Spans of one thread nest, so the spans inside a span are those of its
children's subtrees. Only the spans inside the window count."""

from __future__ import annotations

PREFIX = "fl."
#: the program's stage spans; every other `fl.` span is the root span of a
#: public entry, named after it
STAGES = frozenset({"header", "dict", "zonemap", "window", "read", "decode", "h2d",
                    "mask", "acc", "fetch", "combine"})


def in_window(trace) -> list:
    """The `fl.` spans that lie inside the window, as (name without the
    prefix, start_s, end_s)."""
    lo, hi = trace.window
    return [(n[len(PREFIX):], a, b) for n, a, b in trace.ops
            if n.startswith(PREFIX) and lo <= a and b <= hi]


def self_times(spans) -> list:
    """The self time of each of `spans` ((name, start, end)), in their
    order: its length less the union of its children, the spans it holds
    directly."""
    order = sorted(range(len(spans)), key=lambda i: (spans[i][1], -spans[i][2]))
    children = [[] for _ in spans]
    stack = []
    for i in order:
        while stack and spans[i][2] > spans[stack[-1]][2]:
            stack.pop()
        if stack:
            children[stack[-1]].append(i)
        stack.append(i)
    out = []
    for (_n, a, b), kids in zip(spans, children):
        covered, end = 0.0, a
        for k in kids:  # in order of start
            ka, kb = max(spans[k][1], end), min(spans[k][2], b)
            if kb > ka:
                covered += kb - ka
                end = kb
        out.append((b - a) - covered)
    return out


def _spans(record):
    """The window's `fl.` spans, or None where the run has no trace, no call
    or no such span (a program without spans)."""
    if record.trace is None or not record.calls:
        return None
    return in_window(record.trace) or None


def self_ms_per_call(record, keep) -> float:
    """Summed self time of the window's `fl.` spans whose name `keep`
    accepts, in milliseconds a call; None as `_spans`."""
    spans = _spans(record)
    if spans is None:
        return None
    total = sum(t for (n, _a, _b), t in zip(spans, self_times(spans)) if keep(n))
    return total / record.calls * 1e3


def self_ms_by_name(trace) -> dict:
    """Summed self time in milliseconds of the window's `fl.` spans, by name
    without the prefix."""
    spans = in_window(trace)
    out = {}
    for (n, _a, _b), t in zip(spans, self_times(spans)):
        out[n] = out.get(n, 0.0) + t * 1e3
    return out


def count_per_call(record, name: str) -> float:
    """Spans `fl.<name>` in the window a call; None as `_spans`."""
    spans = _spans(record)
    if spans is None:
        return None
    return sum(n == name for n, _a, _b in spans) / record.calls
