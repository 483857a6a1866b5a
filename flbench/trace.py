"""What a `--trace 1` run keeps of the profiler: the device's operations, the
benchmark's own spans around each call, and the host operators (to name
what the host was doing while the device sat idle); and the breakdown that
goes into the result line."""

from __future__ import annotations

from dataclasses import dataclass, field

#: the benchmark's span around each call: SPAN + the call's label
SPAN = "flbench.call "


@dataclass
class Trace:
    #: (name, kind, start_s, end_s); kind: kernel, memcpy_htod, memcpy_dtoh,
    #: memcpy, memset
    device: list = field(default_factory=list)
    #: the benchmark's spans: (label, start_s, end_s)
    spans: list = field(default_factory=list)
    #: host operators: (name, start_s, end_s)
    ops: list = field(default_factory=list)

    @property
    def window(self) -> tuple:
        """From the first span's start to the last span's end."""
        return (min(s[1] for s in self.spans), max(s[2] for s in self.spans)) \
            if self.spans else (0.0, 0.0)

    def busy(self) -> list:
        """The union of the device's activity inside the window, as sorted
        disjoint intervals."""
        lo, hi = self.window
        merged = []
        for _n, _k, a, b in sorted(self.device, key=lambda d: d[2]):
            a, b = max(a, lo), min(b, hi)
            if b <= a:
                continue
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return merged

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy())

    def seconds_of(self, kind: str, contains: tuple = ()) -> float:
        """Summed device time of one kind of operation, of names holding any
        of `contains` (all names where it is empty)."""
        return sum(b - a for n, k, a, b in self.device
                   if k == kind and (not contains or any(c in n for c in contains)))


def _kind(name: str) -> str:
    if name.startswith("Memset"):
        return "memset"
    if name.startswith("Memcpy"):
        return "memcpy_htod" if "HtoD" in name else "memcpy_dtoh" if "DtoH" in name else "memcpy"
    return "kernel"


def collect(prof) -> Trace:
    """The Trace of a finished `torch.profiler.profile`, from its raw events:
    on the device its kernels, copies and memsets (the device's copy of the
    benchmark's spans left out), on the host the spans and the operators."""
    from torch.autograd import DeviceType

    out = Trace()
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        a, b = e.start_ns() * 1e-9, e.end_ns() * 1e-9
        if e.device_type() == DeviceType.CUDA:
            if not name.startswith(SPAN):
                out.device.append((name, _kind(name), a, b))
        elif name.startswith(SPAN):
            out.spans.append((name[len(SPAN):], a, b))
        else:
            out.ops.append((name, a, b))
    return out


def short(name: str, limit: int = 120) -> str:
    """A kernel's name without its return type and argument list."""
    name = name[5:] if name.startswith("void ") else name
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i] if i else name
                break
    return name[:limit]


def _around(intervals, t: float):
    """The shortest (innermost) interval holding time t, or None."""
    best = None
    for name, a, b in intervals:
        if a <= t <= b and (best is None or b - a < best[2] - best[1]):
            best = (name, a, b)
    return best


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle gaps
    of the window named by the call and the host operator around them."""
    by_name = {}
    for n, k, a, b in trace.device:
        key = short(n) if k == "kernel" else n
        by_name[key] = by_name.get(key, 0.0) + (b - a)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]

    lo, hi = trace.window
    edges = [lo] + [x for iv in trace.busy() for x in iv] + [hi]
    gaps = sorted(((edges[i + 1] - edges[i], edges[i]) for i in range(0, len(edges) - 1, 2)
                   if edges[i + 1] > edges[i]), reverse=True)[:top]
    named = []
    for length, start in gaps:
        mid = start + length / 2
        span = _around(trace.spans, mid)
        op = _around(trace.ops, mid)
        named.append(["%s | %s" % (span[0] if span else "between calls",
                                   op[0] if op else "python"), length])
    return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": named}
