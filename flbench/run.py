"""Run one cell of BENCHMARK.json once and print its result as one JSON line.

    python3 -m flbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. Set-up builds what the program builds (into
the checkout), generates the configuration's data from the seed and writes
its files with the program's writer (flbench/_cache/data/), and warms every
call shape of the traffic with one query.
Then one client calls the timed entry of the traffic mix in a closed loop
for `--seconds` seconds: each call is issued when the last has returned and
its device work has been synchronised. After the window, a sample of the
answers drawn from the seed is compared with the plain reference
(flbench/reference/), and the cell's metrics are read from the run's
record: the end-to-end metrics with `--trace 0`, the per-layer metrics with
`--trace 1` (the window then runs under torch.profiler). Every run also
reports the state of its host (flbench/host.py) beside its metrics.

A cell of more than one card runs one rank a card (flbench/ranks.py): this
process is rank 0, which builds the data, starts the other ranks, owns the
clock and reports; every call gets the program's `mesh=`.

Exits 2 without a result when CUDA or the cell's cards are missing, 3 when a
module of JAX or of the JAX package was loaded (in any rank), and 4 when
another rank failed.
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import statistics
import subprocess
import sys
import time
import traceback
from dataclasses import dataclass, field

from . import host, ranks

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
PROGRAM = "fastlanes_tpu_torch"
#: top-level module names that no run may load
FORBIDDEN = ("jax", "jaxlib", "flax", "fastlanes_tpu")
#: caches of the program's toolchains, at fixed places inside the checkout
CACHE_ENV = {"TORCH_EXTENSIONS_DIR": os.path.join(HERE, "_cache", "torch_extensions"),
             "TRITON_CACHE_DIR": os.path.join(HERE, "_cache", "triton")}


@dataclass
class Record:
    """What the metric readers (flbench/metrics/) read of one run."""
    setup_s: float = 0.0
    #: from the window's first call to the return of its last
    window_s: float = 0.0
    #: each call's latency, on the device's clock where there is a card (_Clock)
    latencies_s: list = field(default_factory=list)
    #: values covered by the completed calls (entries/<entry>.values)
    values: int = 0
    calls: int = 0
    failed: int = 0
    #: the program's counters over the window: launches, host_fetches
    counters: dict = field(default_factory=dict)
    #: summed entries/<entry>.work_of over the window's calls (traced runs)
    work: dict = field(default_factory=dict)
    #: the profiler's record of the window (traced runs), flbench.trace.Trace
    trace: object = None
    #: the card's row of peaks.json
    peaks: dict = None
    #: the CPUs the calling thread was seen on in the window (flbench.host)
    cpus_seen: set = field(default_factory=set)
    #: on a mesh, every rank's summary in rank order (ranks.summary)
    ranks: list = field(default_factory=list)
    #: the card's allocator peak over the run (the fullest card's on a mesh),
    #: read before the reference runs; 0 without a card
    memory_peak_bytes: int = 0


def loaded_forbidden() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def load_benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _module(kind: str, name: str):
    import importlib

    from .dataset import load_module
    importlib.import_module("flbench." + kind)
    return load_module(kind, name)


def _program_entry(entry: str):
    """The program's function `module.function` of fastlanes_tpu_torch, from
    this checkout's copy of the package."""
    import importlib

    program = importlib.import_module(PROGRAM)
    where = os.path.dirname(os.path.abspath(program.__file__))
    if os.path.dirname(where) != ROOT:
        raise RuntimeError(f"{PROGRAM} was imported from {where}, not from this checkout")
    mod, fn = entry.rsplit(".", 1)
    return getattr(importlib.import_module(f"{PROGRAM}.{mod}"), fn)


def _counters() -> dict:
    from fastlanes_tpu_torch import analytics
    from fastlanes_tpu_torch.kernels import cuda_codecs
    return {"launches": sum(cuda_codecs.LAUNCHES.values()),
            "host_fetches": analytics.HOST_FETCHES}


def _sync(device) -> None:
    import torch
    if str(device).startswith("cuda"):
        torch.cuda.synchronize()


def host_form(x):
    """An answer with every tensor copied to the host as a NumPy array."""
    import torch
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    if isinstance(x, dict):
        return {k: host_form(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(host_form(v) for v in x)
    return x


class Sample:
    """The window's answers that are compared, drawn from the seed: a uniform
    sample of k of all (reservoir sampling), and of each call label (each
    shape of a query) a uniform sample of `per_label`, so that no shape goes
    unchecked. Which answers it holds depends only on the seed and the calls
    issued."""

    def __init__(self, k: int, rng, per_label: int = 0):
        self.k, self.rng, self.per_label = k, rng, per_label
        self.any, self.by_label, self.seen = [], {}, {}

    @staticmethod
    def _offer(kept: list, k: int, n_seen: int, item, rng) -> None:
        if len(kept) < k:
            kept.append(item)
            return
        j = int(rng.integers(0, n_seen + 1))
        if j < k:
            kept[j] = item

    def offer(self, i: int, call, answer) -> None:
        item = (i, call, answer)
        self._offer(self.any, self.k, i, item, self.rng)
        if self.per_label:
            n = self.seen.get(call.label, 0)
            self._offer(self.by_label.setdefault(call.label, []), self.per_label, n, item,
                        self.rng)
            self.seen[call.label] = n + 1

    @property
    def kept(self) -> list:
        """Every kept answer once, in call order."""
        items = {it[0]: it for it in self.any}
        for kept in self.by_label.values():
            items.update((it[0], it) for it in kept)
        return [items[i] for i in sorted(items)]


def sample_of(spec: dict, seed: int) -> Sample:
    """The sample a traffic mix asks for (`sample_answers` of all answers,
    `sample_per_label` of each call label), drawn from the seed."""
    from .dataset import rng_of
    return Sample(int(spec.get("sample_answers", 1)), rng_of(seed, 2),
                  int(spec.get("sample_per_label", 0)))


def compare(rmod, ds, kept, threads: int = 4) -> list:
    """Mismatched values of each kept answer against the reference's answer
    to its call (one answer a distinct call, computed on a few threads)."""
    from concurrent.futures import ThreadPoolExecutor

    calls = {}
    for _i, call, _got in kept:
        calls.setdefault(repr(sorted(call.kwargs.items())), call.kwargs)
    with ThreadPoolExecutor(threads) as pool:
        want = dict(zip(calls, pool.map(lambda kw: rmod.expected(ds, kw), calls.values())))
    return [rmod.mismatches(got, want[repr(sorted(call.kwargs.items()))])
            for _i, call, got in kept]


def _power_limit():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return None
    try:
        return float(out.stdout.split()[0])
    except (IndexError, ValueError):
        return None


class _Clock:
    """Each call's latency: on the device's clock where the run has a card
    (CUDA events recorded before the call and after the synchronise that
    follows it, so every stream's work is inside), else the host's."""

    def __init__(self, device):
        import torch
        self.cuda = str(device).startswith("cuda")
        if self.cuda:
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))

    def start(self) -> None:
        if self.cuda:
            self.events[0].record()
        else:
            self.t0 = time.perf_counter()

    def stop(self) -> float:
        """Seconds since start(); the device's work already synchronised."""
        if not self.cuda:
            return time.perf_counter() - self.t0
        self.events[1].record()
        self.events[1].synchronize()
        return self.events[0].elapsed_time(self.events[1]) / 1e3


def _window(fn, calls, seconds, device, sample, values_of, record, spans=False, group=None):
    """The closed loop: returns the calls issued. On a mesh (`group`) every
    rank runs it, and rank 0's clock says when it ends."""
    from torch.profiler import record_function

    from .trace import SPAN

    extra = group.kwargs if group is not None else {}
    issued = []
    clock = _Clock(device)
    start = time.perf_counter()
    deadline = start + seconds
    last = start
    while (last < deadline) if group is None else group.go(last < deadline):
        call = next(calls)
        clock.start()
        try:
            if spans:
                with record_function(SPAN + call.label):
                    answer = fn(**call.kwargs, **extra, device=device)
                    _sync(device)
            else:
                answer = fn(**call.kwargs, **extra, device=device)
                _sync(device)
        except Exception:  # an answer that never comes: counted, and the loop goes on
            traceback.print_exc(file=sys.stderr)
            _sync(device)
            record.failed += 1
            answer = None
        record.latencies_s.append(clock.stop())
        last = time.perf_counter()
        if answer is not None:
            record.values += values_of(call)
            sample.offer(len(issued), call, answer)
        issued.append(call)
        if len(issued) % 64 == 1:
            record.cpus_seen.add(host.cpu_now())
    record.calls = len(issued)
    record.window_s = last - start
    return issued


def warm(fn, spec, ds, seed, device, group=None) -> None:
    """Every call shape of the traffic once (one query of the warm-up
    stream); on a mesh on every rank, then a barrier."""
    from . import traffic

    extra = group.kwargs if group is not None else {}
    for call in traffic.Traffic(spec, ds, seed, stream=3).query():
        fn(**call.kwargs, **extra, device=device)
        _sync(device)
    if group is not None:
        group.barrier()


def measure(fn, calls, seconds, device, sample, values_of, record, trace, group=None):
    """The window, under torch.profiler where traced: (the calls issued, the
    profiler or None)."""
    if not trace:
        return _window(fn, calls, seconds, device, sample, values_of, record,
                       group=group), None
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.startswith("cuda")
                                     else [])
    with profile(activities=acts) as prof:
        issued = _window(fn, calls, seconds, device, sample, values_of, record, spans=True,
                         group=group)
    return issued, prof


def run_cell(bench: dict, cell_name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", overrides=None, data_dir=None, child_argv=None) -> dict:
    """One run of one cell: the result line as a dict. A cell of n > 1 chips
    runs here as rank 0 of n (`child_argv`: ranks.start)."""
    from . import dataset, traffic

    t0 = time.perf_counter()
    cell = next(w for w in bench["workloads"] if w["name"] == cell_name)
    ds = dataset.build(cell["config"], seed, overrides, data_dir or dataset.DATA_DIR)
    t_data = time.perf_counter() - t0
    spec = traffic.load(cell["traffic"])
    fn = _program_entry(spec["entry"])
    entry = spec["entry"].rsplit(".", 1)[1]
    emod, rmod = _module("entries", entry), _module("reference", entry)
    group = ranks.start(cell, seed, seconds, trace, device, overrides, ds, child_argv) \
        if cell["chips"] > 1 else None
    with ranks.guarded(group):
        return _run(bench, cell, seed, seconds, trace, device, ds, spec, fn, emod, rmod, group,
                    t0, t_data)


def _run(bench, cell, seed, seconds, trace, device, ds, spec, fn, emod, rmod, group, t0,
         t_data) -> dict:
    import torch

    from . import traffic
    from .trace import breakdown, collect

    cell_name = cell["name"]
    warm(fn, spec, ds, seed, device, group)
    cuda = device.startswith("cuda")
    record = Record(setup_s=time.perf_counter() - t0)
    steps = ", ".join(f"{k} {v:.2f} s" for k, v in ds.seconds.items())
    print(f"set-up {record.setup_s:.2f} s: data {t_data:.2f} s ({steps}), "
          f"warm-up {record.setup_s - t_data:.2f} s", file=sys.stderr)
    if cuda:
        name = torch.cuda.get_device_name(0)
        with open(os.path.join(HERE, "peaks.json")) as f:
            record.peaks = json.load(f).get(name)

    calls = traffic.Traffic(spec, ds, seed, stream=1).calls()
    sample = sample_of(spec, seed)
    values_of = lambda call: emod.values(ds, call.kwargs)  # noqa: E731
    host_before = host.describe(ds.paths())
    before, usage = _counters(), resource.getrusage(resource.RUSAGE_SELF)
    issued, prof = measure(fn, calls, seconds, device, sample, values_of, record, trace, group)
    after, used = _counters(), resource.getrusage(resource.RUSAGE_SELF)
    print("window: %d calls in %.3f s; host cpu user %.2f s, system %.2f s; %d minor faults; "
          "%d / %d context switches (voluntary / not)" % (
              record.calls, record.window_s, used.ru_utime - usage.ru_utime,
              used.ru_stime - usage.ru_stime, used.ru_minflt - usage.ru_minflt,
              used.ru_nvcsw - usage.ru_nvcsw, used.ru_nivcsw - usage.ru_nivcsw), file=sys.stderr)
    by_label = {}
    for call, lat in zip(issued, record.latencies_s):
        by_label.setdefault(call.label, []).append(lat * 1e3)
    print("calls by label (n, median ms): " + "; ".join(
        f"{k} {len(v)} {statistics.median(v):.1f}" for k, v in sorted(by_label.items())),
        file=sys.stderr)
    tenth = max(1, len(record.latencies_s) // 10)
    print("median call ms by tenth of the window: " + " ".join(
        f"{statistics.median(record.latencies_s[a:a + tenth]) * 1e3:.1f}"
        for a in range(0, tenth * 10, tenth) if record.latencies_s[a:a + tenth]),
        file=sys.stderr)
    record.counters = {k: after[k] - before[k] for k in after}
    host_state = {"before_window": host_before, "after_window": host.describe(ds.paths()),
                  "cpus_seen": sorted(c for c in record.cpus_seen if c is not None),
                  "window_cpu_s": [used.ru_utime - usage.ru_utime,
                                   used.ru_stime - usage.ru_stime],
                  "calibrate_s": host.calibrate()}
    print("host: " + json.dumps(host_state), file=sys.stderr)
    peak = torch.cuda.max_memory_allocated(0) if cuda else 0
    record.memory_peak_bytes = int(peak)

    out_device = {"platform": "gpu" if cuda else "cpu",
                  "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                  "count": cell["chips"], "memory_peak_bytes": int(peak)}
    result = {}
    if trace:
        t_trace = time.perf_counter()
        record.trace = collect(prof)
        del prof
        share = {} if group is None else {"part": (0, group.n)}  # rank 0's chunks
        for call in issued:
            for k, v in emod.work_of(ds, call.kwargs, **share).items():
                record.work[k] = record.work.get(k, 0) + v
        lo, hi = record.trace.window
        out_device.update(busy_s=record.trace.busy_s(), window_s=hi - lo)
        result["breakdown"] = breakdown(record.trace)
        print(f"trace: {len(record.trace.device)} device events, {len(record.trace.ops)} host "
              f"operators, read in {time.perf_counter() - t_trace:.2f} s", file=sys.stderr)
    if cuda:
        out_device["power_limit_w"] = _power_limit()
    if group is not None:
        record.ranks = group.gather(ranks.summary(record, issued, record.trace, peak,
                                                  loaded_forbidden()))
        group.close()
        by_rank = [s["memory_peak_bytes"] for s in record.ranks]
        out_device.update(memory_peak_bytes=max(by_rank), memory_peak_bytes_by_rank=by_rank)
        record.memory_peak_bytes = max(by_rank)
        if trace:  # averaged over the cards
            out_device["busy_s"] = statistics.fmean(s["busy_s"] for s in record.ranks)
        result["ranks"] = [ranks.report(s) for s in record.ranks]

    # the program's state freed; the sampled answers to the host; the reference
    kept = [(i, call, host_form(answer)) for i, call, answer in sample.kept]
    del sample, calls, issued
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    mismatched = sum(compare(rmod, ds, kept))
    print(f"reference: {len(kept)} answers of {record.calls} calls compared in "
          f"{time.perf_counter() - t_ref:.2f} s", file=sys.stderr)
    checks = {"mismatched_values": {"value": mismatched, "max": 0},
              "failed_calls": {"value": record.failed, "max": 0},
              "answers_compared": {"value": len(kept), "min": 1}}
    if group is not None:  # every rank issued rank 0's calls, with rank 0's outcomes
        checks["ranks_differing"] = {"value": sum(
            (s["digest"], s["calls"], s["failed"])
            != (record.ranks[0]["digest"], record.calls, record.failed)
            for s in record.ranks), "max": 0}
    correct = (mismatched == 0 and record.failed == 0 and len(kept) >= 1
               and all(c["value"] <= c["max"] for c in checks.values() if "max" in c))

    wanted = bench["per_layer"] if trace else bench["end_to_end"]
    metrics = {}
    for m in wanted:
        if "workloads" in m and cell_name not in m["workloads"]:
            continue
        value = _module("metrics", m["name"]).read(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": correct, "attempted": record.calls, "failed": record.failed,
              "metrics": metrics, "device": out_device, **result, "host": host_state,
              "checks": checks}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    for k, v in CACHE_ENV.items():
        os.makedirs(v, exist_ok=True)
        os.environ[k] = v
    bench = load_benchmark()
    cell = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    if cell is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2

    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"torch sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    _program_entry("fio.read_header")  # the program, from this checkout, before any set-up
    result = run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace))
    bad = sorted(set(loaded_forbidden()).union(*(r["forbidden"] for r in result.get("ranks", ()))))
    if bad:
        print(f"modules of {bad} were loaded; the benchmark measures {PROGRAM} alone",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        limit = ", ".join(f"{k} {v}" for k, v in c.items() if k != "value")
        print(f"check {name}: {c['value']} ({limit})", file=sys.stderr)
    print(f"correct: {result['correct']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
