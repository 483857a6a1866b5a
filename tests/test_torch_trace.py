"""The port's spans (fastlanes_tpu_torch/utils/trace.py): with no profiler
running a span is a shared null context and nothing is recorded; under a
profiler each call of a public entry is one root range `fl.<entry>` that
holds every stage range (`fl.header`, `fl.read`, `fl.fetch`, ...) it ran,
one `fl.header` a header parse and one `fl.fetch` a counted host fetch;
answers and counters are the same either way, and the decorated entries
keep their signatures.

The test marked `cuda` skips here; on a card:

    python -m pytest tests/test_torch_trace.py -q --noconftest
"""

import inspect

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from fastlanes_tpu_torch import analytics, fio, fio_device, fio_table
from fastlanes_tpu_torch.kernels import cuda_codecs
from fastlanes_tpu_torch.utils import trace

ENTRIES = [(analytics, n) for n in (
    "scan_column", "scan_table", "count_where", "scan_where", "scan_where_multi",
    "group_stats", "distinct", "value_counts", "top_k", "quantile", "median",
    "select", "join")] + [(fio_device, n) for n in (
        "read_blocks_device", "read_file_device", "read_files_device",
        "read_column_device")]
#: the stage spans of utils/trace.py's docstring
STAGES = {"header", "dict", "zonemap", "window", "read", "decode", "h2d", "mask",
          "acc", "fetch", "combine"}
#: a caller's own range around the call, as the benchmark opens one
CALLER = "flbench.call t"


@pytest.fixture(scope="module")
def table(tmp_path_factory):
    """Ten chunks a column (two lockstep windows): two strings, a date, a
    small integer, two ALP floats and a nullable integer."""
    rng = np.random.default_rng(0x17)
    n = 9 * 1024 + 300
    cols = {"flag": np.array(["A", "N", "R"])[rng.integers(0, 3, n)],
            "status": np.array(["F", "O"])[rng.integers(0, 2, n)],
            "day": np.datetime64("1992-01-01") + rng.integers(0, 2500, n).astype("timedelta64[D]"),
            "q": rng.integers(1, 51, n).astype(np.uint8),
            "v": np.round(rng.uniform(0, 0.1, n), 2),
            "price": np.round(rng.uniform(900, 105000, n), 2),
            "m": np.ma.masked_array(rng.integers(0, 100, n).astype(np.int32),
                                    mask=rng.random(n) < 0.1)}
    path = str(tmp_path_factory.mktemp("trace") / "t.flt")
    fio_table.write_table(path, cols, chunk_blocks=1)
    return path


def queries(path):
    """label -> (entry, call): a group_stats and a scan_where_multi of the
    shapes the benchmark's TPC-H Q1 and Q6 mixes call, and a walk over a
    nullable column (its validity bitmap is read too)."""
    day = np.datetime64
    return {
        "q1": ("group_stats", lambda: analytics.group_stats(
            path, "flag", "v", device="cpu",
            preds=[("day", "le", day("1998-09-01")), ("status", "eq", "F")])),
        "q6": ("scan_where_multi", lambda: analytics.scan_where_multi(
            path, [("day", "ge", day("1994-01-01")), ("day", "lt", day("1995-01-01")),
                   ("v", "ge", 0.05), ("v", "le", 0.07), ("q", "lt", 24)],
            column="price", device="cpu")),
        "nullable": ("scan_where_multi", lambda: analytics.scan_where_multi(
            path, [("m", "ge", 10)], column="m", device="cpu")),
    }


def profiled(fn):
    """fn() under the profiler, inside the caller's range: (answer, host
    ranges as (name, start_ns, end_ns))."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(CALLER):
            out = fn()
    ranges = [(e.name(), e.start_ns(), e.end_ns())
              for e in prof.profiler.kineto_results.events()
              if e.name().startswith(("fl.", CALLER))]
    return out, ranges


def inside(inner, outer) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def test_no_profiler_no_range(table, monkeypatch):
    """Without a profiler a span is the one shared null context: the
    profiler's range is never made, and the entries answer as before."""
    def refuse(*_a, **_k):
        raise AssertionError("a profiler range was opened with no profiler running")

    want = {label: q() for label, (_e, q) in queries(table).items()}
    monkeypatch.setattr(trace, "_RecordFunctionFast", refuse)
    monkeypatch.setattr(torch.autograd.profiler.record_function, "__enter__", refuse)
    assert not torch.autograd._profiler_enabled()
    assert trace.span("read") is trace.span("header") is trace._OFF
    with trace.span("read"):
        pass
    assert {label: q() for label, (_e, q) in queries(table).items()} == want
    with profile(activities=[ProfilerActivity.CPU]):  # the switch is the profiler
        with pytest.raises(AssertionError, match="no profiler running"):
            trace.span("read")


@pytest.mark.parametrize("label", ["q1", "q6", "nullable"])
def test_a_call_is_one_root_holding_its_stages(table, monkeypatch, label):
    headers = []

    def counted(fn):
        def call(*args, **kwargs):
            headers.append(fn.__name__)
            return fn(*args, **kwargs)
        return call

    for mod, fn in ((fio, "read_header"), (fio, "payload_base_of"),
                    (fio_table, "read_table_header")):
        monkeypatch.setattr(mod, fn, counted(getattr(mod, fn)))
    fetches = analytics.HOST_FETCHES
    name, query = queries(table)[label]
    _out, ranges = profiled(query)
    fetches = analytics.HOST_FETCHES - fetches

    (caller,) = [r for r in ranges if r[0] == CALLER]
    spans = [r for r in ranges if r[0].startswith("fl.")]
    roots = [r for r in spans if r[0][3:] not in STAGES]
    assert [r[0] for r in roots] == ["fl." + name] and inside(roots[0], caller)
    stages = [r for r in spans if r[0][3:] in STAGES]
    assert all(inside(r, roots[0]) for r in stages)
    seen = {r[0][3:] for r in stages}
    assert STAGES - {"combine"} - ({"dict"} if label == "nullable" else set()) <= seen, seen
    assert sum(r[0] == "fl.header" for r in spans) == len(headers) > 0
    assert sum(r[0] == "fl.fetch" for r in spans) == fetches > 0


def test_answers_and_counters_are_the_same_under_the_profiler(table):
    def run():
        analytics.HOST_FETCHES = 0
        cuda_codecs.reset_launches()
        out = {label: q() for label, (_e, q) in queries(table).items()}
        return out, analytics.HOST_FETCHES, dict(cuda_codecs.LAUNCHES)

    plain = run()
    traced, _ranges = profiled(run)
    assert traced == plain


@pytest.mark.parametrize("mod,name", ENTRIES, ids=lambda x: getattr(x, "__name__", x))
def test_an_entry_keeps_its_signature(mod, name):
    fn = getattr(mod, name)
    assert inspect.signature(fn) == inspect.signature(fn.__wrapped__)
    assert fn.__name__ == name and fn.__module__ == mod.__name__
    assert fn.__doc__ == fn.__wrapped__.__doc__


@pytest.mark.cuda
def test_no_span_on_the_device_timeline(table):
    """The spans are host ranges only: no `fl.` range appears among the
    device's events, whose union the benchmark reads as device activity."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    args = dict(preds=[("day", "le", np.datetime64("1998-09-01"))])
    analytics.group_stats(table, "flag", "v", **args)  # builds the kernels
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(CALLER):
            analytics.group_stats(table, "flag", "v", **args)
            torch.cuda.synchronize()
    events = list(prof.profiler.kineto_results.events())
    on_device = [e.name() for e in events
                 if e.device_type() == torch.autograd.DeviceType.CUDA]
    assert on_device and not [n for n in on_device if n.startswith("fl.")]
    assert "fl.group_stats" in {e.name() for e in events}
