"""The readers of the program's spans (flbench/spans.py and the six metrics
that read it) on a recorded fake run: self times subtract the union of the
spans inside, counts are per call, only spans inside the window count, and
a run without them reads nothing."""

import pytest

from fastlanes_tpu_torch import analytics  # noqa: F401  (its entries name the root spans)
from flbench import spans
from flbench.run import Record, _module
from flbench.trace import Trace, breakdown

READERS = ["header_ms_per_call", "header_reads_per_call", "file_read_ms_per_call",
           "h2d_host_ms_per_call", "fetch_wait_ms_per_call", "entry_self_ms_per_call"]


def fake() -> Record:
    t = Trace()
    # a window of 2.0 s from the first call's span to the last's: two calls
    t.spans = [("group_stats x", 10.0, 11.0), ("group_stats y", 11.0, 12.0)]
    t.device = [("void k(int)", "kernel", 10.0, 10.22), ("void k(int)", "kernel", 10.38, 12.0)]
    t.ops = [
        ("fl.group_stats", 10.0, 10.9),
        ("fl.dict", 10.0, 10.1), ("fl.header", 10.02, 10.05),
        ("fl.header", 10.1, 10.15),
        ("fl.window", 10.2, 10.7),
        ("fl.read", 10.2, 10.4), ("aten::empty", 10.25, 10.26),
        ("fl.h2d", 10.35, 10.5),  # overlaps fl.read: the window's children cover 0.3 s
        ("fl.fetch", 10.8, 10.85),
        ("fl.group_stats", 11.0, 11.5),
        ("fl.header", 11.1, 11.2), ("fl.read", 11.2, 11.3),
        ("fl.header", 11.9, 12.5),  # partly outside the window
        ("fl.scan_column", 13.0, 14.0),  # outside the window
        ("fl.header", 13.1, 13.2), ("fl.read", 13.2, 13.5),
    ]
    return Record(setup_s=3.5, window_s=2.0, values=8_000_000, calls=2,
                  counters={"kernels.cuda_codecs.LAUNCHES": 10, "analytics.HOST_FETCHES": 2},
                  trace=t)


@pytest.mark.parametrize("name,want", [
    ("header_ms_per_call", 125.0),      # header 0.03 + 0.05 + 0.1, dict 0.1 - 0.03
    ("header_reads_per_call", 1.5),     # three in the window, two calls
    ("file_read_ms_per_call", 150.0),   # 0.2 (an operator inside is no span) + 0.1
    ("h2d_host_ms_per_call", 75.0),
    ("fetch_wait_ms_per_call", 25.0),
    ("entry_self_ms_per_call", 250.0),  # 0.9 - 0.7 and 0.5 - 0.2
])
def test_reader(name, want):
    assert _module("metrics", name).read(fake()) == pytest.approx(want, rel=1e-9)


def test_self_time_subtracts_the_union_of_the_children():
    got = dict(zip(range(5), spans.self_times([
        ("window", 10.2, 10.7), ("read", 10.2, 10.4), ("h2d", 10.35, 10.5),
        ("header", 10.3, 10.32), ("fetch", 10.6, 10.6)])))
    assert got[0] == pytest.approx(0.5 - 0.3)  # the sum of the children is 0.35
    assert got[1] == pytest.approx(0.2 - 0.02)
    assert got[2] == pytest.approx(0.15)
    assert got[3] == pytest.approx(0.02) and got[4] == 0.0


@pytest.mark.parametrize("name", READERS)
def test_a_reader_with_nothing_to_read_returns_nothing(name):
    read = _module("metrics", name).read
    r = fake()
    r.trace = None
    assert read(r) is None
    r = fake()
    r.trace.ops = [op for op in r.trace.ops if not op[0].startswith("fl.")]
    assert read(r) is None
    r = fake()
    r.calls = 0
    assert read(r) is None


def test_breakdown_names_a_gap_by_the_stage_around_it():
    gaps = breakdown(fake().trace)["idle_gaps"]
    assert gaps[0][0] == "group_stats x | fl.read" and gaps[0][1] == pytest.approx(0.16)


def test_combine_reads_the_exchange_and_nothing_without_one():
    read = _module("metrics", "combine_ms_per_call").read
    r = fake()
    assert read(r) is None  # no call combined
    r.trace.ops += [("fl.combine", 10.86, 10.88), ("fl.combine", 11.6, 11.65)]
    assert read(r) == pytest.approx(35.0)


def test_rank_skew_is_the_largest_ranks_host_time_over_the_mean():
    read = _module("metrics", "rank_skew").read
    r = fake()
    assert read(r) is None  # one rank
    r.ranks = [{"calls": 2, "self_ms": {"read": 30.0, "combine": 50.0}},
               {"calls": 2, "self_ms": {"read": 20.0, "h2d": 10.0, "combine": 1.0}},
               {"calls": 2, "self_ms": {"read": 10.0, "combine": 90.0}}]
    assert read(r) == pytest.approx(30.0 / (70.0 / 3))  # the exchange left out
    r.ranks[2]["self_ms"] = None  # a rank without a trace
    assert read(r) is None
