"""Each metric reader's arithmetic on a recorded fake run."""

import pytest

from flbench.run import Record, _module, load_benchmark
from flbench.trace import Trace, breakdown, short

H100 = {"hbm_bytes_per_s": 3.35e12}


def fake() -> Record:
    t = Trace()
    # a window of 1.0 s from the first span to the last: two calls
    t.spans = [("scan_where_multi", 10.0, 10.5), ("scan_where_multi", 10.6, 11.0)]
    t.device = [
        ("Memcpy HtoD (Pageable -> Device)", "memcpy_htod", 10.1, 10.2),
        ("void decode_kernel<unsigned int, 0, 0>(unsigned int const*)", "kernel", 10.2, 10.25),
        ("Memcpy HtoD (Pageable -> Device)", "memcpy_htod", 10.7, 10.8),
        ("void decode_orig_kernel<unsigned int, 0>(unsigned int const*)", "kernel", 10.79, 10.85),
        ("void at::native::index_add(float*)", "kernel", 10.9, 10.95),
        ("Memset (Device)", "memset", 12.0, 12.01),  # outside the window
    ]
    t.ops = [("aten::copy_", 10.4, 10.5), ("aten::empty", 10.46, 10.47), ("aten::to", 10.0, 11.0)]
    return Record(setup_s=3.5, window_s=2.0, latencies_s=[0.1, 0.2, 0.3, 0.4], values=8_000_000,
                  calls=4, counters={"launches": 10, "host_fetches": 6},
                  work={"payload_bytes": 3.35e12 * 0.01},
                  trace=t, peaks=H100, memory_peak_bytes=723_656_704)


@pytest.mark.parametrize("name,want", [
    ("values_per_s", 4_000_000.0),
    ("setup_s", 3.5),
    ("launches_per_call", 2.5),
    ("host_fetches_per_call", 1.5),
    ("h2d_ms_per_call", 50.0),                     # 0.2 s of HtoD over 4 calls
    ("query_kernels_roofline", 6.25),              # 0.01 s bound / 0.16 s of kernels
    ("device_idle_share", 65.0),                   # busy 0.15 + 0.15 + 0.05 of 1.0 s
    ("memory_peak_mb", 723.656704),
])
def test_reader(name, want):
    got = _module("metrics", name).read(fake())
    assert got == pytest.approx(want, rel=1e-9)


@pytest.mark.parametrize("name", [m["name"] for m in load_benchmark()["per_layer"]
                                  if m["name"].endswith(".q6")])
def test_a_cells_copy_reads_what_its_metric_reads(name):
    base = name.rsplit(".", 1)[0]
    assert _module("metrics", name).read(fake()) == _module("metrics", base).read(fake())


def test_no_card_memory_reads_nothing():
    r = fake()
    r.memory_peak_bytes = 0
    assert _module("metrics", "memory_peak_mb").read(r) is None


@pytest.mark.parametrize("name", ["h2d_ms_per_call", "query_kernels_roofline",
                                  "device_idle_share"])
def test_a_reader_with_nothing_to_read_returns_nothing(name):
    r = fake()
    r.trace = Trace()
    assert _module("metrics", name).read(r) is None
    r = fake()
    r.peaks = None
    r.trace.device = []
    assert _module("metrics", name).read(r) is None


def test_breakdown_names_ops_and_gaps():
    b = breakdown(fake().trace)
    names = [n for n, _s in b["device_ops"]]
    assert names[0] == "Memcpy HtoD (Pageable -> Device)"
    assert "decode_orig_kernel<unsigned int, 0>" in names
    assert all(len(e) == 2 for e in b["idle_gaps"]) and len(b["idle_gaps"]) <= 10
    (first, seconds) = b["idle_gaps"][0]
    assert first == "scan_where_multi | aten::copy_" and seconds == pytest.approx(0.45)
    assert b["idle_gaps"][1][0] == "scan_where_multi | aten::to"
    assert short("void (anonymous namespace)::k<int>(int const*, long)") == \
        "(anonymous namespace)::k<int>"
