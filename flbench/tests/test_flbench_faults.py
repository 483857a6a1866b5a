"""A whole run at a small size on the CPU (the harness's look for a card
skipped): `correct` is true as the program stands, and false with each fault
that a cell can have planted in the timed path. The cells of one card here:
no collective, so the exchange between chips has no fault to plant (the
cells of several cards: test_flbench_ranks.py)."""

import math

import pytest
from conftest import SMALL

from fastlanes_tpu_torch import analytics
from flbench import run

BENCH = run.load_benchmark()
CONFIG = {w["name"]: w["config"] for w in BENCH["workloads"] if w["chips"] == 1}
ENTRY = {"lineitem-q1": (analytics, "group_stats"),
         "lineitem-q6": (analytics, "scan_where_multi")}


def _nudge(answer):
    """One field of an answer moved by one unit in the last place."""
    if "sum" in answer:
        s = answer["sum"]
        return dict(answer, sum=math.nextafter(s, math.inf) if isinstance(s, float) else s + 1)
    first = next(iter(answer))
    return dict(answer, **{first: _nudge(answer[first])})


def unchanged(real, cell):
    first = []

    def stale(*a, **k):  # every call answers what the first one did
        if not first:
            first.append(real(*a, **k))
        return first[0]
    return stale


def half(real, cell, monkeypatch):
    walk = analytics._lockstep_chunks

    def every_other(*a, **k):  # half the windows of rows left out
        for i, rows in enumerate(walk(*a, **k)):
            if i % 2 == 0:
                yield rows
    monkeypatch.setattr(analytics, "_lockstep_chunks", every_other)
    return real


def altered(real, cell):
    return lambda *a, **k: _nudge(real(*a, **k))


def _run(cell, tmp_path, seed=2**31 + 5, seconds=0.6):
    return run.run_cell(BENCH, cell, seed, seconds, False, device="cpu",
                        overrides=SMALL[CONFIG[cell]], data_dir=str(tmp_path))


@pytest.mark.parametrize("cell", sorted(CONFIG))
def test_correct_as_the_program_stands(cell, tmp_path):
    r = _run(cell, tmp_path)
    assert r["correct"] and r["attempted"] >= 1 and r["failed"] == 0
    assert r["checks"]["mismatched_values"]["value"] == 0
    assert list(r)[-1] == "checks"
    # every end-to-end metric of the cell but the card's memory: none on the CPU
    want = {m["name"] for m in BENCH["end_to_end"] if cell in m.get("workloads", [cell])}
    assert set(r["metrics"]) == want - {"memory_peak_mb"}
    assert "setup_s" in r["metrics"]


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("cell", sorted(CONFIG))
def test_a_fault_makes_it_incorrect(cell, fault, tmp_path, monkeypatch):
    mod, name = ENTRY[cell]
    real = getattr(mod, name)
    planted = {"unchanged": lambda: unchanged(real, cell),
               "half": lambda: half(real, cell, monkeypatch),
               "altered": lambda: altered(real, cell)}[fault]()
    monkeypatch.setattr(mod, name, planted)
    r = _run(cell, tmp_path)
    assert not r["correct"]
    assert r["checks"]["mismatched_values"]["value"] > 0


def test_a_call_that_raises_makes_it_incorrect(tmp_path, monkeypatch):
    real, n = analytics.scan_where_multi, []

    def broken(*a, **k):  # the warm-up call answers, every later call raises
        n.append(1)
        if len(n) > 1:
            raise RuntimeError("planted")
        return real(*a, **k)
    monkeypatch.setattr(analytics, "scan_where_multi", broken)
    r = _run("lineitem-q6", tmp_path)
    assert not r["correct"] and r["failed"] == r["attempted"] >= 1
    assert r["checks"]["failed_calls"]["value"] == r["failed"]


@pytest.mark.parametrize("cell", sorted(CONFIG))
def test_a_traced_run_reports_its_counters(cell, tmp_path):
    r = run.run_cell(BENCH, cell, 11, 0.5, True, device="cpu",
                     overrides=SMALL[CONFIG[cell]], data_dir=str(tmp_path))
    assert r["correct"]
    # every per-layer metric of the cell but those of the device's trace: the
    # program's counters and spans
    listed = [m for m in BENCH["per_layer"] if cell in m["workloads"]]
    assert set(r["metrics"]) == {m["name"] for m in listed if m["source"] != "device_trace"}
    reads = next(k for k in r["metrics"] if k.split(".")[0] == "header_reads_per_call")
    assert r["metrics"][reads]["value"] > 0
    assert r["device"]["busy_s"] == 0 and r["device"]["window_s"] > 0
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}


def test_a_fault_in_one_call_shape_makes_it_incorrect(tmp_path, monkeypatch):
    real = analytics.group_stats

    def one_shape(*a, **k):  # only l_tax under linestatus O answers wrong
        out = real(*a, **k)
        pred = dict((c, v) for c, _op, v in k["preds"])
        return _nudge(out) if k["value"] == "l_tax" and pred["l_linestatus"] == "O" else out
    monkeypatch.setattr(analytics, "group_stats", one_shape)
    for seed in (2**31 + 5, 3, 2**32 + 9):  # a window long enough for a whole query
        r = _run("lineitem-q1", tmp_path, seed, seconds=3.0)
        assert r["attempted"] >= 16
        assert not r["correct"] and r["checks"]["mismatched_values"]["value"] > 0, seed


def test_a_run_reports_its_host(tmp_path):
    r = _run("lineitem-q6", tmp_path)
    h = r["host"]
    assert h["calibrate_s"]["python_s"] > 0 and h["calibrate_s"]["numpy_s"] > 0
    assert len(h["window_cpu_s"]) == 2
    assert set(h["before_window"]["resident"]) == {"lineitem.flt"}
    assert list(r)[-2:] == ["host", "checks"]
