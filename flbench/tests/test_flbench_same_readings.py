"""Every per-layer metric reads what it read before its counters were named
by their readers and its entries read from the program: the readers as
they were (a fixed pair of counters, a fixed list of stage names) are kept
here as the expected values, and must agree exactly, on a recorded trace
and on a traced CPU run of each cell of one card at its test size."""

import pytest
from conftest import SMALL

from flbench import run, spans

BENCH = run.load_benchmark()
ONE_CARD = sorted(w["name"] for w in BENCH["workloads"] if w["chips"] == 1)
CONFIG = {w["name"]: w["config"] for w in BENCH["workloads"]}

#: the stage names that entry_self_ms_per_call left out before
STAGES = frozenset({"header", "dict", "zonemap", "window", "read", "decode", "h2d",
                    "mask", "acc", "fetch", "combine"})


def old_counters() -> dict:
    from fastlanes_tpu_torch import analytics
    from fastlanes_tpu_torch.kernels import cuda_codecs
    return {"launches": sum(cuda_codecs.LAUNCHES.values()),
            "host_fetches": analytics.HOST_FETCHES}


OLD = {
    "launches_per_call":
        lambda r, c: c["launches"] / r.calls if r.calls else None,
    "host_fetches_per_call":
        lambda r, c: c["host_fetches"] / r.calls if r.calls else None,
    "entry_self_ms_per_call":
        lambda r, c: spans.self_ms_per_call(r, lambda name: name not in STAGES),
}


def old_read(name, record, counters):
    """What the metric `name` read before: its old reader, or where it is
    unchanged, its reader."""
    base = name.split(".")[0]  # a cell's copy reads what its metric reads
    if base in OLD:
        return OLD[base](record, counters)
    return run._module("metrics", name).read(record)


def test_the_readers_read_as_before_on_a_recorded_trace():
    from test_flbench_span_metrics import fake

    record = fake()
    old = {"launches": 10, "host_fetches": 2}
    record.counters = {"kernels.cuda_codecs.LAUNCHES": 10, "analytics.HOST_FETCHES": 2}
    for m in BENCH["per_layer"]:
        want = old_read(m["name"], record, old)
        assert run._module("metrics", m["name"]).read(record) == want, m["name"]


@pytest.mark.parametrize("cell", ONE_CARD)
def test_the_readers_read_as_before_on_a_cpu_run(cell, tmp_path, monkeypatch):
    seen, measure = [], run.measure

    def keep(fn, calls, seconds, device, sample, values_of, record, *rest):
        before = old_counters()
        out = measure(fn, calls, seconds, device, sample, values_of, record, *rest)
        after = old_counters()
        seen.append((record, {k: after[k] - before[k] for k in after}))
        return out
    monkeypatch.setattr(run, "measure", keep)
    r = run.run_cell(BENCH, cell, 2**31 + 41, 0.6, True, device="cpu",
                     overrides=SMALL[CONFIG[cell]], data_dir=str(tmp_path))
    assert r["correct"]
    (record, counters), = seen
    want = {}
    for m in BENCH["per_layer"]:
        if cell in m["workloads"]:
            value = old_read(m["name"], record, counters)
            if value is not None:
                want[m["name"]] = value
    assert {k: v["value"] for k, v in r["metrics"].items()} == want
    assert {name.split(".")[0] for name in want} >= set(OLD)  # each changed reader read
