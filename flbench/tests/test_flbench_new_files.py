"""A configuration, a metric that reads a program counter and a stage span
of the program are each taken by the harness as new files alone. The files
go into a copy of the benchmark's folders under `tmp_path` (each existing
file a link to flbench's), with `dataset.HERE` pointed at it; one traced
CPU run of a cell made of them goes through `run.run_cell`."""

import copy
import json
import os
import sys
import time

import pytest
from conftest import SMALL, ConfigSizes, config_names, config_sizes

from fastlanes_tpu_torch import analytics
from fastlanes_tpu_torch.utils import trace
from flbench import dataset, run, spans

CONFIG = "throwaway-lineitem"
CELL = "throwaway-q6"
COUNTER = "analytics.THROWAWAY_CALLS"

GENERATOR = '''"""TPC-H LINEITEM by the SF1 generator, at a test size of its own."""

from flbench.dataset import load_module

_SF1 = load_module("configs", "tpch-lineitem-sf1")
VERSION = _SF1.VERSION
generate = _SF1.generate
write = _SF1.write
SMALL = {**_SF1.SMALL, "orders": 2000}
'''
COUNTER_METRIC = '''COUNTERS = ("analytics.THROWAWAY_CALLS",)


def read(record):
    n = record.counters.get(COUNTERS[0])
    return n / record.calls if n is not None and record.calls else None
'''
ABSENT_METRIC = '''COUNTERS = ("analytics.NO_SUCH_COUNTER", "no_such_module.CALLS")


def read(record):
    if not all(c in record.counters for c in COUNTERS):
        return None
    return sum(record.counters[c] for c in COUNTERS) / record.calls
'''


@pytest.fixture
def bench_dir(tmp_path, monkeypatch):
    """The benchmark's folders of files found by name, as links, in
    tmp_path/flbench, which `dataset` then reads in flbench's place."""
    root = tmp_path / "flbench"
    for kind in ("configs", "traffic", "entries", "reference", "metrics"):
        (root / kind).mkdir(parents=True)
        for f in os.listdir(os.path.join(run.HERE, kind)):
            if f.endswith((".py", ".json")) and f != "__init__.py":
                (root / kind / f).symlink_to(os.path.join(run.HERE, kind, f))
    monkeypatch.setattr(dataset, "HERE", str(root))
    yield root
    for name in [m for m in sys.modules if "throwaway" in m]:
        del sys.modules[name]


def _add_config(root, with_size=True):
    with open(os.path.join(run.HERE, "configs", "tpch-lineitem-sf1.json")) as f:
        config = dict(json.load(f), name=CONFIG)
    (root / "configs" / f"{CONFIG}.json").write_text(json.dumps(config))
    code = GENERATOR if with_size else GENERATOR.replace("SMALL = ", "_UNUSED = ")
    (root / "configs" / f"{CONFIG}.py").write_text(code)


def test_every_configuration_has_a_test_size():
    missing = [name for name in config_names() if name not in SMALL]
    assert not missing, "give each a SMALL in " + ", ".join(
        f"flbench/configs/{name}.py" for name in missing)


def test_a_configuration_without_a_test_size_is_named(bench_dir):
    _add_config(bench_dir, with_size=False)
    assert CONFIG in config_names() and CONFIG not in config_sizes()
    with pytest.raises(pytest.skip.Exception, match=f"flbench/configs/{CONFIG}.py"):
        ConfigSizes()[CONFIG]


def test_a_configuration_counter_and_stage_as_new_files(bench_dir, tmp_path, monkeypatch):
    _add_config(bench_dir)
    (bench_dir / "metrics" / "throwaway_calls_per_call.py").write_text(COUNTER_METRIC)
    (bench_dir / "metrics" / "throwaway_absent_per_call.py").write_text(ABSENT_METRIC)
    sizes = config_sizes()
    assert sizes[CONFIG]["orders"] == 2000
    assert sizes["tpch-lineitem-sf1"] == SMALL["tpch-lineitem-sf1"]

    bench = copy.deepcopy(run.load_benchmark())
    bench["workloads"].append({"name": CELL, "config": CONFIG, "traffic": "tpch-q6",
                               "chips": 1, "why": "a test's cell"})
    for m in bench["per_layer"]:
        if m["name"] == "entry_self_ms_per_call":
            m["workloads"].append(CELL)
    for name in ("throwaway_calls_per_call", "throwaway_absent_per_call"):
        bench["per_layer"].append({"name": name, "unit": "calls", "better": "lower",
                                   "source": "program_counter", "layer": "entries",
                                   "moves": "values_per_s", "workloads": [CELL]})

    # the program with a dict counter and a stage span of new names
    monkeypatch.setattr(analytics, "THROWAWAY_CALLS", {"a": 0, "b": 0}, raising=False)
    real = analytics.scan_where_multi

    def scan_where_multi(*a, **k):
        analytics.THROWAWAY_CALLS["a"] += 1
        analytics.THROWAWAY_CALLS["b"] += 2
        with trace.span("throwaway_stage"):
            time.sleep(0.002)
        return real(*a, **k)
    monkeypatch.setattr(analytics, "scan_where_multi", trace.entry(scan_where_multi))

    records, measure = [], run.measure

    def keep(fn, calls, seconds, device, sample, values_of, record, *rest):
        records.append(record)
        return measure(fn, calls, seconds, device, sample, values_of, record, *rest)
    monkeypatch.setattr(run, "measure", keep)

    r = run.run_cell(bench, CELL, 2**31 + 29, 0.6, True, device="cpu",
                     overrides=sizes[CONFIG], data_dir=str(tmp_path / "data"))
    assert r["correct"] and r["attempted"] >= 1
    (record,) = records
    assert r["metrics"]["throwaway_calls_per_call"]["value"] == 3.0
    assert record.counters == {COUNTER: 3 * record.calls}
    assert "throwaway_absent_per_call" not in r["metrics"]  # counters the program lacks

    glue = spans.self_ms_per_call(record, lambda name: name == "scan_where_multi")
    stage = spans.self_ms_per_call(record, lambda name: name == "throwaway_stage")
    assert stage >= 2.0  # each call sleeps 2 ms in it
    assert r["metrics"]["entry_self_ms_per_call"]["value"] == glue
