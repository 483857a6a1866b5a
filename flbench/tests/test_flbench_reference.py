"""The reference: its exact statistics against the frozen smoke oracles, its
answers against the port's at a small size on the CPU, and its controls."""

import itertools
import math

import numpy as np
import pytest
from conftest import SMALL

from flbench import dataset, traffic
from flbench.reference import common, oracles
from flbench.run import _module, _program_entry, load_benchmark


@pytest.mark.parametrize("seed", range(4))
def test_exact_float_sums_equal_fsum(seed):
    rng = np.random.default_rng(seed)
    vals = np.concatenate([rng.integers(0, 10**7, 5000) / 100.0,
                           rng.standard_normal(3000) * 10.0 ** rng.integers(-20, 20, 3000),
                           [0.0, -0.0, 1e300, -1e300, 5e-324]])
    groups = rng.integers(0, 6, vals.size)  # group 5: left out
    got = common.Prepared(vals).stats(groups, 5)
    for g in range(5):
        want = oracles.float_group_stats(vals[groups == g])
        assert common.mismatches(got[g], want) == 0, (g, got[g], want)


@pytest.mark.parametrize("dtype", [np.uint8, np.uint32, np.int64, np.uint64])
def test_exact_int_sums_equal_the_oracle(dtype):
    rng = np.random.default_rng(1)
    info = np.iinfo(dtype)
    vals = rng.integers(info.min, info.max, 20000, dtype=dtype, endpoint=True)
    keep = vals % 3 == 0
    (got,) = common.Prepared(vals).stats((~keep).astype(np.int64), 1)
    want = oracles.oracle_stats(vals[keep])
    assert got == want


def test_columns_with_nan_and_infinities_take_the_oracles_path():
    vals = np.array([1.5, np.nan, 2.0, np.inf, -1.0, 3.0])
    groups = np.array([0, 0, 1, 1, 2, 3])
    got = common.Prepared(vals).stats(groups, 3)
    for g in range(3):
        assert common.mismatches(got[g], oracles.float_group_stats(vals[groups == g])) == 0


def test_the_comparison_counts_differences():
    a = {"A": {"sum": 1.5, "min": 1, "max": 2, "count": 3}}
    assert common.mismatches(a, a) == 0
    assert common.mismatches({"A": {"sum": 1.5, "min": 1, "max": 2, "count": 4}}, a) == 1
    assert common.mismatches({"A": {"sum": 1, "min": 1, "max": 2, "count": 3}}, a) == 1
    assert common.mismatches({}, a) == 4
    assert common.mismatches({**a, "B": {"sum": 0.0}}, a) == 1
    assert common.mismatches(np.arange(5, dtype=np.uint32), np.arange(5, dtype=np.uint32)) == 0
    assert common.mismatches(np.arange(5, dtype=np.uint32)[::-1].copy(),
                             np.arange(5, dtype=np.uint32)) == 4
    assert common.mismatches(float("nan"), float("nan")) == 0


CELLS = [("tpch-lineitem-sf1", "tpch-q1"), ("tpch-lineitem-sf1", "tpch-q6")]


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    root = tmp_path_factory.mktemp("flbench")
    return {c: dataset.build(c, 2**31 + 21, SMALL[c], str(root)) for c in ("tpch-lineitem-sf1",)}


@pytest.mark.parametrize("config,mix", CELLS)
def test_the_port_answers_as_the_reference(written, config, mix):
    ds = written[config]
    spec = traffic.load(mix)
    fn = _program_entry(spec["entry"])
    ref = _module("reference", spec["entry"].rsplit(".", 1)[1])
    for call in itertools.islice(traffic.Traffic(spec, ds, 2**31 + 21).calls(), 10):
        got = fn(**call.kwargs, device="cpu")
        assert ref.mismatches(got, ref.expected(ds, call.kwargs)) == 0, call.label


@pytest.mark.parametrize("config,mix", CELLS)
def test_every_control_fails(written, config, mix):
    ds = written[config]
    spec = traffic.load(mix)
    ref = _module("reference", spec["entry"].rsplit(".", 1)[1])
    calls = list(itertools.islice(traffic.Traffic(spec, ds, 2**31 + 21).calls(), 8))
    for kind in ref.CONTROLS:
        assert sum(ref.mismatches(ref.control(ds, c.kwargs, kind), ref.expected(ds, c.kwargs))
                   for c in calls) > 0, kind


def test_q6_probes_are_the_stored_doubles(written):
    ds = written["tpch-lineitem-sf1"]
    call = traffic.Traffic(traffic.load("tpch-q6"), ds, 1).query()[0]
    stored = set(np.unique(ds.column(call.kwargs["path"], "l_discount")).tolist())
    for col, _op, value in call.kwargs["preds"]:
        if col == "l_discount":
            assert value in stored and not math.isnan(value)


@pytest.mark.parametrize("cell", [w["name"] for w in load_benchmark()["workloads"]])
def test_the_control_script_reads_every_control_above_zero(cell):
    from flbench import control

    bench = load_benchmark()
    config = next(w["config"] for w in bench["workloads"] if w["name"] == cell)
    r = control.readings(bench, cell, 2**31 + 8, 40, SMALL[config])
    assert r["answers"] >= 1
    assert all(v > 0 for v in r["control_mismatched_values"].values()), r


def test_the_sample_holds_every_call_label():
    from flbench.dataset import rng_of
    from flbench.run import Sample
    from flbench.traffic import Call

    labels = ["l%d" % i for i in range(8)]
    for seed in range(20):
        s = Sample(12, rng_of(seed, 2), per_label=2)
        for i in range(800):
            s.offer(i, Call("e", {}, labels[i % 8]), i)
        kept = s.kept
        assert [i for i, _c, _a in kept] == sorted({i for i, _c, _a in kept})
        by = {}
        for _i, c, _a in kept:
            by[c.label] = by.get(c.label, 0) + 1
        assert set(by) == set(labels) and min(by.values()) >= 2
        assert 16 <= len(kept) <= 28
    again = Sample(12, rng_of(3, 2), per_label=2)
    for i in range(800):
        again.offer(i, Call("e", {}, labels[i % 8]), i)
    first = Sample(12, rng_of(3, 2), per_label=2)
    for i in range(800):
        first.offer(i, Call("e", {}, labels[i % 8]), i)
    assert [k[0] for k in again.kept] == [k[0] for k in first.kept]
