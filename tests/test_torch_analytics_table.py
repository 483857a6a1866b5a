"""The port's scans on TABLE files and on lists of paths, on the CPU
(`device="cpu"`) against the JAX package's on the CPU: `scan_table`, the
predicates on every kind of table column (integers, dates, strings, floats,
nullable), the cross-column lockstep `scan_where` for several windows, and
sharded datasets. The returned Python scalars are EQUAL (tolerance 0), by the
strict comparison of test_torch_analytics_scan.py."""

import numpy as np
import pytest
import torch

from fastlanes_tpu import analytics as jan

from fastlanes_tpu_torch import analytics as tan
from fastlanes_tpu_torch import fio as tfio
from fastlanes_tpu_torch import fio_device as tdev
from fastlanes_tpu_torch import fio_table as ttab

from test_torch_analytics_scan import OPS, assert_same
from test_torch_fio_table import table_columns


@pytest.fixture(scope="module")
def table(tmp_path_factory):
    rng = np.random.default_rng(0x7AB)
    cols = table_columns(rng, 5 * 1024 + 77)
    cols["price"][[5, 3000]] = [np.nan, -0.0]
    path = str(tmp_path_factory.mktemp("tab") / "t.flt")
    ttab.write_table(path, cols, chunk_blocks=2)
    return cols, path


TABLE_PROBES = {
    "key": [1 << 43, -1], "day": [np.datetime64("2022-01-01"), "2021-06-15", 18800],
    "delta_i32": [-3, 40], "qty": [70_250, 0], "cur": ["GBP", "AAA", "zzz", ""],
    "price": [2500.25, 0.0, float("nan")], "ratio": [0.125, -1.5], "noise": [0.0],
    "maybe": [45], "maybe_f": [4.5], "maybe_s": ["JPY", "nope"], "flag": [1, 0],
    "walk": [10_000], "runs": [1 << 19], "small": [100, 300],
    "stamp": [1 << 39, 600_000],  # raw epochs in the column's unit
}


def test_scan_table_equals_reference(table):
    cols, path = table
    got = tan.scan_table(path, device="cpu")
    want = jan.scan_table(path)
    assert list(got) == list(want)
    for name in want:
        assert_same(got[name], want[name])
    sub = tan.scan_table(path, columns=["price", "cur"], device="cpu")
    assert_same(sub, jan.scan_table(path, columns=["price", "cur"]))
    for name in cols:
        assert_same(tan.scan_column(path, name, device="cpu"), want[name])


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("name", sorted(TABLE_PROBES))
def test_table_column_predicates_equal_reference(table, name, op):
    cols, path = table
    probes = TABLE_PROBES[name]
    for probe in probes:
        value = [probe, probes[0]] if op in ("in", "notin") else probe
        assert_same(tan.count_where(path, op, value, column=name, device="cpu"),
                    jan.count_where(path, op, value, column=name))
    value = list(probes) if op in ("in", "notin") else probes[0]
    assert_same(tan.scan_where(path, op, value, column=name, device="cpu"),
                jan.scan_where(path, op, value, column=name))


@pytest.mark.parametrize("column,where,op,value", [
    ("price", "qty", "gt", 70_250), ("price", "cur", "eq", "GBP"),
    ("price", "cur", "in", ["EUR", "USD", "nope"]), ("qty", "price", "lt", 100.5),
    ("key", "day", "ge", np.datetime64("2022-01-01")), ("cur", "qty", "le", 70_100),
    ("maybe", "price", "gt", 1000.0), ("price", "maybe", "ne", 45),
    ("maybe_f", "maybe_s", "eq", "JPY"), ("ratio", "key", "lt", 1 << 43),
    ("delta_i32", "flag", "eq", 1), ("noise", "walk", "notin", [10_000, 10_001]),
    ("qty", "key", "gt", 1 << 60), ("small", "runs", "ge", 0),
])
def test_cross_column_scan_where_equals_reference(table, column, where, op, value):
    """Lockstep walk of two columns: every window gives the reference's
    answer (window 1 = chunk at a time, 8 = the default, 2 = uneven tail)."""
    cols, path = table
    want = jan.scan_where(path, op, value, column=column, where=where)
    for window in (None, 1, 2, 8):
        assert_same(tan.scan_where(path, op, value, column=column, where=where,
                                   device="cpu", window=window), want)


def test_lockstep_window_is_a_module_constant():
    assert tan._LOCKSTEP_WINDOW == 8


@pytest.fixture(scope="module")
def shards(tmp_path_factory, table):
    """A dataset in three shard files and three shard tables. The tables are
    the module table's three chunks, one each, so the JAX side decodes them
    with the programs it compiled for that table."""
    rng = np.random.default_rng(0x5AD)
    root = tmp_path_factory.mktemp("shards")
    files = {"u32": [], "f64": [], "nullable": [], "table": []}
    cols_all, _ = table
    for i in range(3):
        n = 2048 + 100 * i
        for kind, values, chunk_blocks in (
                ("u32", rng.integers(0, 1 << 32, n).astype(np.uint32), 1),
                # one chunk a file: the reference decodes f64 eagerly, a
                # chunk at a time
                ("f64", np.round(rng.uniform(-9e6, 9e6, n), 3), 1024),
                ("nullable", np.ma.MaskedArray(rng.integers(0, 50, n).astype(np.uint16),
                                               mask=rng.random(n) < 0.2 * i), 1)):
            path = str(root / f"{kind}{i}.flt")
            tfio.write_file(path, values, chunk_blocks=chunk_blocks)
            files[kind].append(path)
        path = str(root / f"t{i}.flt")
        cols = {name: col[2048 * i:2048 * (i + 1)] for name, col in cols_all.items()}
        if i == 2:  # this shard's dictionary lacks a word and has another
            cols["cur"] = np.where(cols["cur"] == "GBP", "AUD", cols["cur"])
        ttab.write_table(path, cols, chunk_blocks=2)
        files["table"].append(path)
    return files


@pytest.mark.parametrize("kind,probe", [("u32", 1 << 31), ("f64", 0.0), ("nullable", 25)])
def test_lists_of_paths_equal_reference(shards, kind, probe):
    paths = shards[kind]
    assert_same(tan.scan_column(paths, device="cpu"), jan.scan_column(paths))
    assert_same(tan.scan_column(tuple(paths), device="cpu"), jan.scan_column(paths))
    for op in ("lt", "ge", "ne", "in"):
        value = [probe] if op == "in" else probe
        assert_same(tan.count_where(paths, op, value, device="cpu"),
                    jan.count_where(paths, op, value))
        assert_same(tan.scan_where(paths, op, value, device="cpu"),
                    jan.scan_where(paths, op, value))


def test_lists_of_tables_equal_reference(shards):
    paths = shards["table"]
    got, want = tan.scan_table(paths, device="cpu"), jan.scan_table(paths)
    assert list(got) == list(want)
    for name in want:
        assert_same(got[name], want[name])
    for column, where, op, value in (("cur", None, "ge", "GBP"), ("price", "cur", "eq", "GBP"),
                                     ("cur", "qty", "gt", 70_200), ("maybe_s", None, "ne", "EUR")):
        assert_same(tan.scan_where(paths, op, value, column=column, where=where, device="cpu"),
                    jan.scan_where(paths, op, value, column=column, where=where))
        assert_same(tan.count_where(paths, op, value, column=where or column, device="cpu"),
                    jan.count_where(paths, op, value, column=where or column))


def test_zone_maps_resolve_a_nullable_table_column(table, monkeypatch):
    """An 'all' chunk counts its rows minus its nulls from the header."""
    decoded = []
    monkeypatch.setattr(tdev, "_decode_chunks_grouped",
                        lambda *a, **k: decoded.append(1) or pytest.fail("decoded"))
    cols, tpath = table
    n_null = int(np.ma.getmaskarray(cols["maybe"]).sum())
    assert tan.count_where(tpath, "lt", 1000, column="maybe", device="cpu") == \
        len(cols["maybe"]) - n_null
    assert decoded == []


def test_errors_are_the_reference_errors(table):
    cols, path = table
    for mod, kw in ((tan, {"device": "cpu"}), (jan, {})):
        with pytest.raises(ValueError, match="unknown predicate"):
            mod.count_where(path, "like", 1, column="qty", **kw)
        with pytest.raises(ValueError, match="unknown predicate"):
            mod.scan_where(path, "between", 1, column="qty", **kw)
        with pytest.raises(ValueError, match="pass column"):
            mod.scan_column(path, **kw)
        with pytest.raises(KeyError, match="no column"):
            mod.scan_column(path, "nope", **kw)
    ttab.write_table(path + ".two", {"a": np.arange(5000, dtype=np.uint32),
                                     "b": np.arange(3000, dtype=np.uint32)}, chunk_blocks=2)
    for mod, kw in ((tan, {"device": "cpu"}), (jan, {})):
        with pytest.raises(ValueError, match="chunk"):
            mod.scan_where(path + ".two", "gt", 5, column="a", where="b", **kw)
    for name in ("scan_where_multi", "group_stats", "quantile", "median", "distinct",
                 "value_counts", "top_k", "select", "join"):
        assert hasattr(jan, name) and hasattr(tan, name)


def test_table_scans_refuse_to_run_without_a_gpu(table):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    cols, path = table
    for call in (lambda: tan.scan_table(path), lambda: tan.scan_column(path, "qty"),
                 lambda: tan.scan_where(path, "gt", 5, column="qty", where="small")):
        with pytest.raises(RuntimeError, match="cuda"):
            call()
