"""The port's multi-predicate WHERE (`scan_where_multi`) and GROUP BY
(`group_stats`) on the CPU (`device="cpu"`) against the JAX package's on the
CPU: the same seeded tables through both, and the returned dicts of Python
scalars are EQUAL (tolerance 0, by the strict comparison of
test_torch_analytics_scan.py: types, the sign of a zero and NaN included).
Where the reference raises, the port raises the same exception type. Small
tables: 6 blocks, chunks of 1-2 blocks."""

import numpy as np
import pytest
import torch

from fastlanes_tpu import analytics as jan

from fastlanes_tpu_torch import analytics as tan
from fastlanes_tpu_torch import fio as tfio
from fastlanes_tpu_torch import fio_device as tdev
from fastlanes_tpu_torch import fio_table as ttab
from fastlanes_tpu_torch.kernels import cuda_group

from test_torch_analytics_scan import assert_same
from test_torch_fio_table import table_columns

N = 5 * 1024 + 77


def group_columns(rng, n=N):
    """table_columns plus group keys and the values that stress exactness:
    u64 at and above 2^63, i64 whose group totals pass 2^63, and f64 / f32
    with NaN, +-inf, -0.0 and subnormals placed in chosen groups."""
    cols = table_columns(rng, n)
    g = rng.integers(0, 7, n).astype(np.uint16)
    cols["g"] = g
    cols["gn"] = np.ma.MaskedArray(rng.integers(0, 5, n).astype(np.uint32),
                                   mask=rng.random(n) < 0.15)
    cols["g300"] = rng.integers(0, 300, n).astype(np.int32)  # signed: zigzag key
    cols["big"] = rng.integers(0, 1 << 64, n, dtype=np.uint64) | np.uint64(1 << 63)
    cols["big"][g == 3] = rng.integers(0, 1 << 40, int((g == 3).sum()), dtype=np.uint64)
    cols["huge"] = rng.integers((1 << 62) - (1 << 58), 1 << 62, n, dtype=np.int64)
    cols["huge"][g == 5] *= -1  # group 5 below -2^63 in total, the others above 2^63
    fspec = np.round(rng.uniform(-1000, 1000, n), 2)
    gi = {j: np.flatnonzero(g == j) for j in range(7)}
    fspec[gi[0][:2]] = [np.nan, 1.0]                 # NaN: sum, min, max NaN
    fspec[gi[1][:2]] = [np.inf, -np.inf]             # both infinities: sum NaN
    fspec[gi[2][:1]] = [np.inf]                      # +inf sum
    fspec[gi[3]] = -0.0                              # only -0.0: sum +0.0, min/max -0.0
    fspec[gi[3][:1]] = 0.0
    fspec[gi[4]] = rng.integers(-9, 9, gi[4].size) * 5e-324  # subnormals
    fspec[gi[5]] = np.tile([1e300, 1.0, -1e300, 3.5], gi[5].size // 4 + 1)[:gi[5].size]
    cols["fspec"] = fspec
    f32 = np.round(rng.uniform(-50, 50, n), 1).astype(np.float32)
    f32[gi[0][:1]] = np.nan
    f32[gi[2][:2]] = [np.inf, -0.0]
    f32[gi[4]] = (rng.integers(-9, 9, gi[4].size) * np.float32(1e-45)).astype(np.float32)
    cols["f32spec"] = f32
    return cols


@pytest.fixture(scope="module")
def table(tmp_path_factory):
    root = tmp_path_factory.mktemp("group")
    cols = group_columns(np.random.default_rng(0x6B))
    path = str(root / "g.flt")
    ttab.write_table(path, cols, chunk_blocks=2)
    return cols, path


VALUES = ["qty", "price", "ratio", "noise", "key", "big", "huge", "fspec", "f32spec",
          "cur", "flag", "delta_i32", "small", "maybe", "maybe_f", "maybe_s", "day",
          "walk", "runs", "stamp"]


@pytest.mark.parametrize("value", VALUES)
def test_group_by_an_integer_key_equals_reference(table, value):
    cols, path = table
    assert_same(tan.group_stats(path, "g", value, device="cpu"),
                jan.group_stats(path, "g", value))


GROUPINGS = [
    ("cur", "qty", {}), ("cur", "price", {}), ("cur", "cur", {}), ("cur", "maybe_s", {}),
    ("gn", "qty", {}), ("gn", "fspec", {}), ("maybe", "price", {}), ("small", "qty", {}),
    ("small", "ratio", {}), ("g300", "huge", {}), ("g300", "walk", {}), ("flag", "price", {}),
    ("g", "qty", {"max_groups": 32}), ("g", "price", {"max_groups": 4}),
    ("g", "qty", {"preds": [("price", "gt", 2500.0)]}),
    ("cur", "price", {"preds": [("qty", "lt", 70_100), ("flag", "eq", 1)]}),
    ("g", "fspec", {"preds": [("key", "lt", 1 << 43)]}),  # the sorted key prunes chunks
    ("g", "big", {"preds": [("cur", "in", ["EUR", "zł"]), ("day", "ge", "2022-01-01")]}),
    ("gn", "maybe_f", {"preds": [("maybe", "ne", 45)]}),
    ("g", "qty", {"preds": [("qty", "gt", 1 << 30)]}),  # no chunk can match
    ("qty", "key", {}),  # 64-bit values: no cap (70 500 groups)
]


@pytest.mark.parametrize("key,value,kw", GROUPINGS,
                         ids=[f"{k}-{v}-{i}" for i, (k, v, _) in enumerate(GROUPINGS)])
def test_group_stats_equals_reference(table, key, value, kw):
    cols, path = table
    assert_same(tan.group_stats(path, key, value, device="cpu", **kw),
                jan.group_stats(path, key, value, **kw))


def test_group_sums_are_exact_python_numbers(table):
    """The exactness claims checked once directly: an i64 group total past
    2^63 is a Python int, a float total is math.fsum's, NaN and the
    infinities follow numpy, the sign of a zero survives."""
    import math

    cols, path = table
    g = cols["g"]
    got = tan.group_stats(path, "g", "huge", device="cpu")
    for j in range(7):
        want = int(cols["huge"][g == j].astype(object).sum())
        assert got[j]["sum"] == want
    assert got[0]["sum"] > 1 << 63 and got[5]["sum"] < -(1 << 63)
    got = tan.group_stats(path, "g", "fspec", device="cpu")
    assert math.isnan(got[0]["sum"]) and math.isnan(got[0]["min"])
    assert math.isnan(got[1]["sum"]) and got[1]["max"] == math.inf
    assert got[2]["sum"] == math.inf
    assert got[3]["sum"] == 0.0 and math.copysign(1, got[3]["sum"]) == 1
    assert math.copysign(1, got[3]["min"]) == -1
    for j in (4, 5, 6):
        assert got[j]["sum"] == math.fsum(cols["fspec"][g == j].tolist())


@pytest.mark.parametrize("window", [1, 2, 8])
def test_windows_and_one_fetch_per_call(table, monkeypatch, window):
    """The answer does not depend on the lockstep window, and group_stats
    fetches from the device once per call, whatever the number of windows."""
    cols, path = table
    want = jan.group_stats(path, "g", "price")
    real = tan._lockstep_chunks
    monkeypatch.setattr(tan, "_lockstep_chunks", lambda path, names, device, keep=None, part=None:
                        real(path, names, device, keep=keep, window=window, part=part))
    before = tan.HOST_FETCHES
    assert_same(tan.group_stats(path, "g", "price", device="cpu"), want)
    assert tan.HOST_FETCHES - before == 1


@pytest.mark.parametrize("k,kind,spread", [(7, "f64", 64), (300, "f64", 13), (1024, "f64", 3),
                                           (16, "f32", 64), (7, "int", 64), (1000, "int", 64),
                                           (65536, "int", 15), (65536, "i64", 12)])
def test_the_accumulator_spreads_its_atomic_adds(k, kind, spread):
    """Few groups, or a hot group of a skewed key, put the atomic adds on a
    few addresses: the accumulator takes as many copies as _GROUP_BYTES of
    memory holds, at most _SPREAD."""
    flat = tan._Flat("int" if kind == "i64" else kind, torch.zeros(1, dtype=torch.int64),
                     32 if kind in ("int", "f32") else 64)
    acc = tan._GroupAcc(k, flat, "cpu")
    assert acc.spread == spread
    held = (acc.add.numel() + acc.mn.numel() + acc.mx.numel()) * 8
    assert held <= tan._GROUP_BYTES


H100_SHARED = 232_448  # the opt-in shared memory of one H100 block


@pytest.mark.parametrize("k,n_cols,smem,fits", [
    (3, 1028, H100_SHARED, True),        # TPC-H Q1: 3 groups of f64, ~33 KB
    (27, 1028, H100_SHARED, True),       # the most f64 groups a block holds
    (28, 1028, H100_SHARED, False),
    (414, 68, H100_SHARED, True), (415, 68, H100_SHARED, False),        # f32
    (7263, 2, H100_SHARED, True), (7264, 2, H100_SHARED, False),        # int
    (5810, 3, H100_SHARED, True), (5811, 3, H100_SHARED, False),        # i64
    (3, 2, 4 * 4 * 8, True), (3, 2, 4 * 4 * 8 - 1, False),              # to the byte
    (0, 2, 0, False)])
def test_the_shared_mode_rule_at_its_boundary(k, n_cols, smem, fits):
    """The kernel keeps a block's accumulator in shared memory exactly when
    (k + 1) slots of n_cols sums, a min and a max (int64) fit in it."""
    assert cuda_group.fits_shared(k, n_cols, smem) is fits


@pytest.mark.parametrize("kind", ["int", "i64", "f32", "f64"])
def test_a_cpu_accumulator_takes_the_plain_version(kind):
    """On the CPU the group accumulator feeds through its plain version
    (the copies spread as before the kernel) and launches nothing."""
    bits = 32 if kind in ("int", "f32") else 64
    flat_v = tan._Flat("int" if kind == "i64" else kind,
                       torch.arange(-50, 50, dtype=tan._INT_OF_BITS[bits]), bits)
    flat_k = tan._Flat("int", torch.arange(100, dtype=torch.int16) % 9 - 1, 16)
    acc = tan._GroupAcc(7, flat_v, "cpu")
    assert (acc.mode, acc.spread) == ("plain", tan._spread_of(8, acc.n_cols + 2))
    acc.feed(flat_k, flat_v, 90, None)
    _kind, _offset, ((sums, mins, maxs),) = acc.host_state()
    n_count = 4 if kind in ("f32", "f64") else 1
    assert sums[:, :n_count].sum() == sum(1 for g in range(90) if g % 9 - 1 in range(7))
    assert cuda_group.LAUNCHES == cuda_group.SHARED_LAUNCHES == 0


def test_negative_keys_under_max_groups_index_from_the_end(tmp_path):
    """The reference's scatter takes a negative group number as a Python
    index; with an explicit max_groups the port counts the same rows."""
    key = np.array([-3, -2, -1, 0, 1, 2, 5, 9] * 300, np.int32)
    path = str(tmp_path / "neg.flt")
    ttab.write_table(path, {"k": key, "v": np.arange(key.size, dtype=np.uint32)})
    assert_same(tan.group_stats(path, "k", "v", max_groups=4, device="cpu"),
                jan.group_stats(path, "k", "v", max_groups=4))


def test_group_errors_are_the_reference_errors(table, tmp_path):
    cols, path = table
    calls = [
        dict(key="key", value="qty"),           # 64-bit key
        dict(key="delta_i32", value="qty"),     # negative keys
        dict(key="qty", value="small"),         # 70 500 groups > the integer cap
        dict(key="small", value="price", max_groups=2000),  # > the float cap
        dict(key="price", value="qty", max_groups=4),       # float key
        dict(key="g", value="qty", preds=[("qty", "like", 5)]),
    ]
    two = str(tmp_path / "two.flt")
    ttab.write_table(two, {"k": np.arange(5000, dtype=np.uint32) % 7,
                           "v": np.arange(3000, dtype=np.uint32)}, chunk_blocks=2)
    for kw in calls:
        with pytest.raises(ValueError) as want:
            jan.group_stats(path, **kw)
        with pytest.raises(ValueError) as got:
            tan.group_stats(path, device="cpu", **kw)
        assert str(got.value).split(";")[0].split("(")[0] == \
            str(want.value).split(";")[0].split("(")[0]
    for mod, extra in ((jan, {}), (tan, {"device": "cpu"})):
        with pytest.raises(ValueError, match="chunk"):
            mod.group_stats(two, "k", "v", **extra)
        with pytest.raises(ValueError, match="chunk"):
            mod.scan_where_multi(two, [("k", "lt", 3)], column="v", **extra)


MULTI = [
    ([("qty", "gt", 70_100), ("cur", "eq", "GBP")], "price"),
    ([("day", "ge", "2022-01-01"), ("price", "lt", 2500.0)], "key"),
    ([("maybe", "lt", 45), ("maybe_s", "ne", "JPY")], "maybe_f"),
    ([("key", "lt", 1 << 43), ("qty", "ge", 70_250)], "ratio"),  # prunes on the key
    ([("cur", "in", ["EUR", "USD", "nope"])], "cur"),
    ([], "qty"),
    ([("flag", "eq", 1), ("stamp", "gt", 1 << 39)], "stamp"),
    ([("fspec", "ne", 0.0), ("f32spec", "le", 10.0)], "fspec"),
    ([("big", "lt", 5), ("g", "notin", [1, 2])], "huge"),
    ([("qty", "gt", 1 << 30)], "price"),  # the zone maps rule out every chunk
    ([("walk", "ge", 10_000), ("runs", "lt", 1 << 19), ("small", "ne", 7)], "noise"),
]


@pytest.mark.parametrize("preds,column", MULTI, ids=[str(i) for i in range(len(MULTI))])
def test_scan_where_multi_equals_reference(table, preds, column):
    cols, path = table
    assert_same(tan.scan_where_multi(path, preds, column=column, device="cpu"),
                jan.scan_where_multi(path, preds, column=column))


def test_scan_where_multi_on_single_column_files(tmp_path):
    rng = np.random.default_rng(3)
    values = rng.integers(0, 1000, 3 * 1024 + 5).astype(np.uint32)
    path = str(tmp_path / "c.flt")
    tfio.write_file(path, values, chunk_blocks=1)
    preds = [(None, "gt", 100), (None, "le", 700), (None, "ne", 300)]
    assert_same(tan.scan_where_multi(path, preds, device="cpu"),
                jan.scan_where_multi(path, preds))
    tpath = str(tmp_path / "t.flt")
    ttab.write_table(tpath, {"a": values, "b": values // 3})
    for mod, extra in ((jan, {}), (tan, {"device": "cpu"})):
        with pytest.raises(ValueError, match="column=None"):
            mod.scan_where_multi(tpath, [("a", "gt", 5)], **extra)


def test_pruned_windows_are_not_decoded(table, monkeypatch):
    """A predicate whose zone maps rule out every chunk decodes nothing; one
    that keeps a single window decodes only that window's chunks."""
    cols, path = table
    decoded = []
    real = tdev._decode_chunks_grouped

    def spy(covering, *args, **kwargs):
        decoded.append(sum(m["n_blocks"] for m, _ in covering))
        return real(covering, *args, **kwargs)

    monkeypatch.setattr(tdev, "_decode_chunks_grouped", spy)
    r = tan.scan_where_multi(path, [("key", "lt", 0)], column="price", device="cpu")
    assert r["count"] == 0 and decoded == []
    r = tan.group_stats(path, "g", "qty", max_groups=7, preds=[("key", "lt", int(cols["key"][100]))],
                        device="cpu")
    assert sum(s["count"] for s in r.values()) == int((cols["key"] < cols["key"][100]).sum())
    assert decoded == [2, 2, 2]  # one window of one chunk for each of three columns


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    """tests/test_dataset.py's sharded tables (per-file dictionaries that
    overlap but differ) and two integer-keyed float tables."""
    rng = np.random.default_rng(0xDA7)
    root = tmp_path_factory.mktemp("gshards")
    paths, kpaths = [], []
    for i in range(3):
        cats = np.array(["EUR", "GBP", "JPY", "USD"])[i % 2:][:3]
        cols = {"qty": rng.integers(0, 1000, 2500).astype(np.uint32),
                "cur": cats[rng.integers(0, len(cats), 2500)],
                "price": rng.normal(100.0, 5.0, 2500)}
        cols["k"] = (cols["qty"] % 4).astype(np.uint32)
        p = str(root / f"s{i}.flt")
        ttab.write_table(p, cols)
        paths.append(p)
    for i in range(2):
        p = str(root / f"k{i}.flt")
        ttab.write_table(p, {"k": rng.integers(0, 5, 2000).astype(np.uint16),
                             "v": rng.normal(10.0, 2.0, 2000),
                             "w": rng.integers(-(1 << 62), 1 << 62, 2000, dtype=np.int64)})
        kpaths.append(p)
    return paths, kpaths


@pytest.mark.parametrize("key,value,preds", [
    ("cur", "qty", []), ("cur", "price", []), ("k", "cur", []), ("k", "price", []),
    ("cur", "qty", [("price", "gt", 100.0)]), ("k", "qty", [("cur", "ne", "JPY")]),
])
def test_group_stats_over_a_dataset_equals_reference(shards, key, value, preds):
    paths, _ = shards
    assert_same(tan.group_stats(paths, key, value, preds=preds, device="cpu"),
                jan.group_stats(paths, key, value, preds=preds))


def test_integer_keys_share_one_accumulator_across_files(shards):
    _, kpaths = shards
    before = tan.HOST_FETCHES
    for value in ("v", "w"):
        assert_same(tan.group_stats(kpaths, "k", value, device="cpu"),
                    jan.group_stats(kpaths, "k", value))
    assert tan.HOST_FETCHES - before == 2  # one fetch per call, two files each


def test_scan_where_multi_over_a_dataset_equals_reference(shards):
    paths, _ = shards
    for preds, column in (([("cur", "ne", "JPY"), ("qty", "le", 300)], "qty"),
                          ([("qty", "gt", 500)], "cur"), ([("cur", "eq", "GBP")], "price")):
        assert_same(tan.scan_where_multi(paths, preds, column=column, device="cpu"),
                    jan.scan_where_multi(paths, preds, column=column))


def test_files_without_zone_maps_equal_reference(tmp_path, monkeypatch):
    """tests/test_zonemaps.py's stripped-stats case: without per-chunk stats
    the key range comes from a key scan and nothing is pruned."""
    rng = np.random.default_rng(9)
    n = 4 * 1024
    cols = {"k": (np.arange(n) % 4).astype(np.uint8), "v": rng.integers(0, 1000, n).astype(np.uint32),
            "flag": np.arange(n, dtype=np.uint32), "y": np.linspace(-1, 1, n)}
    monkeypatch.setattr(tfio.zonemaps, "stats_of", lambda *a, **k: None)
    path = str(tmp_path / "old.flt")
    header = ttab.write_table(path, cols, chunk_blocks=1)
    assert not any("stats" in c for col in header["columns"].values() for c in col["chunks"])
    for key, value, preds in (("k", "v", [("flag", "lt", 1000)]), ("k", "y", [("y", "ge", 0.5)]),
                              ("k", "v", [])):
        assert_same(tan.group_stats(path, key, value, preds=preds, device="cpu"),
                    jan.group_stats(path, key, value, preds=preds))
    preds = [("flag", "ge", 1000), ("flag", "lt", 3000), ("v", "lt", 50)]
    assert_same(tan.scan_where_multi(path, preds, column="y", device="cpu"),
                jan.scan_where_multi(path, preds, column="y"))


def test_group_entries_refuse_to_run_without_a_gpu(table):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    cols, path = table
    for call in (lambda: tan.group_stats(path, "g", "qty"),
                 lambda: tan.scan_where_multi(path, [("qty", "gt", 5)], column="price")):
        with pytest.raises(RuntimeError, match="cuda"):
            call()
