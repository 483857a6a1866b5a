"""The port's `select` on the CPU (`device="cpu"`) against the JAX package's
on the CPU: the same seeded tables through both, and the returned dicts of
numpy arrays are EQUAL: the same column order, array types (masked or not),
dtypes (unicode widths included), shapes, masks, and values where no mask
hides them (floats bit for bit). The cases are those of tests/test_select.py, the logical dtypes of
tests/test_review_fixes_r3.py and the select cases of tests/test_dataset.py,
plus ORDER BY over keys with heavy ties at every key width (u8, string, i64,
f64), with and without LIMIT, over two lockstep windows and two files.

One answer is not the reference's on purpose: under ORDER BY ... LIMIT the
JAX package can return a row that fails the WHERE, or has a null order key,
when such a row ties a real row of the domain's worst value in a window
with fewer than k real candidates. The port never does; those cases are
held to a numpy oracle, and each shows that the reference differs there."""

import numpy as np
import pytest
import torch

from fastlanes_tpu import analytics as jan
from fastlanes_tpu import fio as jfio

from fastlanes_tpu_torch import analytics as tan
from fastlanes_tpu_torch import fio_table as ttab

N = 9 * 1024 + 300  # ten chunks of one block: two lockstep windows (8 + 2)


def same_rows(got, want):
    """select / join results equal as the module docstring says."""
    assert isinstance(got, dict) and list(got) == list(want), (list(got), list(want))
    for name, w in want.items():
        g = got[name]
        assert type(g) is type(w), (name, type(g), type(w))
        assert g.dtype == w.dtype and g.shape == w.shape, (name, g.dtype, w.dtype, g.shape,
                                                           w.shape)
        present = ~np.ma.getmaskarray(w)  # what lies under a mask is no value
        assert np.array_equal(np.ma.getmaskarray(g), ~present), name
        gd, wd = np.ma.getdata(g)[present], np.ma.getdata(w)[present]
        if wd.dtype.kind == "f":
            bits = np.dtype(f"uint{wd.dtype.itemsize * 8}")
            assert np.array_equal(gd.view(bits), wd.view(bits)), name
        else:
            assert np.array_equal(gd, wd), name


def select_columns(rng, n=N):
    """Every value domain select returns, and order keys with heavy ties."""
    labels = np.array(["EUR", "GBP", "JPY", "USD"])
    qty = rng.integers(0, 1000, n).astype(np.uint32)
    return {
        "rid": np.arange(n, dtype=np.uint32),  # makes the tie order visible
        "cur": labels[rng.integers(0, 4, n)],
        "qty": np.ma.MaskedArray(qty, mask=rng.random(n) < 0.2),
        "price": rng.normal(100.0, 10.0, n),
        "sid": rng.integers(-500, 500, n).astype(np.int32),
        "big": rng.integers(0, 1 << 64, n, dtype=np.uint64),  # >= 2^63 included
        "k8": rng.integers(0, 4, n).astype(np.uint8),
        "s2": np.array(["ant", "bee", "cat"])[rng.integers(0, 3, n)],
        "i64t": np.array([-(1 << 40), 7, 1 << 50], np.int64)[rng.integers(0, 3, n)],
        "f64t": np.array([-0.5, 0.0, 2.5])[rng.integers(0, 3, n)],
        "ratio": np.round(rng.uniform(-100, 100, n), 1).astype(np.float32),
        "flags": rng.random(n) < 0.4,
        "ts": np.datetime64("2026-01-01", "ns") + rng.integers(0, 10**9, n).astype(
            "timedelta64[ns]"),
    }


@pytest.fixture(scope="module")
def table(tmp_path_factory):
    cols = select_columns(np.random.default_rng(0x5E1))
    root = tmp_path_factory.mktemp("select")
    path = str(root / "t.flt")
    ttab.write_table(path, cols, chunk_blocks=1)
    half = N // 2
    halves = []
    for i, rows in enumerate((slice(0, half), slice(half, None))):
        p = str(root / f"half{i}.flt")
        ttab.write_table(p, {k: v[rows] for k, v in cols.items()}, chunk_blocks=1)
        halves.append(p)
    return cols, path, halves


# (columns, preds, limit, order_by, desc)
QUERIES = {
    "basic": (["qty", "cur", "price", "sid"], [("cur", "eq", "GBP"), ("qty", "ge", 500)],
              None, None, False),
    "limit_projection": (["qty"], [("qty", "lt", 500)], 7, None, False),
    "limit_no_preds": (["cur"], [], 3, None, False),
    "limit_second_window": (["rid", "cur"], [("k8", "eq", 2)], 2400, None, False),
    "nullable_pred": (["qty", "cur"], [("qty", "gt", 500)], None, None, False),
    "nullable_selected": (["qty"], [("cur", "eq", "USD")], None, None, False),
    "u64_f64": (["big", "price"], [("k8", "eq", 3)], None, None, False),
    "in_preds": (["qty"], [("cur", "in", ["GBP", "USD"]), ("sid", "in", list(range(-50, 51)))],
                 None, None, False),
    "logical_dtypes": (["flags", "ts"], [("k8", "eq", 1)], None, None, False),
    "every_column": (None, [("sid", "ge", 400)], None, None, False),
    "none_match_pruned": (["qty", "cur", "ts"], [("sid", "gt", 10_000)], None, None, False),
    "none_match_visited": (["qty", "cur", "ts"], [("cur", "eq", "XXX")], None, None, False),
    "order_qty_desc_limit": (["qty", "cur"], [("cur", "ne", "USD")], 10, "qty", True),
    "order_qty_asc_limit": (["qty"], [], 5, "qty", False),
    "order_price_desc_limit": (["price"], [], 7, "price", True),
    "order_cur_limit": (["cur"], [], 4, "cur", False),
    "order_sid": (["qty", "sid"], [("qty", "lt", 100)], None, "sid", False),
    "order_nullable_limit": (["qty"], [], 6, "qty", True),
    "order_nullable": (["qty"], [("cur", "eq", "EUR")], None, "qty", False),
    "order_ts_limit": (["ts"], [], 3, "ts", True),
    "order_big_limit": (["big", "rid"], [], 9, "big", False),
    "order_ratio_limit": (["ratio", "rid"], [("k8", "le", 1)], 11, "ratio", True),
    "order_limit_none_match": (["qty", "cur"], [("cur", "eq", "XXX")], 5, "qty", True),
    "order_not_projected": (["rid"], [("k8", "ne", 0)], 25, "price", False),
}
# ORDER BY keys with heavy ties, both directions, with and without LIMIT (a
# limit of 1500 takes both windows' candidates and ends inside a run of ties)
for _key in ("k8", "s2", "i64t", "f64t"):
    for _desc in (False, True):
        for _limit in (None, 5, 1500):
            QUERIES[f"ties_{_key}_{'desc' if _desc else 'asc'}_{_limit}"] = (
                ["rid", _key], [], _limit, _key, _desc)
    QUERIES[f"ties_{_key}_where_limit"] = (["rid", "cur"], [("cur", "ne", "JPY")], 700,
                                           _key, True)


@pytest.mark.parametrize("name", list(QUERIES))
def test_select_equals_the_reference(table, name):
    _cols, path, _halves = table
    columns, preds, limit, order_by, desc = QUERIES[name]
    kw = dict(columns=columns, preds=preds, limit=limit, order_by=order_by, desc=desc)
    same_rows(tan.select(path, device="cpu", **kw), jan.select(path, **kw))


# the select cases of tests/test_dataset.py, and ties across the two files
DATASET_QUERIES = {
    "where": (["qty", "cur"], [("cur", "eq", "EUR")], None, None, False),
    "limit_file_order": (["qty"], [], 6000, None, False),
    "limit_in_first_file": (["rid"], [("k8", "eq", 0)], 40, None, False),
    "order_limit": (["qty", "cur"], [], 8, "price", True),
    "order_no_limit": (["qty"], [("qty", "lt", 50)], None, "qty", False),
    "ties_k8_limit": (["rid"], [], 2000, "k8", True),
    "ties_i64_limit": (["rid"], [], 3000, "i64t", False),
    "ties_s2": (["rid", "s2"], [("k8", "eq", 1)], None, "s2", True),
}


@pytest.mark.parametrize("name", list(DATASET_QUERIES))
def test_select_dataset_equals_the_reference(table, name):
    _cols, _path, halves = table
    columns, preds, limit, order_by, desc = DATASET_QUERIES[name]
    kw = dict(columns=columns, preds=preds, limit=limit, order_by=order_by, desc=desc)
    same_rows(tan.select(halves, device="cpu", **kw), jan.select(halves, **kw))


def test_select_values_are_the_table(table):
    """Beside the reference: the rows are the written ones (an oracle)."""
    cols, path, _halves = table
    got = tan.select(path, ["rid", "cur", "ts", "big"], [("k8", "eq", 2), ("sid", "lt", 0)],
                     device="cpu")
    rows = np.flatnonzero((cols["k8"] == 2) & (cols["sid"] < 0))
    for name in ("rid", "cur", "ts", "big"):
        assert np.array_equal(got[name], cols[name][rows]) and \
            got[name].dtype == cols[name].dtype


def oracle_top(key, ok, k, desc, high_first):
    """The rows a correct ORDER BY key LIMIT k returns from ONE window: the
    rows `ok` keeps, best key first, equal keys lowest row first (highest
    first for 64-bit keys)."""
    rows = np.flatnonzero(ok)
    tie = -rows if high_first else rows
    kv = key[rows].astype(np.int64)
    return rows[np.lexsort((tie, -kv if desc else kv))][:k]


def leak_cases(root):
    """name -> (path, rid column, select kwargs, oracle rows). In each one a
    masked row ties a real row of the domain's worst value inside a window
    with fewer than k real candidates, ahead of it."""
    out = {}
    # the smallest case: key [5, 0, 0, 3] (u32), flag [1, 0, 1, 1]
    p = str(root / "tiny.flt")
    ttab.write_table(p, {"rid": np.arange(4, dtype=np.uint32),
                         "key": np.array([5, 0, 0, 3], np.uint32),
                         "flag": np.array([1, 0, 1, 1], np.uint8)})
    out["tiny_u32_desc"] = (p, dict(columns=["rid", "flag"], preds=[("flag", "eq", 1)],
                                    order_by="key", desc=True, limit=3), [0, 3, 2])
    # u8 zeros (the worst key of DESC) behind rows a predicate drops
    n = 2000
    key = np.zeros(n, np.uint8)
    key[[900, 1300, 1700]] = [9, 4, 7]
    flag = np.ones(n, np.uint8)
    flag[:100] = 0
    p = str(root / "zeros_u8.flt")
    ttab.write_table(p, {"rid": np.arange(n, dtype=np.uint32), "key": key, "flag": flag})
    want = oracle_top(key, flag == 1, 50, True, False)
    out["u8_zeros_desc"] = (p, dict(columns=["rid", "flag"], preds=[("flag", "eq", 1)],
                                    order_by="key", desc=True, limit=50), want.tolist())
    # u32 2^32 - 1, the worst key of ASC (a narrower key's largest value is
    # not: its complement in 32 bits is never 0)
    top = np.full(n, (1 << 32) - 1, np.uint32)
    top[[10, 500]] = [3, 1]
    p = str(root / "top_u32.flt")
    ttab.write_table(p, {"rid": np.arange(n, dtype=np.uint32), "key": top, "flag": flag})
    want = oracle_top(top, flag == 1, 30, False, False)
    out["u32_top_asc"] = (p, dict(columns=["rid", "flag"], preds=[("flag", "eq", 1)],
                                  order_by="key", desc=False, limit=30), want.tolist())
    # a nullable order key: null rows ahead of real zeros
    kmask = np.zeros(n, bool)
    kmask[:200] = True
    p = str(root / "nullable.flt")
    ttab.write_table(p, {"rid": np.arange(n, dtype=np.uint32),
                         "key": np.ma.MaskedArray(key.astype(np.uint16), mask=kmask)})
    want = oracle_top(key, ~kmask, 40, True, False)
    out["nullable_u16_desc"] = (p, dict(columns=["rid"], order_by="key", desc=True,
                                        limit=40), want.tolist())
    return out


@pytest.fixture(scope="module")
def leaks(tmp_path_factory):
    return leak_cases(tmp_path_factory.mktemp("leak"))


@pytest.mark.parametrize("name", ["tiny_u32_desc", "u8_zeros_desc", "u32_top_asc",
                                  "nullable_u16_desc"])
def test_order_by_limit_never_returns_a_masked_row(leaks, name):
    path, kw, want = leaks[name]
    got = tan.select(path, device="cpu", **kw)
    assert got["rid"].tolist() == want
    if "flag" in got:
        assert (got["flag"] == 1).all()
    # the reference returns a row that fails the WHERE or has a null key here
    ref = jan.select(path, **kw)["rid"].tolist()
    assert ref != want and len(ref) == len(want)
    if name == "tiny_u32_desc":
        assert ref == [0, 3, 1]


def test_without_limit_the_leak_cases_equal_the_reference(leaks):
    for path, kw, _want in leaks.values():
        kw = dict(kw, limit=None)
        same_rows(tan.select(path, device="cpu", **kw), jan.select(path, **kw))


def test_tie_order_of_the_reference(tmp_path):
    """The reference's tie rule, pinned on the port: ORDER BY ... LIMIT takes
    the lowest rows first for keys of up to 32 bits and the highest first for
    64-bit keys, in both directions; without LIMIT ties keep row order, and
    DESC reverses it. Padded tail rows never reach a result."""
    n = 3000
    k = np.arange(n) % 7 == 6
    path = str(tmp_path / "ties.flt")
    ttab.write_table(path, {"rid": np.arange(n, dtype=np.uint32),
                            "k32": k.astype(np.uint32), "k64": k.astype(np.uint64)},
                     chunk_blocks=1)
    for mod, kw in ((tan, {"device": "cpu"}), (jan, {})):
        def rid(**q):
            return mod.select(path, ["rid"], **q, **kw)["rid"].tolist()
        assert rid(order_by="k32", desc=True, limit=5) == [6, 13, 20, 27, 34]
        assert rid(order_by="k64", desc=False, limit=5) == [2999, 2998, 2997, 2996, 2994]
        assert rid(order_by="k64", desc=True, limit=3) == [2995, 2988, 2981]
        assert rid(order_by="k32", desc=True)[:2] == [2995, 2988]
        assert rid(order_by="k32", desc=False)[:2] == [0, 1]
        assert max(rid(order_by="k64", desc=True, limit=n)) == n - 1
        assert len(rid(order_by="k32", limit=4000)) == n


def test_errors_are_the_reference_errors(tmp_path, table):
    _cols, tpath, _halves = table
    path = str(tmp_path / "c.flt")
    jfio.write_file(path, np.arange(2048, dtype=np.uint32))
    for mod, kw in ((tan, {"device": "cpu"}), (jan, {})):
        with pytest.raises(ValueError, match="FLTTAB table"):
            mod.select(path, **kw)
        with pytest.raises(ValueError, match="unknown predicate"):
            mod.select(tpath, ["qty"], [("qty", "between", 3)], **kw)
        with pytest.raises(KeyError):
            mod.select(tpath, ["nope"], **kw)


def test_select_refuses_to_run_without_a_gpu(table):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    _cols, path, _halves = table
    with pytest.raises(RuntimeError, match="cuda"):
        tan.select(path, ["qty"])
