"""The per-call header scope (fastlanes_tpu_torch/fio.py `header_scope`,
opened by every public entry through utils/trace.py `entry`): one call of an
entry reads and parses each file's header once (`fio.HEADER_PARSES`) and
serves its later lookups from the scope (`fio.HEADER_HITS`); an entry called
inside another shares its caller's scope; nothing outlives the call, so a
file rewritten between two calls, an entry that raised and a generator read
after its caller returned all read the file as it is.

Answers are held to the same calls with the scope switched off (every lookup
reads the file again, as it did before the scope)."""

import os

import numpy as np
import pytest
import torch

from fastlanes_tpu_torch import analytics, fio, fio_device, fio_table

DAY = np.datetime64


def _columns(seed: int = 0x17, n: int = 9 * 1024 + 300) -> dict:
    """Ten chunks a column at chunk_blocks=1 (two lockstep windows): two
    strings, a date, a small integer, two ALP floats and a nullable integer
    (tests/test_torch_trace.py's table)."""
    rng = np.random.default_rng(seed)
    return {"flag": np.array(["A", "N", "R"])[rng.integers(0, 3, n)],
            "status": np.array(["F", "O"])[rng.integers(0, 2, n)],
            "day": DAY("1992-01-01") + rng.integers(0, 2500, n).astype("timedelta64[D]"),
            "q": rng.integers(1, 51, n).astype(np.uint8),
            "v": np.round(rng.uniform(0, 0.1, n), 2),
            "price": np.round(rng.uniform(900, 105000, n), 2),
            "m": np.ma.masked_array(rng.integers(0, 100, n).astype(np.int32),
                                    mask=rng.random(n) < 0.1)}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A table, two more tables of the same columns (a dataset of three),
    a dimension table keyed by `flag`, and three FLT column files."""
    d = tmp_path_factory.mktemp("scope")
    tables = []
    for i in range(3):
        path = str(d / f"t{i}.flt")
        fio_table.write_table(path, _columns(0x17 + i), chunk_blocks=1)
        tables.append(path)
    dim = str(d / "dim.flt")
    fio_table.write_table(dim, {"flag": np.array(["A", "N", "R"]),
                                "weight": np.array([3, 5, 7], np.uint16)})
    rng = np.random.default_rng(5)
    cols = []
    for i in range(3):
        path = str(d / f"c{i}.flt")
        fio.write_file(path, rng.integers(0, 1 << 12, 5000 + 700 * i).astype(np.uint32),
                       chunk_blocks=2)
        cols.append(path)
    return {"tables": tables, "dim": dim, "cols": cols}


def calls(f) -> dict:
    """label -> (files the call reads, call): every entry, the benchmark's
    Q1 and Q6 shapes, a nullable walk, a dataset of three tables and a
    nested entry (median calls quantile and its counts)."""
    t, (t1, t2), cols = f["tables"][0], f["tables"][1:], f["cols"]
    q1 = [("day", "le", DAY("1998-09-01")), ("status", "eq", "F")]
    q6 = [("day", "ge", DAY("1994-01-01")), ("day", "lt", DAY("1995-01-01")),
          ("v", "ge", 0.05), ("v", "le", 0.07), ("q", "lt", 24)]
    an, fd = analytics, fio_device
    return {
        "q1_group_stats": (1, lambda: an.group_stats(t, "flag", "v", device="cpu", preds=q1)),
        "q6_scan_where_multi": (1, lambda: an.scan_where_multi(t, q6, column="price",
                                                               device="cpu")),
        "nullable_walk": (1, lambda: an.scan_where_multi(t, [("m", "ge", 10)], column="m",
                                                         device="cpu")),
        "dataset_of_three": (3, lambda: an.group_stats([t, t1, t2], "q", "price",
                                                       device="cpu", preds=q1)),
        "median_nests_quantile": (1, lambda: an.median(t, "price", device="cpu")),
        "scan_column": (1, lambda: an.scan_column(t, "m", device="cpu")),
        "scan_table": (1, lambda: an.scan_table(t, ["flag", "v", "m"], device="cpu")),
        "count_where": (1, lambda: an.count_where(t, "eq", "N", column="flag", device="cpu")),
        "scan_where": (1, lambda: an.scan_where(t, "lt", 24, column="price", where="q",
                                                device="cpu")),
        "distinct": (1, lambda: an.distinct(t, "q")),
        "value_counts": (1, lambda: an.value_counts(t, "status", device="cpu")),
        "top_k": (1, lambda: an.top_k(t, "price", k=5, device="cpu")),
        "quantile": (1, lambda: an.quantile(t, "v", [0.1, 0.5, 0.99], device="cpu")),
        "select": (1, lambda: an.select(t, ["q", "flag", "m"], q6[:2], limit=7, device="cpu",
                                        order_by="price", desc=True)),
        "select_dataset": (2, lambda: an.select([t, t1], ["q", "status"], [("q", "lt", 3)],
                                                device="cpu", order_by="q")),
        "join": (2, lambda: an.join(t, f["dim"], on="flag", columns=["q", "flag"],
                                    preds=[("q", "lt", 5)], device="cpu")),
        "read_blocks_device": (1, lambda: fd.read_blocks_device(cols[1], 1, 5, device="cpu")),
        "read_file_device": (1, lambda: fd.read_file_device(cols[0], device="cpu")),
        "read_files_device": (3, lambda: fd.read_files_device(cols, device="cpu")),
        "read_column_device": (1, lambda: fd.read_column_device(t, "m", device="cpu")),
    }


def plain(x):
    """An answer as comparable Python values (tensors, device columns,
    masked arrays and NaN included)."""
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    if isinstance(x, (fio_device.NullableColumn, fio_table.StringColumn)):
        return plain(x.materialize())
    if isinstance(x, torch.Tensor):
        return plain(x.numpy())
    if isinstance(x, np.ma.MaskedArray):
        return (str(x.dtype), plain(np.ma.getdata(x)), np.ma.getmaskarray(x).tolist())
    if isinstance(x, np.ndarray):
        return (str(x.dtype), x.shape, plain(x.tolist()))
    if isinstance(x, float) and np.isnan(x):
        return "nan"
    return x


class _NoScope:
    """Stands for fio._CALL with the scope switched off: no call is ever
    open, so every lookup reads the file again."""

    def get(self):
        return None

    def set(self, _value):
        return None

    def reset(self, _token):
        return None


def counted(call):
    """(answer, header parses, scope hits) of one call."""
    fio.HEADER_PARSES = fio.HEADER_HITS = 0
    out = call()
    return out, fio.HEADER_PARSES, fio.HEADER_HITS


LABELS = list(calls({"tables": ["t", "t1", "t2"], "dim": "d", "cols": ["c"] * 3}))


@pytest.mark.parametrize("label", LABELS)
def test_a_call_parses_each_file_once(files, monkeypatch, label):
    n_files, call = calls(files)[label]
    out, parses, hits = counted(call)
    assert parses == n_files, (label, parses)
    assert fio._CALL.get() is None  # closed with the call
    monkeypatch.setattr(fio, "_CALL", _NoScope())
    want, parses_off, _ = counted(call)
    assert plain(out) == plain(want)
    assert parses_off >= parses
    if label in ("q1_group_stats", "q6_scan_where_multi", "nullable_walk",
                 "dataset_of_three", "median_nests_quantile"):
        assert hits > 0 and parses_off > parses


def test_each_call_has_a_scope_of_its_own(files):
    """Two calls parse twice: nothing is kept between calls."""
    _n, call = calls(files)["q1_group_stats"]
    fio.HEADER_PARSES = 0
    assert call() == call()
    assert fio.HEADER_PARSES == 2


def test_no_scope_outside_an_entry(files):
    """A helper called outside any entry reads the file at every lookup."""
    t = files["tables"][0]
    fio.HEADER_PARSES = fio.HEADER_HITS = 0
    analytics._column_layout(t, "q")
    analytics._column_layout(t, "q")
    assert (fio.HEADER_PARSES, fio.HEADER_HITS) == (2, 0)
    with fio.header_scope():  # as an entry holds it; nested, it is shared
        with fio.header_scope():
            analytics._column_layout(t, "q")
        analytics._column_layout(t, "v")
        assert analytics._str_dict_of(t, "flag") is analytics._str_dict_of(t, "flag")
    assert (fio.HEADER_PARSES, fio.HEADER_HITS) == (3, 3)


def _sized_table(path: str, shift: int):
    """A table whose values move with `shift` while its size stays: the
    same widths, and stats of the same number of digits."""
    n = 3 * 1024 + 100
    v = (np.arange(n, dtype=np.uint32) * 7919 % 80 + 10 + shift).astype(np.uint32)
    fio_table.write_table(path, {"v": v, "s": np.array(["a", "b"])[v % 2]}, chunk_blocks=1)
    return v


def test_a_rewritten_file_is_read_anew(tmp_path):
    """Rewritten at the same path with the same size and mtime between two
    calls, the table answers from its new bytes."""
    path = str(tmp_path / "r.flt")
    v0 = _sized_table(path, 0)
    st = os.stat(path)
    assert analytics.scan_column(path, "v", device="cpu")["sum"] == int(v0.sum())
    assert analytics.value_counts(path, "s", device="cpu") == \
        {"a": int((v0 % 2 == 0).sum()), "b": int((v0 % 2 == 1).sum())}
    v1 = _sized_table(path, 1)
    os.utime(path, ns=(st.st_atime_ns, st.st_mtime_ns))
    assert os.path.getsize(path) == st.st_size and os.stat(path).st_mtime_ns == st.st_mtime_ns
    assert analytics.scan_column(path, "v", device="cpu")["sum"] == int(v1.sum())
    assert analytics.value_counts(path, "s", device="cpu") == \
        {"a": int((v1 % 2 == 0).sum()), "b": int((v1 % 2 == 1).sum())}


def test_a_call_that_raised_leaves_nothing(files, tmp_path):
    """After an unknown column and after a corrupt header, the next call
    parses afresh and answers correctly; a corrupt header raises the error
    it raised before the scope."""
    t = files["tables"][0]
    want = analytics.scan_column(t, "q", device="cpu")
    with pytest.raises(KeyError, match="no column"):
        analytics.scan_column(t, "nope", device="cpu")
    assert fio._CALL.get() is None
    fio.HEADER_PARSES = 0
    assert analytics.scan_column(t, "q", device="cpu") == want
    assert fio.HEADER_PARSES == 1

    path = str(tmp_path / "c.flt")
    with open(t, "rb") as f:
        good = f.read()
    with open(path, "wb") as f:  # an unsupported version, same length
        f.write(good.replace(b'"version": 1', b'"version": 9', 1))
    for entry in (lambda: analytics.scan_column(path, "q", device="cpu"),
                  lambda: analytics.select(path, ["q"], device="cpu"),
                  lambda: fio_device.read_column_device(path, "q", device="cpu")):
        with pytest.raises(ValueError, match="unsupported FLT table version 9"):
            entry()
    with open(path, "wb") as f:
        f.write(good)
    assert analytics.scan_column(path, "q", device="cpu") == want


def test_the_errors_of_a_file_of_the_other_kind(files):
    """A table where an FLT column file is read, and the reverse, raise the
    readers' own errors, scope or not."""
    t, c = files["tables"][0], files["cols"][0]
    with pytest.raises(ValueError, match="not an FLT file"):
        fio_device.read_file_device(t, device="cpu")
    for entry in (lambda: fio_device.read_column_device(c, "q", device="cpu"),
                  lambda: analytics.scan_table(c, device="cpu"),
                  lambda: analytics.join(t, c, on="flag", device="cpu")):
        with pytest.raises(ValueError, match="not an FLT table file"):
            entry()
    with pytest.raises(ValueError, match="select\\(\\) takes an FLTTAB table file"):
        analytics.select(c, device="cpu")
    with pytest.raises(ValueError, match="pass column"):
        analytics.scan_column(t, device="cpu")


def test_a_generator_read_after_its_scope_closed(files):
    """iter_files_device's reads run where and when it is consumed: part of
    it inside a scope, the rest after the scope closed, each file as
    read_file_device reads it."""
    cols = files["cols"]
    want = [plain(fio_device.read_file_device(p, device="cpu")) for p in cols]
    with fio.header_scope():
        it = fio_device.iter_files_device(cols, device="cpu")
        got = [next(it)]
    got += list(it)
    assert [p for p, _ in got] == cols
    assert [plain(v) for _, v in got] == want
    assert fio._CALL.get() is None
