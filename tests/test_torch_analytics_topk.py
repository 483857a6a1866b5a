"""The port's `value_counts`, `top_k`, `distinct`, `quantile` and `median` on
the CPU (`device="cpu"`) against the JAX package's on the CPU: the same
seeded files through both, and the answers are EQUAL (tolerance 0, by the
strict comparison of test_torch_analytics_scan.py; arrays of distinct
values by dtype and value). Where the reference raises, the port raises the
same exception type. Small files: 3-6 blocks, chunks of 1-2 blocks."""

import numpy as np
import pytest
import torch

from fastlanes_tpu import analytics as jan

from fastlanes_tpu_torch import analytics as tan
from fastlanes_tpu_torch import fio as tfio
from fastlanes_tpu_torch import fio_table as ttab

from test_torch_analytics_scan import same
from test_torch_analytics_group import group_columns


def assert_same(got, want):
    """`same` of test_torch_analytics_scan.py, element by element for lists
    (top_k, quantile lists: NaN equals NaN, -0.0 is not +0.0)."""
    if isinstance(want, list):
        ok = type(got) is list and len(got) == len(want) and all(map(same, got, want))
    else:
        ok = same(got, want)
    assert ok, f"port {got!r} != reference {want!r}"


def same_array(got, want):
    assert type(got) is type(want) and got.dtype == want.dtype and got.shape == want.shape
    if want.dtype.kind == "f":
        udt = np.dtype(f"uint{want.dtype.itemsize * 8}")
        assert np.array_equal(got.view(udt), want.view(udt))
    else:
        assert np.array_equal(got, want)


@pytest.fixture(scope="module")
def table(tmp_path_factory):
    cols = group_columns(np.random.default_rng(0x70B))
    path = str(tmp_path_factory.mktemp("topk") / "t.flt")
    ttab.write_table(path, cols, chunk_blocks=2)
    return cols, path


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Single-column files: a u32 dictionary straddling 2^31, mixed codecs,
    an all-null column, signed and unsigned 64-bit data clustered by chunk
    (the zone-map walk of top_k must reach the chunk it visits last)."""
    rng = np.random.default_rng(0x70C)
    root = tmp_path_factory.mktemp("topk_files")
    n = 6 * 1024
    words = np.array([0, 5, (1 << 31) - 5, (1 << 31) - 1, 1 << 31, (1 << 31) + 7,
                      (1 << 32) - 1], np.uint32)
    sorted_part = np.sort(rng.integers(0, 1 << 20, 2048)).astype(np.uint32)
    cats = rng.choice(1 << 20, 9, replace=False).astype(np.uint32)
    runs = np.repeat(rng.integers(0, 1 << 20, 32).astype(np.uint32), 64)
    chunk_of = np.arange(n) // 1024
    centre = np.array([-3, 3, -1, 2, -2, 1])[chunk_of]  # clustered by chunk
    cases = {
        "straddle": (words[rng.integers(0, words.size, n - 300)], {"codec": "dict"}),
        "straddle_auto": (words[rng.integers(0, words.size, n - 300)], {}),
        "mixed": (np.concatenate([sorted_part, cats[rng.integers(0, 9, 2048)], runs]), {}),
        "padded": (np.array([5, 9] * 700, np.uint32)[:1300], {}),
        "all_null": (np.ma.MaskedArray(np.zeros(1100, np.uint32), mask=np.ones(1100, bool)),
                     {}),
        "clustered_i32": ((centre * 100_000 + rng.integers(-500, 500, n)).astype(np.int32),
                          {}),
        "clustered_u64": ((centre.astype(np.int64) << 61).astype(np.uint64)
                          + rng.integers(0, 1 << 40, n).astype(np.uint64), {"dtype": "u64"}),
        "clustered_f64": (centre * 1e6 + np.round(rng.uniform(-1, 1, n), 3), {}),
        "nulls_u16": (np.ma.MaskedArray(rng.integers(0, 300, n - 77).astype(np.uint16),
                                        mask=rng.random(n - 77) < 0.3), {}),
        "nan_f32": (np.where(rng.random(n) < 0.01, np.float32(np.nan),
                             rng.normal(0, 100, n).astype(np.float32)).astype(np.float32), {}),
        # more distinct values than value_counts' cap, in one chunk: each
        # step of the reference's binary search decodes every chunk
        "wide_u32": (rng.integers(0, 1 << 30, 70_000).astype(np.uint32),
                     {"chunk_blocks": 1024}),
    }
    out = {}
    for name, (values, kw) in cases.items():
        path = str(root / f"{name}.flt")
        tfio.write_file(path, values, **{"chunk_blocks": 1, **kw})
        out[name] = (path, values)
    return out


TABLE_COLUMNS = ["qty", "price", "ratio", "noise", "key", "big", "huge", "fspec", "f32spec",
                 "cur", "flag", "delta_i32", "small", "maybe", "maybe_f", "maybe_s", "day",
                 "walk", "runs", "stamp", "g", "gn", "g300"]


@pytest.mark.parametrize("column", TABLE_COLUMNS)
def test_value_counts_equals_reference(table, column):
    cols, path = table
    try:
        want = jan.value_counts(path, column)
    except ValueError:
        with pytest.raises(ValueError):
            tan.value_counts(path, column, device="cpu")
        return
    assert_same(tan.value_counts(path, column, device="cpu"), want)


@pytest.mark.parametrize("name", ["straddle", "straddle_auto", "mixed", "padded", "all_null",
                                  "clustered_i32", "clustered_u64", "nulls_u16", "nan_f32"])
def test_value_counts_of_files_equals_reference(files, name):
    path, values = files[name]
    try:
        want = jan.value_counts(path)
    except ValueError:
        with pytest.raises(ValueError):
            tan.value_counts(path, device="cpu")
        return
    got = tan.value_counts(path, device="cpu")
    assert_same(got, want)
    plain = np.ma.getdata(values)[~np.ma.getmaskarray(values)]
    u, c = np.unique(plain, return_counts=True)
    assert got == dict(zip(u.tolist(), c.tolist()))


def test_value_counts_caps_and_refusals(table, files):
    cols, path = table
    for mod, kw in ((jan, {}), (tan, {"device": "cpu"})):
        with pytest.raises(ValueError, match="max_values"):
            mod.value_counts(path, "small", max_values=10, **kw)
        with pytest.raises(ValueError, match="float"):
            mod.value_counts(path, "price", **kw)
        with pytest.raises(ValueError, match="64-bit"):
            mod.value_counts(path, "key", **kw)
        with pytest.raises(ValueError, match="max_values"):
            mod.value_counts(files["wide_u32"][0], **kw)


EMPTY_FLOAT_COLUMNS = {
    "zero_rows_f32": (np.ones(0, np.float32), {}),  # the reference's distinct: uint32 (0,)
    "zero_rows_f64": (np.ones(0, np.float64), ValueError),  # uint64 (0,): the 64-bit refusal
    "all_null_f32": (np.ma.MaskedArray(np.ones(1100, np.float32), mask=np.ones(1100, bool)),
                     {}),
}


@pytest.mark.parametrize("kind", ["table", "file"])
@pytest.mark.parametrize("name", sorted(EMPTY_FLOAT_COLUMNS))
def test_value_counts_of_a_float_column_without_values(tmp_path, name, kind):
    """A float column with no non-null value reaches the refusals only
    through its (integer) distinct set, as in the reference: 0-row and
    all-null f32 count nothing, 0-row f64 meets the 64-bit refusal."""
    values, expected = EMPTY_FLOAT_COLUMNS[name]
    path = str(tmp_path / "t.flt")
    if kind == "table":
        ttab.write_table(path, {"x": values})
        column = "x"
    else:
        tfio.write_file(path, values)
        column = None
    if expected is ValueError:
        for call in (lambda: jan.value_counts(path, column),
                     lambda: tan.value_counts(path, column, device="cpu")):
            with pytest.raises(ValueError, match="64-bit"):
                call()
        return
    want = jan.value_counts(path, column)
    assert want == expected
    assert_same(tan.value_counts(path, column, device="cpu"), want)


@pytest.mark.parametrize("largest", [True, False])
@pytest.mark.parametrize("column", TABLE_COLUMNS)
def test_top_k_equals_reference(table, column, largest):
    cols, path = table
    for k in (1, 2500):  # 2500: more than a chunk holds
        assert_same(tan.top_k(path, column, k=k, largest=largest, device="cpu"),
                    jan.top_k(path, column, k=k, largest=largest))


@pytest.mark.parametrize("largest", [True, False])
@pytest.mark.parametrize("name", ["straddle", "mixed", "padded", "all_null", "clustered_i32",
                                  "clustered_u64", "clustered_f64", "nulls_u16", "nan_f32"])
def test_top_k_of_files_equals_reference(files, name, largest):
    path, values = files[name]
    for k in (3, 5500):
        assert_same(tan.top_k(path, k=k, largest=largest, device="cpu"),
                    jan.top_k(path, k=k, largest=largest))


@pytest.mark.parametrize("name", ["clustered_i32", "clustered_u64", "clustered_f64"])
def test_top_k_reaches_the_chunk_visited_last(files, monkeypatch, name):
    """Chunks clustered by value: the zone maps order the visit, and with k
    larger than all but the last chunk visited, the answer needs that chunk.
    The early stop compares the k-th candidate with the reference's
    UNSIGNED bound tuples; a signed candidate there would stop too early."""
    path, values = files[name]
    visits = []
    real = tan._decoded_chunks

    def spy(*args, keep=None, **kwargs):
        visits.append(None if keep is None else [i for i, x in enumerate(keep) if x])
        return real(*args, keep=keep, **kwargs)

    monkeypatch.setattr(tan, "_decoded_chunks", spy)
    key = values.astype(np.int64) if values.dtype == np.uint64 else values
    for largest in (True, False):
        visits.clear()
        k = 5 * 1024 + 1
        got = tan.top_k(path, k=k, largest=largest, device="cpu")
        order = np.sort(key)[::-1] if largest else np.sort(key)
        assert got == order[:k].tolist()
        assert_same(got, jan.top_k(path, k=k, largest=largest))
        assert sum(len(v) for v in visits) == 6  # every chunk, the last in the last batch
        visits.clear()
        got = tan.top_k(path, k=10, largest=largest, device="cpu")
        assert got == order[:10].tolist() and visits == [[visits[0][0]]]  # one chunk


def test_top_k_fetches_once_per_decoded_run(files, monkeypatch):
    path, _ = files["nulls_u16"]  # six chunks, no zone-map stop for k = 5000
    runs = []
    real = tan._chunk_top
    monkeypatch.setattr(tan, "_chunk_top", lambda *a: runs.append(1) or real(*a))
    before = tan.HOST_FETCHES
    tan.top_k(path, k=5000, device="cpu")
    assert tan.HOST_FETCHES - before == len(runs) >= 2


@pytest.mark.parametrize("column", TABLE_COLUMNS)
def test_distinct_equals_reference(table, column):
    cols, path = table
    same_array(tan.distinct(path, column), jan.distinct(path, column))


@pytest.mark.parametrize("name", ["straddle", "mixed", "padded", "all_null", "clustered_u64",
                                  "nulls_u16", "nan_f32"])
def test_distinct_of_files_equals_reference(files, name):
    path, values = files[name]
    same_array(tan.distinct(path), jan.distinct(path))


def lower_quantiles(values, qs):
    """numpy's method='lower' over the non-null values, as the entries
    return it: None when empty, NaN when any value is NaN."""
    vals = np.ma.getdata(values)[~np.ma.getmaskarray(values)]
    if vals.dtype.kind in "mM":
        vals = vals.view(np.int64)
    if vals.dtype == np.uint64:
        vals = vals.view(np.int64)  # int64 semantics
    if vals.size == 0:
        return [None] * len(qs)
    if vals.dtype.kind == "f" and np.isnan(vals).any():
        return [float("nan")] * len(qs)
    ordered = sorted(vals.tolist())
    return [ordered[int(np.floor(q * (len(ordered) - 1)))] for q in qs]


QUANTILE_COLUMNS = ["qty", "price", "ratio", "key", "huge", "cur", "flag", "maybe", "maybe_f",
                    "day", "delta_i32", "fspec", "f32spec", "small"]
#: a binary search over f64 keys costs the JAX package ~64 of its count_where
#: calls at ~0.2 s each on this table: the f64 searches are held to the
#: reference on the smaller clustered_f64 file below, and to numpy here
SLOW_REFERENCE = ("price", "maybe_f")


@pytest.mark.parametrize("column", QUANTILE_COLUMNS)
def test_quantile_equals_reference(table, column):
    cols, path = table
    qs = [0.0, 0.01, 0.5, 0.99, 1.0]
    got = tan.quantile(path, column, qs, device="cpu")
    assert_same(got, lower_quantiles(cols[column], qs))
    assert_same(tan.median(path, column, device="cpu"), got[2])
    if column not in SLOW_REFERENCE:
        assert_same(got[2], jan.median(path, column))


@pytest.mark.parametrize("name", ["straddle", "all_null", "clustered_i32", "clustered_u64",
                                  "clustered_f64", "nulls_u16", "nan_f32", "wide_u32"])
def test_quantile_of_files_equals_reference(files, name):
    path, values = files[name]
    assert_same(tan.quantile(path, q=0.25, device="cpu"), jan.quantile(path, q=0.25))
    assert_same(tan.quantile(path, q=[0.5, 0.9], device="cpu"),
                lower_quantiles(values, [0.5, 0.9]))


def test_quantile_is_numpy_lower(files, table):
    """The reference's definition checked once directly, on both paths: the
    counting pass (few distinct values) and the binary search."""
    for name in ("straddle", "wide_u32", "clustered_f64"):
        path, values = files[name]
        for q in (0.1, 0.5, 0.97):
            want = np.quantile(values, q, method="lower")
            assert tan.quantile(path, q=q, device="cpu") == want
    for mod, kw in ((jan, {}), (tan, {"device": "cpu"})):
        with pytest.raises(ValueError, match="quantiles"):
            mod.quantile(files["straddle"][0], q=1.5, **kw)


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    """tests/test_dataset.py's shards: overlapping per-file dictionaries."""
    rng = np.random.default_rng(0xDA8)
    root = tmp_path_factory.mktemp("tshards")
    paths, singles = [], []
    for i in range(3):
        cats = np.array(["EUR", "GBP", "JPY", "USD"])[i % 2:][:3]
        p = str(root / f"s{i}.flt")
        ttab.write_table(p, {"qty": rng.integers(0, 1000, 2500).astype(np.uint32),
                             "cur": cats[rng.integers(0, len(cats), 2500)],
                             "price": rng.normal(100.0, 5.0, 2500)})
        paths.append(p)
        p = str(root / f"c{i}.flt")
        tfio.write_file(p, rng.integers(0, 100, 1800).astype(np.uint32))
        singles.append(p)
    return paths, singles


def test_dataset_pushdowns_equal_reference(shards):
    paths, singles = shards
    for column in ("qty", "cur", "price"):
        same_array(tan.distinct(paths, column), jan.distinct(paths, column))
        for largest in (True, False):
            assert_same(tan.top_k(paths, column, k=7, largest=largest, device="cpu"),
                        jan.top_k(paths, column, k=7, largest=largest))
    for column in ("qty", "cur"):  # the counting pass over the dataset
        assert_same(tan.quantile(paths, column, [0.5, 0.9], device="cpu"),
                    jan.quantile(paths, column, [0.5, 0.9]))
    values = np.concatenate([ttab.read_column(p, "price") for p in paths])
    assert_same(tan.quantile(paths, "price", [0.5, 0.9], device="cpu"),
                lower_quantiles(values, [0.5, 0.9]))  # the search over the dataset
    for column in ("qty", "cur"):
        assert_same(tan.value_counts(paths, column, device="cpu"),
                    jan.value_counts(paths, column))
    assert_same(tan.top_k(singles, k=4, device="cpu"), jan.top_k(singles, k=4))
    assert_same(tan.value_counts(singles, device="cpu"), jan.value_counts(singles))
    for mod, kw in ((jan, {}), (tan, {"device": "cpu"})):
        with pytest.raises(ValueError, match="max_values"):
            mod.value_counts(singles, max_values=50, **kw)


def test_pushdown_entries_refuse_to_run_without_a_gpu(table):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    cols, path = table
    for call in (lambda: tan.value_counts(path, "qty"), lambda: tan.top_k(path, "qty"),
                 lambda: tan.quantile(path, "qty"), lambda: tan.median(path, "price")):
        with pytest.raises(RuntimeError, match="cuda"):
            call()
    # distinct touches no device: it runs on the host without one
    assert tan.distinct(path, "cur").size == np.unique(cols["cur"]).size
