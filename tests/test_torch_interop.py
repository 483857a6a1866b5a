"""The PyTorch port's Arrow / Parquet / CSV / pandas interop
(`fastlanes_tpu_torch.interop`) against the JAX package's: the FLT files it
writes are byte-identical, and what it reads back is the same table."""

import numpy as np
import pytest

from fastlanes_tpu import interop as jinterop

from fastlanes_tpu_torch import fio_table, interop

from test_interop import _sample_arrow_table

pa = pytest.importorskip("pyarrow")
pq = pytest.importorskip("pyarrow.parquet")


def read_bytes(path):
    with open(path, "rb") as f:
        return f.read()


def same_columns(got: dict, want: dict):
    assert list(got) == list(want)
    for name, w in want.items():
        g = got[name]
        assert type(g) is type(w) and g.dtype == w.dtype, name
        if isinstance(w, np.ma.MaskedArray):
            assert np.array_equal(np.ma.getmaskarray(g), np.ma.getmaskarray(w)), name
            g, w = np.ma.getdata(g), np.ma.getdata(w)
        if w.dtype.kind == "f":
            assert np.array_equal(g.view(np.uint8), w.view(np.uint8)), name
        else:
            assert np.array_equal(g, w), name


@pytest.fixture(scope="module")
def parquet_file(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("interop")
    src = _sample_arrow_table(pa, np.random.default_rng(0x1A7E), n=5000)
    path = str(tmp / "src.parquet")
    pq.write_table(src, path, row_group_size=1000)
    return src, path


@pytest.mark.parametrize("batch_rows", [0, 700])
def test_parquet_to_flt_writes_the_reference_bytes(tmp_path, parquet_file, batch_rows):
    src, ppath = parquet_file
    ours, theirs = str(tmp_path / "port.flt"), str(tmp_path / "jax.flt")
    header = interop.parquet_to_flt(ppath, ours, chunk_blocks=2, batch_rows=batch_rows)
    jheader = jinterop.parquet_to_flt(ppath, theirs, chunk_blocks=2, batch_rows=batch_rows)
    assert header == jheader
    assert read_bytes(ours) == read_bytes(theirs)
    assert set(fio_table.read_table_header(ours)["columns"]) == set(src.column_names)


def test_arrow_columns_and_the_parquet_round_trip(tmp_path, parquet_file):
    src, ppath = parquet_file
    same_columns(interop.arrow_to_columns(src), jinterop.arrow_to_columns(src))
    fpath = str(tmp_path / "t.flt")
    interop.parquet_to_flt(ppath, fpath)
    table = fio_table.read_table(fpath)
    assert interop.columns_to_arrow(table).equals(jinterop.columns_to_arrow(table))
    out, jout = str(tmp_path / "back.parquet"), str(tmp_path / "jback.parquet")
    interop.flt_to_parquet(fpath, out)
    jinterop.flt_to_parquet(fpath, jout)
    back = pq.read_table(out)
    assert back.equals(pq.read_table(jout))
    for name in src.column_names:  # values and nulls survive
        assert back.column(name).null_count == src.column(name).null_count
    same_columns(interop.arrow_to_columns(back), jinterop.arrow_to_columns(
        pq.read_table(jout)))


def test_csv_to_flt_writes_the_reference_bytes(tmp_path):
    rng = np.random.default_rng(5)
    qty = rng.integers(0, 500, 3000)
    cur = np.array(["EUR", "USD", ""])[rng.integers(0, 3, 3000)]
    path = str(tmp_path / "d.csv")
    with open(path, "w") as f:
        f.write("qty,cur,price\n")
        for i, (q, c) in enumerate(zip(qty, cur)):
            f.write(f"{q},{c},{'' if i % 7 == 0 else i / 4}\n")
    ours, theirs = str(tmp_path / "port.flt"), str(tmp_path / "jax.flt")
    assert interop.csv_to_flt(path, ours) == jinterop.csv_to_flt(path, theirs)
    assert read_bytes(ours) == read_bytes(theirs)
    same_columns(fio_table.read_table(ours), fio_table.read_table(theirs))


def test_pandas_round_trip_equals_the_reference(tmp_path):
    pd = pytest.importorskip("pandas")
    rng = np.random.default_rng(6)
    n = 2500
    df = pd.DataFrame({
        "qty": rng.integers(0, 1000, n).astype(np.uint32),
        "price": rng.normal(10.0, 1.0, n),
        "cur": np.array(["a", "bb", "ccc"])[rng.integers(0, 3, n)],
        "when": pd.to_datetime(rng.integers(0, 10**9, n), unit="s"),
        "maybe": pd.array([None if i % 5 == 0 else i for i in range(n)], dtype="Int64"),
    })
    ours, theirs = str(tmp_path / "port.flt"), str(tmp_path / "jax.flt")
    assert interop.write_table_from_pandas(ours, df) == \
        jinterop.write_table_from_pandas(theirs, df)
    assert read_bytes(ours) == read_bytes(theirs)
    back = interop.read_table_to_pandas(ours)
    pd.testing.assert_frame_equal(back, jinterop.read_table_to_pandas(theirs))
    for name in ("qty", "price", "when"):
        np.testing.assert_array_equal(back[name].to_numpy(), df[name].to_numpy())
    assert back["cur"].tolist() == df["cur"].tolist()
    assert back["maybe"].isna().tolist() == df["maybe"].isna().tolist()


def test_binary_that_is_not_utf8_is_refused_alike():
    table = pa.table({"b": pa.array([b"ok", b"\xff\xfe"], type=pa.binary())})
    for mod in (interop, jinterop):
        with pytest.raises(ValueError, match="not valid UTF-8"):
            mod.arrow_to_columns(table)
