"""The PyTorch port's own copy of the FLT table container against the JAX
package's: for the same columns both writers (`write_table` and the
streaming `TableWriter`) produce the same bytes, and each host reader reads
the other's file (tolerance 0). Small tables: a few hundred to a few
thousand rows, chunks of 1-2 blocks."""

import numpy as np
import pytest

from fastlanes_tpu import fio_table as jtab

from fastlanes_tpu_torch import fio_table as ttab

N_ROWS = 2 * 1024 + 333  # ragged: three blocks, the last padded


def table_columns(rng, n=N_ROWS):
    """One column per kind the container knows, with every codec between
    them: sorted u64 (delta), dates, small signed ints (zigzag), clustered
    u32 (ffor), strings, decimal f64/f32 (alp), non-decimal f64 (alprd),
    nullable ints / floats / strings, bools, a noisy walk (zdelta), runs."""
    words = np.array(["EUR", "GBP", "JPY", "USD", "chf", "zł", ""])
    return {
        "key": np.sort(rng.integers(0, 1 << 44, n).astype(np.uint64)),
        "day": (np.datetime64("2021-03-01") + rng.integers(0, 700, n)).astype("datetime64[D]"),
        "delta_i32": rng.integers(-40, 40, n).astype(np.int32),
        "qty": (rng.integers(0, 500, n) + 70_000).astype(np.uint32),
        "cur": words[rng.integers(0, words.size, n)],
        "price": np.round(rng.uniform(0, 5000, n), 2),
        "ratio": np.round(rng.uniform(-1, 1, n), 3).astype(np.float32),
        "noise": rng.standard_normal(n),
        "maybe": np.ma.MaskedArray(rng.integers(0, 90, n).astype(np.uint32),
                                   mask=rng.random(n) < 0.2),
        "maybe_f": np.ma.MaskedArray(np.round(rng.uniform(0, 9, n), 1),
                                     mask=rng.random(n) < 0.3),
        "maybe_s": np.ma.MaskedArray(words[rng.integers(0, 4, n)],
                                     mask=rng.random(n) < 0.25),
        "flag": rng.random(n) < 0.4,
        "walk": (np.cumsum(rng.integers(-3, 4, n)) + 10_000).astype(np.uint16),
        "runs": np.repeat(rng.integers(0, 1 << 20, n // 50 + 1), 50)[:n].astype(np.uint32),
        "small": rng.integers(0, 200, n).astype(np.uint8),
        "stamp": np.sort(rng.integers(0, 1 << 40, n)).astype("timedelta64[ms]"),
    }


COLUMNS = sorted(table_columns(np.random.default_rng(0), 8))


def same(got, want):
    assert type(got) is type(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    if isinstance(want, np.ma.MaskedArray):
        assert np.array_equal(np.ma.getmaskarray(got), np.ma.getmaskarray(want))
        got, want = got.data, want.data  # fillers included
    if want.dtype.kind == "f":
        udt = np.dtype(f"uint{want.dtype.itemsize * 8}")
        assert np.array_equal(got.view(udt), want.view(udt))
    else:
        assert np.array_equal(got, want)


def write_both_tables(tmp_path, cols, **kwargs):
    kwargs.setdefault("chunk_blocks", 1)
    pt, pj = str(tmp_path / "port.flt"), str(tmp_path / "ref.flt")
    ht = ttab.write_table(pt, cols, **kwargs)
    hj = jtab.write_table(pj, cols, **kwargs)
    assert ht == hj
    with open(pt, "rb") as ft, open(pj, "rb") as fj:
        assert ft.read() == fj.read()
    return pt, pj


@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    rng = np.random.default_rng(0x7AB1E)
    cols = table_columns(rng)
    pt, pj = write_both_tables(tmp_path_factory.mktemp("tab"), cols)
    return cols, pt, pj


def test_table_bytes_identical_and_every_codec_present(tables):
    cols, pt, pj = tables
    header = ttab.read_table_header(pt)
    assert header == jtab.read_table_header(pj)
    codecs = {c["codec"] for col in header["columns"].values() for c in col["chunks"]}
    assert {"delta", "ffor", "alp", "alprd", "rle"} <= codecs
    assert header["columns"]["delta_i32"]["transform"] == "zigzag"
    assert header["columns"]["cur"]["vtype"] == "str"


@pytest.mark.parametrize("name", COLUMNS)
def test_each_reader_reads_the_other_file(tables, name):
    cols, pt, pj = tables
    want = jtab.read_column(pj, name)
    same(ttab.read_column(pj, name), want)
    same(ttab.read_column(pt, name), want)
    same(jtab.read_column(pt, name), want)
    same(ttab.read_column(pj, name, 1, 3), jtab.read_column(pj, name, 1, 3))
    same(ttab.read_column(pj, name, 2, 99), jtab.read_column(pj, name, 2, 99))
    plain = np.ma.getdata(want)[~np.ma.getmaskarray(want)]
    orig = np.ma.getdata(cols[name])[~np.ma.getmaskarray(cols[name])]
    assert np.array_equal(plain, orig, equal_nan=plain.dtype.kind == "f")


def test_read_table_and_errors(tables):
    cols, pt, pj = tables
    got, want = ttab.read_table(pj), jtab.read_table(pj)
    assert list(got) == list(want) == list(cols)
    for name in want:
        same(got[name], want[name])
    assert list(ttab.read_table(pt, names=["qty", "cur"])) == ["qty", "cur"]
    with pytest.raises(KeyError, match="no column"):
        ttab.read_column(pt, "nope")
    with pytest.raises(IndexError):
        ttab.read_column(pt, "qty", 3, 2)
    with pytest.raises(ValueError, match="not an FLT table"):
        ttab.read_table_header(__file__)


@pytest.mark.parametrize("batch_rows", [100, 1024, 1500])
def test_table_writer_streams_the_same_bytes(tmp_path, rng, batch_rows):
    """TableWriter fed in batches writes what write_table writes in one go,
    in both packages."""
    cols = table_columns(rng, 3000)
    for name in ("maybe_s",):  # a masked string batch may lead with nulls
        cols[name] = np.ma.MaskedArray(np.ma.getdata(cols[name]),
                                       mask=np.ma.getmaskarray(cols[name]))
    pt, pj = write_both_tables(tmp_path, cols, chunk_blocks=2)
    outs = []
    for mod, name in ((ttab, "pw.flt"), (jtab, "jw.flt")):
        path = str(tmp_path / name)
        with mod.TableWriter(path, chunk_blocks=2) as w:
            for at in range(0, 3000, batch_rows):
                w.append({k: v[at:at + batch_rows] for k, v in cols.items()})
        with open(path, "rb") as f:
            outs.append(f.read())
    with open(pt, "rb") as f:
        whole = f.read()
    assert outs[0] == outs[1] == whole


def test_table_writer_closes_and_refuses(tmp_path, rng):
    path = str(tmp_path / "w.flt")
    w = ttab.TableWriter(path)
    w.append({"a": np.arange(10, dtype=np.uint32), "b": np.arange(10.0)})
    with pytest.raises(ValueError, match="all columns"):
        w.append({"a": np.arange(3, dtype=np.uint32)})
    with pytest.raises(ValueError, match="unequal"):
        w.append({"a": np.arange(3, dtype=np.uint32), "b": np.arange(4.0)})
    header = w.close()
    assert w.close() is header
    with pytest.raises(ValueError, match="closed"):
        w.append({"a": np.arange(3, dtype=np.uint32), "b": np.arange(3.0)})


def test_string_column_class(rng):
    import torch

    words = np.array(["a", "b", "d"])
    col = ttab.StringColumn(torch.tensor([2, 0, 1, 2], dtype=torch.uint32), words)
    ref = jtab.StringColumn(np.array([2, 0, 1, 2], np.uint32), words)
    assert col.n_dict == ref.n_dict == 3 and len(col) == len(ref) == 4
    for probe in ("a", "c", "d", "z", ""):
        assert col.code_of(probe) == ref.code_of(probe)
    assert np.array_equal(col.materialize(), ref.materialize())
