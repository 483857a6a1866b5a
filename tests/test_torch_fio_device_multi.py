"""Many files and table columns through the port's device reads on the CPU
(`device="cpu"`): `read_files_device`, `iter_files_device` and
`read_column_device` against the JAX package's on the CPU and against the
host readers, bit for bit (tolerance 0)."""

import numpy as np
import pytest
import torch

from fastlanes_tpu import fio_device as jdev
from fastlanes_tpu import fio_table as jtab

from fastlanes_tpu_torch import fio as tfio
from fastlanes_tpu_torch import fio_device as tdev
from fastlanes_tpu_torch import fio_table as ttab
from fastlanes_tpu_torch.kernels import cuda_codecs as ck
from fastlanes_tpu_torch.models import codecs as tcodecs

from test_torch_alp_device import bits_of
from test_torch_fio import codec_blocks, special_columns
from test_torch_fio_table import COLUMNS, table_columns


def as_host(got):
    """A port result as the host reader's array (masked for nullable)."""
    if isinstance(got, tdev.NullableColumn):
        return got.materialize()
    if isinstance(got, ttab.StringColumn):
        return got.materialize()
    return got.numpy()


def same_host(got, host):
    arr = as_host(got)
    if isinstance(host, np.ma.MaskedArray):
        assert isinstance(got, tdev.NullableColumn)
        assert np.array_equal(np.ma.getmaskarray(arr), np.ma.getmaskarray(host))
        keep = ~np.ma.getmaskarray(host)
        arr, host = np.ma.getdata(arr)[keep], np.ma.getdata(host)[keep]
    assert arr.shape == host.shape
    if host.size == 0:  # the host reader leaves an empty range in the wire dtype
        return
    if host.dtype.kind in "mMb":  # logical dtypes come back as their storage
        host = host.view(f"int{host.dtype.itemsize * 8}") if host.dtype.kind != "b" \
            else host.astype(arr.dtype)
        arr = arr.view(host.dtype)
    assert arr.dtype == host.dtype
    assert arr.tobytes() == host.tobytes()


def same_reference(got, ref):
    """... and the JAX package's device result: same mask, same bits (its
    u64 is the (..., 2) limb image or LimbPlanes, its f64 the limb image)."""
    if isinstance(ref, jdev.NullableColumn):
        assert np.array_equal(got.valid.numpy(), np.asarray(ref.valid))
        got, ref = got.values, ref.values
    if isinstance(ref, jtab.StringColumn):
        assert np.array_equal(got.dictionary, ref.dictionary)
        got, ref = got.codes, ref.codes
    ref = np.ascontiguousarray(np.asarray(ref))
    arr = got.numpy()
    if arr.dtype.itemsize == 8 and ref.dtype == np.uint32:
        ref = ref.view(np.uint64).reshape(ref.shape[:-1])
    assert arr.shape == ref.shape
    assert arr.tobytes() == ref.tobytes()


@pytest.fixture
def shard_files(tmp_path, rng):
    """Files of several dtypes and codecs; equal signatures recur across
    files so that cross-file groups form."""
    specs = [
        ("u32", "bitpack", {}), ("u32", "bitpack", {}), ("u32", "ffor", {}),
        ("u32", "ffor", {}), ("u16", "delta", {}), ("u64", "delta", {}),
        ("u64", "delta", {}), ("u8", "rle", {}), ("u32", "dict", {}), ("u32", "dict", {}),
        ("u32", "zdelta", {}), ("u32", "auto", {}),
    ]
    paths = []
    for i, (dt, codec, kw) in enumerate(specs):
        path = str(tmp_path / f"s{i}.flt")
        values = codec_blocks(rng, dt, codec if codec != "auto" else "delta", 5)
        tfio.write_file(path, values, dtype=dt, codec=codec, chunk_blocks=2, **kw)
        paths.append(path)
    special = special_columns(rng)
    for name in ("signed_small_i32", "nullable_u32", "ragged_5000", "nullable_i64", "all_null"):
        path = str(tmp_path / f"{name}.flt")
        values, kw = special[name]
        tfio.write_file(path, values, chunk_blocks=2, **kw)
        paths.append(path)
    for i, fdt in enumerate((np.float32, np.float64, np.float64)):
        path = str(tmp_path / f"f{i}.flt")
        values = np.round(rng.uniform(0, 700, 4 * 1024 + 9), 2).astype(fdt)
        values[[2100, 3500]] = np.nan
        tfio.write_file(path, values, codec="alp", chunk_blocks=1)
        paths.append(path)
    path = str(tmp_path / "rd.flt")
    tfio.write_file(path, rng.standard_normal(3000), chunk_blocks=2)
    paths.append(path)
    path = str(tmp_path / "empty.flt")
    tfio.write_file(path, np.zeros(0, np.uint32))
    return paths + [path]


def test_read_files_device_matches_reference(shard_files):
    paths = shard_files
    before = dict(ck.LAUNCHES)
    got = tdev.read_files_device(paths + paths[:3], device="cpu")  # duplicates
    ref = jdev.read_files_device(paths)
    assert list(got) == paths == list(ref)
    for path in paths:
        same_host(got[path], tfio.read_file(path))
        same_reference(got[path], ref[path])
        one = tdev.read_file_device(path, device="cpu")
        assert as_host(one).tobytes() == as_host(got[path]).tobytes()
    assert ck.LAUNCHES == before


def test_read_files_device_groups_across_files(tmp_path, rng, monkeypatch):
    """One decode call per (dtype, signature) group, whichever file a chunk
    came from; ffor chunks of many files merge too, with one reference per
    block."""
    paths = []
    for i in range(4):
        path = str(tmp_path / f"b{i}.flt")
        tfio.write_file(path, rng.integers(1 << 8, 1 << 9, (4, 1024), dtype=np.uint32),
                        codec="bitpack", chunk_blocks=2)
        paths.append(path)
    for i in range(3):
        path = str(tmp_path / f"f{i}.flt")
        values = rng.integers(0, 1 << 6, (3, 1024), dtype=np.uint32)
        values[:, 0], values[:, 1] = 0, 63
        tfio.write_file(path, values + np.uint32(1000 * (i + 1)), codec="ffor",
                        chunk_blocks=3)
        paths.append(path)
    calls = []
    real = tdev._decode_packed_device

    def spy(codec, packed, base, w, ref_val, dtype, natural=False):
        calls.append((codec, packed.shape[0],
                      tuple(ref_val.shape) if isinstance(ref_val, torch.Tensor) else ref_val))
        return real(codec, packed, base, w, ref_val, dtype, natural=natural)

    monkeypatch.setattr(tdev, "_decode_packed_device", spy)
    got = tdev.read_files_device(paths, device="cpu")
    assert sorted(calls) == [("bitpack", 16, None), ("ffor", 9, (9,))]
    for path in paths:
        assert np.array_equal(got[path].numpy(), tfio.read_file(path))


@pytest.mark.parametrize("prefetch", [0, 1, 2, 5])
def test_iter_files_device_matches_reference(shard_files, prefetch):
    paths = shard_files[::2] + shard_files[:2]  # order kept, repeats allowed
    seen = []
    ref = dict(jdev.iter_files_device(paths, prefetch=max(prefetch, 1)))
    for path, got in tdev.iter_files_device(paths, device="cpu", prefetch=prefetch):
        seen.append(path)
        same_host(got, tfio.read_file(path))
        same_reference(got, ref[path])
    assert seen == paths
    assert list(tdev.iter_files_device([], device="cpu")) == []


@pytest.fixture(scope="module")
def table(tmp_path_factory):
    rng = np.random.default_rng(0xC01)
    cols = table_columns(rng)
    path = str(tmp_path_factory.mktemp("tab") / "t.flt")
    ttab.write_table(path, cols, chunk_blocks=1)
    return cols, path


@pytest.mark.parametrize("name", COLUMNS)
def test_read_column_device_matches_reference(table, name):
    cols, path = table
    before = dict(ck.LAUNCHES)
    for start, stop in ((0, None), (1, 3), (0, 2), (2, 99), (1, 1)):
        got = tdev.read_column_device(path, name, start, stop, device="cpu")
        same_host(got, ttab.read_column(path, name, start, stop))
        same_reference(got, jdev.read_column_device(path, name, start, stop))
    whole = tdev.read_column_device(path, name, device="cpu")
    inner = whole.values if isinstance(whole, tdev.NullableColumn) else whole
    flat = inner.codes if isinstance(inner, ttab.StringColumn) else inner
    assert tuple(flat.shape) == (len(cols[name]),)  # trimmed to the ragged length
    assert ck.LAUNCHES == before


def test_read_column_device_kinds_and_errors(table):
    cols, path = table
    cur = tdev.read_column_device(path, "cur", device="cpu")
    assert isinstance(cur, ttab.StringColumn) and cur.codes.dtype == torch.uint32
    assert isinstance(cur.dictionary, np.ndarray) and cur.n_dict == len(set(cols["cur"]))
    maybe_s = tdev.read_column_device(path, "maybe_s", device="cpu")
    assert isinstance(maybe_s, tdev.NullableColumn)
    assert isinstance(maybe_s.values, ttab.StringColumn)
    assert maybe_s.n_null == int(np.ma.getmaskarray(cols["maybe_s"]).sum())
    assert tdev.read_column_device(path, "price", device="cpu").dtype == torch.float64
    assert tdev.read_column_device(path, "ratio", device="cpu").dtype == torch.float32
    assert tdev.read_column_device(path, "delta_i32", device="cpu").dtype == torch.int32
    assert tdev.read_column_device(path, "day", device="cpu").dtype == torch.int64
    with pytest.raises(KeyError, match="no column"):
        tdev.read_column_device(path, "nope", device="cpu")
    with pytest.raises(IndexError):
        tdev.read_column_device(path, "qty", 3, 1, device="cpu")


def test_new_entries_refuse_to_run_without_a_gpu(table, shard_files):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    cols, path = table
    for call in (lambda: tdev.read_files_device(shard_files[:2]),
                 lambda: next(iter(tdev.iter_files_device(shard_files[:2]))),
                 lambda: tdev.read_column_device(path, "qty"),
                 lambda: tcodecs.get_codec("alp", "f64").encode(np.zeros(1024))):
        with pytest.raises(RuntimeError, match="cuda"):
            call()
