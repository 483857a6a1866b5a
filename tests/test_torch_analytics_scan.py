"""The port's scans (`scan_column`, `scan_table`, `count_where`,
`scan_where`) on the CPU (`device="cpu"`) against the JAX package's on the
CPU: the same seeded files through both, and the returned Python scalars
are EQUAL (tolerance 0; `same` below is `==` made strict about types, the
sign of a zero and NaN, which `==` alone cannot compare). Small files: 3-6
blocks, chunks of 1-2 blocks, tables of a few thousand rows."""

import math

import numpy as np
import pytest
import torch

from fastlanes_tpu import analytics as jan

from fastlanes_tpu_torch import analytics as tan
from fastlanes_tpu_torch import fio as tfio
from fastlanes_tpu_torch import fio_device as tdev
from fastlanes_tpu_torch import fio_table as ttab

from test_torch_fio import codec_blocks
from test_torch_fio_table import table_columns

OPS = ("lt", "le", "gt", "ge", "eq", "ne", "in", "notin")


def same(got, want):
    if isinstance(want, dict):
        return isinstance(got, dict) and list(got) == list(want) and \
            all(same(got[k], want[k]) for k in want)
    if type(got) is not type(want):
        return False
    if isinstance(want, float):
        if math.isnan(want):
            return math.isnan(got)
        return got == want and math.copysign(1, got) == math.copysign(1, want)
    return got == want


def assert_same(got, want):
    assert same(got, want), f"port {got!r} != reference {want!r}"


def flt_cases(rng):
    """name -> (values, write kwargs, probes)."""
    n = 4 * 1024 + 300
    f64 = np.round(rng.uniform(-500, 500, n), 2)
    f64[[5, 1200, 2300, 4000]] = [-0.0, 0.0, 250.25, -250.5]
    specials = f64.copy()
    specials[[7, 1100, 3000]] = [np.nan, np.inf, -np.inf]
    f32 = np.round(rng.uniform(-50, 50, n), 1).astype(np.float32)
    f32[[9, 77]] = [-0.0, np.float32(12.5)]
    tiny64 = rng.integers(-40, 40, n) * 5e-324  # subnormals and zeros
    tiny32 = (rng.integers(-40, 40, n) * np.float32(1e-45)).astype(np.float32)
    cancel = np.tile(np.array([1e300, 1.0, -1e300, 3.5]), n // 4 + 1)[:n]
    cases = {
        "u8": (rng.integers(0, 200, n).astype(np.uint8), {}, [0, 100, 199, 255, 256, -1]),
        "u16_top": (rng.integers(0, 1 << 16, n).astype(np.uint16), {}, [1 << 15, 65535, 70000]),
        "u32_top": (rng.integers(0, 1 << 32, n).astype(np.uint32), {},
                    [1 << 31, (1 << 32) - 1, 1 << 32, -5]),
        "u32_sorted": (np.sort(rng.integers(0, 1 << 28, 6 * 1024)).astype(np.uint32), {}, [1 << 27]),
        "u64_small": (np.sort(rng.integers(0, 1 << 45, n).astype(np.uint64)), {}, [1 << 44, -1]),
        "u64_top": (rng.integers(0, 1 << 64, n, dtype=np.uint64), {},
                    [1 << 63, (1 << 64) - 1, 1 << 64, 12345]),
        "i8": (rng.integers(-128, 128, n).astype(np.int8), {}, [-128, 0, 127, 128, -129]),
        "i16": (rng.integers(-30000, 30000, n).astype(np.int16), {}, [-1, 40000]),
        "i32": (rng.integers(-(1 << 31), 1 << 31, n).astype(np.int32), {}, [-(1 << 31), 0, 1 << 31]),
        "i32_small": (rng.integers(-60, 60, n).astype(np.int32), {}, [-3, 59, 60]),
        "i64": (rng.integers(-(1 << 62), 1 << 62, n, dtype=np.int64), {}, [0, -(1 << 61)]),
        "i64_walk": ((np.cumsum(rng.integers(-5, 6, n)) - 10 ** 12).astype(np.int64), {},
                     [-10 ** 12]),
        "f64": (f64, {}, [250.25, 0.0, -0.0, 1e9, float("nan"), float("inf")]),
        "f64_specials": (specials, {}, [0.0, float("inf"), float("-inf"), float("nan")]),
        "f64_noise": (rng.standard_normal(n), {}, [0.1]),
        "f64_subnormal": (tiny64, {}, [0.0, 5e-324, -1.5e-323]),
        "f64_cancel": (cancel, {}, [1.0, 1e300]),
        "f32": (f32, {}, [12.5, 0.0, 0.1, 1e39]),
        "f32_subnormal": (tiny32, {}, [0.0, 1e-45]),
        "f32_specials": (specials.astype(np.float32), {}, [float("nan"), float("-inf")]),
        "nullable_u32": (np.ma.MaskedArray(rng.integers(100, 200, n).astype(np.uint32),
                                           mask=rng.random(n) < 0.2), {}, [150]),
        "nullable_f64": (np.ma.MaskedArray(f64, mask=rng.random(n) < 0.3), {}, [0.0]),
        "nullable_sorted": (np.ma.MaskedArray(
            np.sort(rng.integers(0, 1 << 28, 4096)).astype(np.uint32),
            mask=np.arange(4096) % 7 == 0), {}, [1 << 27]),
        "all_null": (np.ma.MaskedArray(np.zeros(2000, np.uint32), mask=np.ones(2000, bool)),
                     {}, [0]),
        "one_value": (np.array([7], np.uint16), {}, [7, 8]),
        "blocks_2d": (rng.integers(0, 1000, (3, 1024)).astype(np.uint32), {}, [500]),
    }
    for codec in ("bitpack", "ffor", "delta", "zdelta", "rle", "dict"):
        for dt in ("u16", "u64"):
            vals = codec_blocks(rng, dt, codec, 5)
            cases[f"{codec}_{dt}"] = (vals, {"codec": codec, "dtype": dt},
                                      [int(vals[2, 17])])
    return cases


CASES = sorted(flt_cases(np.random.default_rng(0)))
#: f64 files written as one chunk: the reference decodes f64 eagerly, one
#: chunk run at a time (~0.1 s each on a CPU). f64_specials and f64_cancel
#: keep three chunks (NaN, infinities and cancelling sums merged across
#: chunks), as do the files test_files_without_zone_maps_equal_reference
#: writes again
ONE_CHUNK = {"f64": 8, "f64_noise": 8, "f64_subnormal": 8, "nullable_f64": 8}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    rng = np.random.default_rng(0x5CA2)
    root = tmp_path_factory.mktemp("scan")
    out = {}
    for name, (values, kwargs, probes) in flt_cases(rng).items():
        path = str(root / f"{name}.flt")
        tfio.write_file(path, values, chunk_blocks=ONE_CHUNK.get(name, 2), **kwargs)
        out[name] = (path, values, probes)
    return out


@pytest.mark.parametrize("name", CASES)
def test_scan_column_equals_reference(files, name):
    path, values, _ = files[name]
    got = tan.scan_column(path, device="cpu")
    assert_same(got, jan.scan_column(path))
    plain = np.ma.getdata(values)[~np.ma.getmaskarray(values)].reshape(-1)
    assert got["count"] == plain.size
    if plain.dtype.kind in "iu" and plain.size and plain.dtype.itemsize < 8:
        assert got["sum"] == int(plain.astype(object).sum())
        assert (got["min"], got["max"]) == (int(plain.min()), int(plain.max()))
    if plain.dtype.kind == "f" and plain.size and np.isfinite(plain).all():
        assert got["sum"] == math.fsum(plain.tolist())


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("name", CASES)
def test_count_and_scan_where_equal_reference(files, name, op):
    path, values, probes = files[name]
    for probe in probes:
        value = [probe, probes[0]] if op in ("in", "notin") else probe
        assert_same(tan.count_where(path, op, value, device="cpu"),
                    jan.count_where(path, op, value))
    value = [probes[0], probes[-1]] if op in ("in", "notin") else probes[0]
    assert_same(tan.scan_where(path, op, value, device="cpu"),
                jan.scan_where(path, op, value))


def test_count_where_is_numpy_on_floats(files):
    """The reference's own claim, checked once directly: numpy comparison
    semantics (NaN matches only ne, -0.0 == +0.0, subnormals not flushed)."""
    for name in ("f64_specials", "f64_subnormal", "f32_subnormal", "f32"):
        path, values, probes = files[name]
        for probe in probes:
            p = values.dtype.type(probe)
            with np.errstate(invalid="ignore"):
                want = {"lt": values < p, "le": values <= p, "gt": values > p,
                        "ge": values >= p, "eq": values == p, "ne": values != p}
            for op, mask in want.items():
                assert tan.count_where(path, op, probe, device="cpu") == int(mask.sum())


@pytest.mark.parametrize("name", ["u32_sorted", "f64", "i64_walk", "nullable_f64"])
def test_files_without_zone_maps_equal_reference(tmp_path, files, monkeypatch, name):
    """A file written before zone maps existed has no per-chunk stats: every
    chunk decides 'maybe' and is decoded."""
    _, values, probes = files[name]
    monkeypatch.setattr(tfio.zonemaps, "stats_of", lambda *a, **k: None)
    path = str(tmp_path / "old.flt")
    header = tfio.write_file(path, values, chunk_blocks=2)
    assert not any("stats" in c for c in header["chunks"])
    assert_same(tan.scan_column(path, device="cpu"), jan.scan_column(path))
    for op in OPS:
        value = [probes[0]] if op in ("in", "notin") else probes[0]
        assert_same(tan.count_where(path, op, value, device="cpu"),
                    jan.count_where(path, op, value))
        assert_same(tan.scan_where(path, op, value, device="cpu"),
                    jan.scan_where(path, op, value))


def test_one_host_fetch_per_decoded_run(files):
    path, values, _ = files["u32_sorted"]  # one delta run of six full blocks
    before = tan.HOST_FETCHES
    tan.scan_column(path, device="cpu")
    assert tan.HOST_FETCHES - before == 1
    path, values, _ = files["u64_small"]  # ragged: the tail chunk splits off
    before = tan.HOST_FETCHES
    tan.scan_column(path, device="cpu")
    assert tan.HOST_FETCHES - before == 2


def test_zone_maps_resolve_without_decoding(files, monkeypatch):
    """'all' chunks count from the header, 'none' chunks are skipped: a probe
    outside every chunk's range decodes nothing, one inside a single chunk
    decodes that chunk only."""
    decoded = []
    real = tdev._decode_chunks_grouped

    def spy(covering, *args, **kwargs):
        decoded.append(sum(m["n_blocks"] for m, _ in covering))
        return real(covering, *args, **kwargs)

    monkeypatch.setattr(tdev, "_decode_chunks_grouped", spy)
    path, values, _ = files["u32_sorted"]
    fetches = tan.HOST_FETCHES
    assert tan.count_where(path, "lt", int(values.max()) + 1, device="cpu") == values.size
    assert tan.count_where(path, "gt", int(values.max()), device="cpu") == 0
    assert decoded == [] and tan.HOST_FETCHES == fetches
    probe = int(values[2048 + 100])  # inside the second chunk only
    assert tan.count_where(path, "le", probe, device="cpu") == int((values <= probe).sum())
    assert decoded == [2]
    decoded.clear()
    r = tan.scan_where(path, "gt", int(values[5 * 1024]), device="cpu")
    assert r["count"] == int((values > values[5 * 1024]).sum()) and decoded == [2]


def test_scans_refuse_to_run_without_a_gpu(files):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    flt = files["u8"][0]
    for call in (lambda: tan.scan_column(flt), lambda: tan.count_where(flt, "gt", 5),
                 lambda: tan.scan_where(flt, "gt", 5)):
        with pytest.raises(RuntimeError, match="cuda"):
            call()
