"""The PyTorch port keeps its own copies of the JAX package's numpy-only
host modules (it imports nothing of that package). These tests pin that each
copy agrees with its original: same tables, same bytes, same answers."""

import numpy as np
import pytest

from fastlanes_tpu import alp as jalp
from fastlanes_tpu import fio_table as jfio_table
from fastlanes_tpu import transforms as jtransforms
from fastlanes_tpu import zonemaps as jzonemaps
from fastlanes_tpu.core import layout as jlayout
from fastlanes_tpu.ref import numpy_ref as jref

from fastlanes_tpu_torch import alp as talp
from fastlanes_tpu_torch import convert
from fastlanes_tpu_torch import fio_table as tfio_table
from fastlanes_tpu_torch import transforms as ttransforms
from fastlanes_tpu_torch import zonemaps as tzonemaps
from fastlanes_tpu_torch.core import layout as tlayout
from fastlanes_tpu_torch.ref import numpy_ref as tref

from conftest import random_values, width_sweep


def same(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want)


def test_layout_constants_and_tables():
    assert tlayout.FL_ORDER == jlayout.FL_ORDER
    assert tlayout.BLOCK == jlayout.BLOCK and tlayout.DTYPES == jlayout.DTYPES
    same(tlayout.transpose_perm(), jlayout.transpose_perm())
    same(tlayout.untranspose_perm(), jlayout.untranspose_perm())
    assert [tlayout.row_offset(r) for r in range(64)] == \
        [jlayout.row_offset(r) for r in range(64)]
    assert [tlayout.transpose_index(i) for i in range(1024)] == \
        [jlayout.transpose_index(i) for i in range(1024)]
    tlayout.validate_layout()


@pytest.mark.parametrize("dt", jlayout.DTYPES)
def test_layout_per_dtype(dt):
    assert tlayout.bit_width(dt) == jlayout.bit_width(dt)
    assert tlayout.lanes(dt) == jlayout.lanes(dt)
    assert tlayout.np_dtype(dt) == jlayout.np_dtype(dt)
    assert tlayout.row_order_by_offset(dt) == jlayout.row_order_by_offset(dt)
    same(tlayout.index_table(dt), jlayout.index_table(dt))
    same(tlayout.lanes_by_index(dt), jlayout.lanes_by_index(dt))
    same(tlayout.rows_by_index(dt), jlayout.rows_by_index(dt))
    t = jlayout.bit_width(dt)
    for w in range(t + 1):
        assert tlayout.packed_len(dt, w) == jlayout.packed_len(dt, w)
        assert tlayout.check_width(dt, w) == jlayout.check_width(dt, w)
    with pytest.raises(ValueError):
        tlayout.check_width(dt, t + 1)
    for spec in (dt, f"uint{t}", np.dtype(f"uint{t}")):
        assert tlayout.canon_dtype(spec) == jlayout.canon_dtype(spec)


@pytest.mark.parametrize("dt,w", width_sweep())
def test_numpy_ref_copy_agrees(dt, w, rng):
    """All 126 configs, B=2: pack / unpack / delta / FoR / transposes."""
    nl = jlayout.lanes(dt)
    t = jlayout.bit_width(dt)
    values = random_values(rng, dt, w, n_blocks=2)
    base = random_values(rng, dt, t, n_blocks=2)[:, :nl]
    packed = jref.pack(values, w, dt)
    same(tref.pack(values, w, dt), packed)
    same(tref.unpack(packed, w, dt), jref.unpack(packed, w, dt))
    idx = np.array([0, 17, 511, 1023])
    same(tref.unpack_single(packed, w, idx, dt), jref.unpack_single(packed, w, idx, dt))
    transposed = jref.transpose(values, dt)
    same(tref.transpose(values, dt), transposed)
    same(tref.untranspose(transposed, dt), values)
    same(tref.delta(transposed, base, dt), jref.delta(transposed, base, dt))
    same(tref.undelta(values, base, dt), jref.undelta(values, base, dt))
    same(tref.delta_pack(values, base, w, dt), jref.delta_pack(values, base, w, dt))
    same(tref.undelta_pack(packed, base, w, dt), jref.undelta_pack(packed, base, w, dt))
    reference = int(rng.integers(0, 1 << min(t, 63)))
    same(tref.for_pack(values, reference, w, dt), jref.for_pack(values, reference, w, dt))
    same(tref.unfor_pack(packed, reference, w, dt), jref.unfor_pack(packed, reference, w, dt))


@pytest.mark.parametrize("bits", [8, 16, 32, 64])
def test_zigzag_copies_and_torch_pair(bits, rng):
    """The numpy pair equals the original's; the torch pair equals the numpy
    pair (the JAX pair has no 64-bit form without x64)."""
    sdt = np.dtype(f"int{bits}")
    info = np.iinfo(sdt)
    signed = np.concatenate([
        rng.integers(info.min, info.max, size=2000, dtype=np.int64, endpoint=True).astype(sdt),
        np.array([0, -1, 1, info.min, info.max, info.min + 1], sdt)])
    codes = jtransforms.zigzag_encode_np(signed)
    same(ttransforms.zigzag_encode_np(signed), codes)
    same(ttransforms.zigzag_decode_np(codes), jtransforms.zigzag_decode_np(codes))
    same(ttransforms.zigzag_decode_np(codes), signed)
    dt = f"u{bits}"
    t_signed = convert.from_reference(signed, dt, device="cpu")
    same(convert.to_reference(ttransforms.zigzag_encode(t_signed), dt), codes)
    t_codes = convert.from_reference(codes, dt, device="cpu")
    same(convert.to_reference(ttransforms.zigzag_decode(t_codes), dt), signed)
    if bits < 64:
        same(np.asarray(jtransforms.zigzag_decode(codes)), signed)
        same(np.asarray(jtransforms.zigzag_encode(signed)), codes)


def _columns(rng):
    ints = rng.integers(-1000, 1000, size=4096)
    return {
        "int": ints.astype(np.uint32) & 0xFFFF,
        "signed": ints.astype(np.int32),
        "f64": np.round(rng.normal(size=4096) * 100, 2),
        "f64_nan": np.where(rng.random(4096) < 0.1, np.nan, rng.normal(size=4096)),
        "f32": rng.normal(size=4096).astype(np.float32),
        "i64": rng.integers(-(1 << 62), 1 << 62, size=4096, dtype=np.int64),
    }


@pytest.mark.parametrize("name", ["int", "signed", "f64", "f64_nan", "f32", "i64"])
def test_zonemaps_copy_agrees(name, rng):
    vals = _columns(rng)[name]
    kind = {"signed": "int", "f64_nan": "f64"}.get(name, name)
    mask = rng.random(vals.size) < 0.2
    for m in (None, mask, np.ones(vals.size, bool)):
        assert tzonemaps.stats_of(vals, m, kind) == jzonemaps.stats_of(vals, m, kind)
    st = jzonemaps.stats_of(vals, None, kind)
    finite = vals[np.isfinite(vals)]
    for op in ("eq", "ne", "lt", "le", "gt", "ge"):
        for probe in (finite.min(), finite.max(), np.median(finite)):
            assert tzonemaps.decide(st, op, probe, kind) == jzonemaps.decide(st, op, probe, kind)
    for cdtype, vtype in (("u32", None), ("u64", None), ("u32", "f32"), ("u64", "f64")):
        assert tzonemaps.kind_of(cdtype, vtype) == jzonemaps.kind_of(cdtype, vtype)


def _same_encoding(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        if isinstance(value, np.ndarray):
            assert got[key].dtype == value.dtype
            assert np.array_equal(got[key], value, equal_nan=value.dtype.kind == "f")
        else:
            assert got[key] == value


@pytest.mark.parametrize("fdt", [np.float32, np.float64])
def test_alp_host_copy_agrees(fdt, rng):
    """The host ALP and ALP_RD codecs that fio.py needs for the whole byte
    format: same encodings, and the decode gives the floats back bit for bit."""
    udt = np.uint32 if fdt == np.float32 else np.uint64
    decimals = np.round(rng.normal(size=(2, 1024)) * 1000, 2).astype(fdt)
    decimals[0, :5] = [np.nan, np.inf, -np.inf, -0.0, 1e30]
    want, got = jalp.encode_np(decimals), talp.encode_np(decimals)
    _same_encoding(got, want)
    back = talp.decode_np(got["ints"], got["e"], got["f"], got["reference"], fdt,
                          got["exc_pos"], got["exc_val"])
    same(back.view(udt), decimals.view(udt))
    noise = rng.normal(size=(2, 1024)).astype(fdt)
    want, got = jalp.rd_encode_np(noise), talp.rd_encode_np(noise)
    _same_encoding(got, want)
    back = talp.rd_decode_np(got["left_idx"], got["rights"], got["dict"],
                             got["right_bits"], fdt, got["exc_pos"], got["exc_left"])
    same(back.view(udt), noise.view(udt))


TABLE_CASES = {
    "ints": lambda rng: {"a": rng.integers(0, 1 << 20, 3000).astype(np.uint32),
                         "b": np.sort(rng.integers(-(1 << 40), 1 << 40, 3000))},
    "floats": lambda rng: {"p": np.round(rng.uniform(0, 100, 2500), 2),
                           "q": rng.standard_normal(2500).astype(np.float32)},
    "strings": lambda rng: {"s": np.array(["x", "yy", "zzz"])[rng.integers(0, 3, 2100)],
                            "n": np.ma.MaskedArray(np.arange(2100, dtype=np.uint16),
                                                   mask=rng.random(2100) < 0.3)},
    "logical": lambda rng: {"t": np.arange(1500).astype("datetime64[s]"),
                            "f": rng.random(1500) < 0.5},
    "empty": lambda rng: {"e": np.zeros(0, np.uint32), "g": np.zeros(0, np.float64)},
}


@pytest.mark.parametrize("chunk_blocks", [1, 2])
@pytest.mark.parametrize("case", sorted(TABLE_CASES))
def test_fio_table_copy_writes_the_same_bytes(tmp_path, rng, case, chunk_blocks):
    """The table container's copy, as the FLT format's above: same header,
    same bytes, and the module constants agree."""
    cols = TABLE_CASES[case](rng)
    pt, pj = str(tmp_path / "port.flt"), str(tmp_path / "ref.flt")
    ht = tfio_table.write_table(pt, cols, chunk_blocks=chunk_blocks)
    hj = jfio_table.write_table(pj, cols, chunk_blocks=chunk_blocks)
    assert ht == hj
    with open(pt, "rb") as ft, open(pj, "rb") as fj:
        assert ft.read() == fj.read()
    assert tfio_table.MAGIC == jfio_table.MAGIC
    assert tfio_table._VERSION == jfio_table._VERSION
    for name in cols:
        got, want = tfio_table.read_column(pj, name), jfio_table.read_column(pt, name)
        assert got.dtype == want.dtype and got.shape == want.shape
        assert np.array_equal(np.ma.getdata(got), np.ma.getdata(want),
                              equal_nan=want.dtype.kind == "f")
