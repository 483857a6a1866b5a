"""Natural-order (transposed-domain) consumption in the port's scans, the
twin of tests/test_natural_scan.py: order-insensitive consumers (reductions,
counts) decode delta-family chunks with the TRANSPOSED-order wrappers
`undelta_pack` / `unzdelta_pack` and run no original-order kernel and no
relayout. Both directions are pinned: every answer is exact (tolerance 0,
and equal to the JAX package's), the original-order wrappers never run when
it is safe to skip them, and they DO run where something positional rides
along (a validity bitmap, a padded tail block, a lockstep walk, a
positional read)."""

import numpy as np
import pytest

from fastlanes_tpu import analytics as jan

from fastlanes_tpu_torch import analytics, fio, fio_device, fio_table
from fastlanes_tpu_torch.kernels import cuda_codecs as ck
from fastlanes_tpu_torch.ops import transpose as transpose_mod

RNG = np.random.default_rng(11)
NATURAL = ("undelta_pack", "unzdelta_pack")
ORIG = ("undelta_pack_orig", "unzdelta_pack_orig", "unpack_orig")


@pytest.fixture
def calls(monkeypatch):
    """Count every wrapper call by name, and every standalone untranspose.
    fio_device calls ck.<name> at run time, so the patch is what it sees."""
    counts = {"untranspose": 0, "natural": 0, "orig": 0}

    def counting(key, real):
        def wrapper(*args, **kwargs):
            counts[key] += 1
            return real(*args, **kwargs)
        return wrapper

    monkeypatch.setattr(transpose_mod, "untranspose",
                        counting("untranspose", transpose_mod.untranspose))
    for key, names in (("natural", NATURAL), ("orig", ORIG)):
        for name in names:
            monkeypatch.setattr(ck, name, counting(key, getattr(ck, name)))
    return counts


def sorted_values(n, dtype=np.uint32, top=1 << 28):
    return np.sort(RNG.integers(0, top, n, np.int64).astype(dtype))


def noisy_walk(n):
    return (np.cumsum(RNG.integers(-3, 4, n)) + 50_000).astype(np.uint32)


def exact(vals):
    return {"sum": int(vals.astype(object).sum()), "min": int(vals.min()),
            "max": int(vals.max()), "count": int(vals.size)}


@pytest.mark.parametrize("codec,make", [("delta", sorted_values), ("zdelta", noisy_walk)])
def test_scan_column_sorted_skips_the_relayout(tmp_path, calls, codec, make):
    vals = make(8 * 1024)  # full blocks: no padded tail
    p = str(tmp_path / "s.flt")
    header = fio.write_file(p, vals, codec=codec, chunk_blocks=2)
    assert {c["codec"] for c in header["chunks"]} == {codec}
    stats = analytics.scan_column(p, device="cpu")
    assert stats == exact(vals) == jan.scan_column(p)
    assert calls["natural"] >= 1 and calls["orig"] == 0 and calls["untranspose"] == 0, calls


def test_auto_codec_of_a_sorted_column_is_delta_family(tmp_path, calls):
    vals = sorted_values(8 * 1024)
    p = str(tmp_path / "s.flt")
    fio.write_file(p, vals, chunk_blocks=2)
    assert fio.read_header(p)["chunks"][0]["codec"] in ("delta", "zdelta")
    assert analytics.scan_column(p, device="cpu") == exact(vals)
    assert calls["natural"] >= 1 and calls["orig"] == 0, calls


def test_count_where_sorted_skips_the_relayout(tmp_path, calls, monkeypatch):
    vals = sorted_values(8 * 1024)
    p = str(tmp_path / "s.flt")
    # no zone maps: every chunk must be decoded, none resolved from the header
    monkeypatch.setattr(fio.zonemaps, "stats_of", lambda *a, **k: None)
    fio.write_file(p, vals, chunk_blocks=2)
    probe = int(vals[3000])
    want = int((vals <= probe).sum())
    assert analytics.count_where(p, "le", probe, device="cpu") == want == \
        jan.count_where(p, "le", probe)
    assert calls["natural"] >= 1 and calls["orig"] == 0 and calls["untranspose"] == 0, calls


def test_scan_where_single_column_sorted(tmp_path, calls):
    vals = sorted_values(8 * 1024)
    p = str(tmp_path / "s.flt")
    fio.write_file(p, vals, chunk_blocks=2)
    probe = int(vals[5000])
    m = vals >= probe
    r = analytics.scan_where(p, "ge", probe, device="cpu")
    assert r == exact(vals[m]) == jan.scan_where(p, "ge", probe)
    assert calls["natural"] >= 1 and calls["orig"] == 0 and calls["untranspose"] == 0, calls


def test_partial_tail_splits_run(tmp_path, calls):
    """A padded tail block forces original order for the TAIL chunk only;
    the bulk still decodes naturally. Stats stay exact."""
    vals = sorted_values(6 * 1024 + 700)  # 7 blocks, last one padded
    p = str(tmp_path / "t.flt")
    fio.write_file(p, vals, codec="delta", chunk_blocks=2)
    assert analytics.scan_column(p, device="cpu") == exact(vals) == jan.scan_column(p)
    # the three full chunks decode naturally (one launch per run of equal
    # width), the padded tail chunk alone takes the positional path
    # (whose plain version on the CPU may compose through untranspose)
    assert calls["natural"] >= 1 and calls["orig"] == 1, calls


def test_single_padded_chunk_keeps_the_positional_path(tmp_path, calls):
    vals = sorted_values(700)
    p = str(tmp_path / "t.flt")
    fio.write_file(p, vals, codec="delta")
    assert analytics.scan_column(p, device="cpu") == exact(vals)
    assert calls["natural"] == 0 and calls["orig"] == 1


def test_nullable_column_keeps_positional_path(tmp_path, calls):
    """Validity bitmaps are positional: natural order must stay OFF."""
    vals = sorted_values(4 * 1024)
    mask = np.zeros(vals.size, bool)
    mask[::7] = True
    p = str(tmp_path / "n.flt")
    fio.write_file(p, np.ma.MaskedArray(vals, mask=mask), codec="delta")
    want = vals[~mask]
    stats = analytics.scan_column(p, device="cpu")
    assert stats == dict(exact(want), n_null=int(mask.sum())) == jan.scan_column(p)
    assert calls["natural"] == 0 and calls["orig"] >= 1


def test_lockstep_walk_keeps_positional_path(tmp_path, calls):
    """A cross-column where aligns rows of two columns: original order."""
    key = sorted_values(4 * 1024, np.uint64, 1 << 40)
    qty = RNG.integers(0, 100, key.size).astype(np.uint32)
    p = str(tmp_path / "t.flt")
    header = fio_table.write_table(p, {"key": key, "qty": qty}, chunk_blocks=2)
    assert header["columns"]["key"]["chunks"][0]["codec"] in ("delta", "zdelta")
    r = analytics.scan_where(p, "lt", 50, column="key", where="qty", device="cpu")
    assert r == exact(key[qty < 50]) == jan.scan_where(p, "lt", 50, column="key", where="qty")
    assert calls["natural"] == 0 and calls["orig"] >= 1
    before = dict(calls)
    assert analytics.scan_column(p, "key", device="cpu") == exact(key)
    assert calls["natural"] > before["natural"] and calls["orig"] == before["orig"]


def test_positional_reads_unchanged(tmp_path, calls):
    """read_file_device still returns exact ORIGINAL order for sorted
    (delta) columns: natural order never leaks into positional reads."""
    vals = sorted_values(4 * 1024)
    p = str(tmp_path / "o.flt")
    fio.write_file(p, vals, chunk_blocks=2)
    got = fio_device.read_file_device(p, device="cpu")
    assert np.array_equal(got.numpy().reshape(-1), vals)
    assert calls["natural"] == 0 and calls["orig"] >= 1


@pytest.mark.parametrize("dtype,top", [(np.uint64, 1 << 45), (np.uint16, 1 << 16),
                                       (np.uint8, 1 << 8)])
def test_scan_matches_ground_truth_other_widths(tmp_path, calls, dtype, top):
    vals = sorted_values(4 * 1024, dtype, top)
    p = str(tmp_path / "w.flt")
    fio.write_file(p, vals, codec="delta")
    assert analytics.scan_column(p, device="cpu") == exact(vals) == jan.scan_column(p)
    assert calls["natural"] >= 1 and calls["orig"] == 0 and calls["untranspose"] == 0, calls


def test_value_counts_and_top_k_sorted_skip_the_relayout(tmp_path, calls):
    """tests/test_natural_scan.py's case: a sorted delta column of whole
    blocks counts and ranks its values in natural order, no relayout."""
    vals = np.sort(RNG.integers(0, 50, 8 * 1024).astype(np.uint32))
    p = str(tmp_path / "v.flt")
    fio.write_file(p, vals, codec="delta", chunk_blocks=2)
    u, c = np.unique(vals, return_counts=True)
    got = analytics.value_counts(p, device="cpu")
    assert got == dict(zip(u.tolist(), c.tolist())) == jan.value_counts(p)
    top = analytics.top_k(p, k=5, device="cpu")
    assert top == np.sort(vals)[-5:][::-1].tolist() == jan.top_k(p, k=5)
    assert calls["natural"] >= 1 and calls["orig"] == 0 and calls["untranspose"] == 0, calls


def test_value_counts_and_top_k_nullable_keep_the_positional_path(tmp_path, calls):
    """The other direction: under a validity bitmap the rows must line up
    with the mask, so the original-order kernel runs and natural order does
    not."""
    vals = np.sort(RNG.integers(0, 50, 4 * 1024).astype(np.uint32))
    mask = np.arange(vals.size) % 5 == 0
    p = str(tmp_path / "n.flt")
    fio.write_file(p, np.ma.MaskedArray(vals, mask=mask), codec="delta")
    u, c = np.unique(vals[~mask], return_counts=True)
    got = analytics.value_counts(p, device="cpu")
    assert got == dict(zip(u.tolist(), c.tolist())) == jan.value_counts(p)
    top = analytics.top_k(p, k=5, largest=False, device="cpu")
    assert top == np.sort(vals[~mask])[:5].tolist() == jan.top_k(p, k=5, largest=False)
    assert calls["natural"] == 0 and calls["orig"] >= 1, calls
