"""Float columns (alp, alprd) through the port's device read on the CPU
(`device="cpu"`, the plain versions of the kernels) against the JAX
package's device read on the CPU and against both host readers, bit for bit
(tolerance 0: floats are compared as unsigned bit patterns; the JAX package
returns an f64 column as the (..., 2) uint32 limb image of the same bits)."""

import numpy as np
import pytest
import torch

from fastlanes_tpu import fio as jfio
from fastlanes_tpu import fio_device as jdev

from fastlanes_tpu_torch import fio as tfio
from fastlanes_tpu_torch import fio_device as tdev
from fastlanes_tpu_torch.kernels import cuda_codecs as ck

from test_torch_alp_device import bits_of, wide_left_f64

FDT = {"f32": np.float32, "f64": np.float64}


def float_column(rng, name, fdt, n=5 * 1024 + 300):
    if name == "decimal":
        return np.round(rng.uniform(-3000, 3000, n), 2).astype(fdt)
    if name == "specials":
        v = np.round(rng.uniform(0, 500, n), 1).astype(fdt)
        v[[3, 1500, 2600, 4100, n - 1]] = [np.nan, np.inf, -np.inf, -0.0, np.nan]
        return v
    if name == "late_exceptions":  # none in chunk 0, some in chunks 1 and 2
        v = np.round(rng.uniform(0, 500, n), 2).astype(fdt)
        v[[2048 + 5, 2048 + 1999, 4096 + 7, 4096 + 1025]] = fdt(1) / fdt(3)
        return v
    if name == "blocks":
        return np.round(rng.uniform(0, 90, (6, 1024)), 1).astype(fdt)
    if name == "noise":
        return rng.standard_normal(n).astype(fdt)
    if name == "wide_left":
        return wide_left_f64(rng, n).astype(fdt) if fdt is np.float64 \
            else rng.standard_normal(n).astype(fdt) * fdt(1e20)
    if name == "mixed":  # decimal chunks, then noise chunks: alp then alprd
        return np.concatenate([np.round(rng.uniform(0, 9, 4096), 2),
                               rng.standard_normal(2048 + 300)]).astype(fdt)
    raise ValueError(name)


def same_bits(got, want, fdt):
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    assert got.dtype == (torch.float64 if fdt is np.float64 else torch.float32)
    assert np.array_equal(bits_of(got.numpy(), fdt), bits_of(want, fdt))


@pytest.mark.parametrize("vt", ["f32", "f64"])
@pytest.mark.parametrize("name,codec", [
    ("decimal", "auto"), ("specials", "auto"), ("late_exceptions", "alp"),
    ("blocks", "alp"), ("noise", "auto"), ("noise", "alp"), ("decimal", "alprd"),
    ("wide_left", "alprd"), ("mixed", "auto")])
def test_float_file_reads_match_reference(tmp_path, rng, name, codec, vt):
    fdt = FDT[vt]
    values = float_column(rng, name, fdt)
    path = str(tmp_path / "col.flt")
    header = tfio.write_file(path, values, codec=codec, chunk_blocks=2)
    codecs = {c["codec"] for c in header["chunks"]}
    assert codecs <= {"alp", "alprd"}
    if codec != "auto":
        assert codecs == {codec}
    if name == "mixed":
        assert codecs == {"alp", "alprd"}
    before = dict(ck.LAUNCHES)
    got = tdev.read_file_device(path, device="cpu")
    assert tuple(got.shape) == values.shape
    same_bits(got, values, fdt)
    same_bits(got, tfio.read_file(path), fdt)
    same_bits(got, jfio.read_file(path), fdt)
    same_bits(got, jdev.read_file_device(path), fdt)
    n = header["n_blocks"]
    for start, stop in ((1, n - 1), (2, 3), (3, n)):
        part = tdev.read_blocks_device(path, start, stop, device="cpu")
        assert tuple(part.shape) == (stop - start, 1024)
        same_bits(part, tfio.read_blocks(path, start, stop), fdt)
        same_bits(part, jdev.read_blocks_device(path, start, stop), fdt)
    assert ck.LAUNCHES == before  # the CPU path launches no kernel


@pytest.mark.parametrize("vt", ["f32", "f64"])
def test_alp_run_is_one_unpack_and_offsets_its_exceptions(tmp_path, rng, monkeypatch, vt):
    """Chunks sharing (width, e, f, reference, vtype) decode in ONE unpack;
    the chunk-relative exception positions of chunks 1 and 2 move by their
    block offset. A changed recipe starts a new run."""
    fdt = FDT[vt]
    values = float_column(rng, "late_exceptions", fdt, n=6 * 1024)
    path = str(tmp_path / "col.flt")
    header = tfio.write_file(path, values, codec="alp", chunk_blocks=2)
    sigs = [tdev._group_sig(c) for c in header["chunks"]]
    assert all(s[0] == "alp" for s in sigs)
    runs = 1 + sum(a != b for a, b in zip(sigs, sigs[1:]))
    calls = []
    real = ck.unpack
    monkeypatch.setattr(ck, "unpack", lambda p, w, dt: calls.append(p.shape[0]) or real(p, w, dt))
    got = tdev.read_file_device(path, device="cpu")
    assert len(calls) == runs and sum(calls) == 6
    same_bits(got, values, fdt)
    calls.clear()
    part = tdev.read_blocks_device(path, 3, 5, device="cpu")  # chunks 1 and 2
    assert sum(calls) == 4
    same_bits(part, values.reshape(6, 1024)[3:5], fdt)


@pytest.mark.parametrize("vt", ["f32", "f64"])
def test_merged_alp_run_has_exceptions_in_later_chunks(tmp_path, rng, vt):
    """The merged run of the test above really carries exceptions beyond its
    first chunk (otherwise the offset would never be exercised)."""
    fdt = FDT[vt]
    values = np.round(rng.uniform(1, 2, 6 * 1024), 2).astype(fdt)
    values[[2048 + 5, 4096 + 7]] = fdt(1) / fdt(3)
    path = str(tmp_path / "col.flt")
    header = tfio.write_file(path, values, codec="alp", chunk_blocks=2)
    base = tfio._payload_base(path)
    covering, n_exc = [], []
    with open(path, "rb") as f:
        for meta in header["chunks"]:
            f.seek(base + meta["offset"])
            raw = f.read(meta["nbytes"])
            covering.append((meta, raw))
            n_exc.append(len(tfio._split_alp_payload(meta, raw, meta["n_blocks"],
                                                     header["dtype"], fdt)[1]))
    assert n_exc[0] == 0 and n_exc[1] >= 1 and n_exc[2] >= 1
    if len({tdev._group_sig(m) for m, _ in covering}) == 1:
        parts = tdev._decode_chunks_grouped(covering, header["dtype"], torch.device("cpu"))
        assert len(parts) == 1
        same_bits(parts[0].reshape(-1), values, fdt)
    same_bits(tdev.read_file_device(path, device="cpu"), values, fdt)


@pytest.mark.parametrize("vt", ["f32", "f64"])
def test_empty_float_file_and_range(tmp_path, vt):
    fdt = FDT[vt]
    path = str(tmp_path / "empty.flt")
    tfio.write_file(path, np.zeros(0, fdt))
    got = tdev.read_file_device(path, device="cpu")
    assert got.numel() == 0 and got.dtype == (torch.float64 if vt == "f64" else torch.float32)
    assert tfio.read_file(path).dtype == fdt
    tfio.write_file(path, np.arange(3000, dtype=fdt) / 4)
    part = tdev.read_blocks_device(path, 1, 1, device="cpu")
    assert tuple(part.shape) == (0, 1024) and part.dtype == got.dtype


def test_nullable_float_column(tmp_path, rng):
    values = np.ma.MaskedArray(np.round(rng.uniform(0, 50, 3000), 1),
                               mask=rng.random(3000) < 0.2)
    path = str(tmp_path / "col.flt")
    tfio.write_file(path, values, chunk_blocks=1)
    got = tdev.read_file_device(path, device="cpu")
    ref = jdev.read_file_device(path)
    assert isinstance(got, tdev.NullableColumn) and got.values.dtype == torch.float64
    assert np.array_equal(got.valid.numpy(), np.asarray(ref.valid))
    assert np.array_equal(bits_of(got.values.numpy(), np.float64),
                          bits_of(ref.values, np.float64))
    mat = got.materialize()
    assert np.array_equal(mat.mask, values.mask)
    assert np.array_equal(mat.data[~mat.mask], values.data[~values.mask])
