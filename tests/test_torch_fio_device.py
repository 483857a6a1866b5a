"""The slice as a whole: device-side FLT reads of the PyTorch port on the
CPU (`device="cpu"`, the plain versions of the kernels) against the JAX
package's device reads on the CPU and against the host reader, bit for bit
(tolerance 0). Files are written by the port's own writer, whose bytes
test_torch_fio.py pins to the reference's."""

import numpy as np
import pytest
import torch

from fastlanes_tpu import fio as jfio
from fastlanes_tpu import fio_device as jdev
from fastlanes_tpu.core import layout

from fastlanes_tpu_torch import convert
from fastlanes_tpu_torch import fio as tfio
from fastlanes_tpu_torch import fio_device as tdev
from fastlanes_tpu_torch.kernels import cuda_codecs as ck

from test_torch_fio import CODECS, SPECIAL, codec_blocks, mixed_blocks, special_columns


def port_np(tensor, dt):
    assert isinstance(tensor, torch.Tensor) and tensor.device.type == "cpu"
    return convert.to_reference(tensor, dt)


def same_as_host(got, host, dt):
    """The port's result has the host reader's dtype, shape and bytes."""
    if isinstance(host, np.ma.MaskedArray):
        assert isinstance(got, tdev.NullableColumn)
        assert got.valid.dtype == torch.bool
        assert np.array_equal(got.valid.numpy(), ~np.ma.getmaskarray(host))
        assert got.n_null == int(np.ma.getmaskarray(host).sum())
        mat = got.materialize()
        assert np.array_equal(np.ma.getmaskarray(mat), np.ma.getmaskarray(host))
        got, host = got.values, host.data
    arr = port_np(got, dt)
    assert arr.dtype == host.dtype and arr.shape == host.shape
    assert np.array_equal(arr, host)


def same_as_reference_device(got, ref, dt):
    """... and the bytes of the JAX package's device read: for u64 that is
    the (..., 2) uint32 limb image of the same bit pattern."""
    if isinstance(ref, jdev.NullableColumn):
        assert np.array_equal(got.valid.numpy(), np.asarray(ref.valid))
        got, ref = got.values, ref.values
    ref = np.asarray(ref)
    arr = convert.to_reference(got, dt, form="limbs" if dt == "u64" else "native")
    assert arr.dtype == ref.dtype and arr.shape == ref.shape
    assert np.array_equal(arr, ref)


def check_file(path, ranges=()):
    dt = tfio.read_header(path)["dtype"]
    before = dict(ck.LAUNCHES)
    got = tdev.read_file_device(path, device="cpu")
    same_as_host(got, tfio.read_file(path), dt)
    same_as_host(got, jfio.read_file(path), dt)
    same_as_reference_device(got, jdev.read_file_device(path), dt)
    for start, stop in ranges:
        part = tdev.read_blocks_device(path, start, stop, device="cpu")
        same_as_host(part, tfio.read_blocks(path, start, stop), dt)
        same_as_reference_device(part, jdev.read_blocks_device(path, start, stop), dt)
    assert ck.LAUNCHES == before  # the CPU path launches no kernel


@pytest.mark.parametrize("codec", CODECS + ("auto",))
@pytest.mark.parametrize("dt", layout.DTYPES)
def test_device_read_matches_reference(tmp_path, rng, dt, codec):
    """Six integer codecs and a mixed-codec file x four dtypes; chunks of 2
    blocks, block ranges that cross chunk boundaries."""
    values = mixed_blocks(rng, dt) if codec == "auto" else codec_blocks(rng, dt, codec)
    path = str(tmp_path / "col.flt")
    header = tfio.write_file(path, values, dtype=dt, codec=codec, chunk_blocks=2)
    if codec != "auto":
        assert {c["codec"] for c in header["chunks"]} == {codec}
    n = values.shape[0]
    check_file(path, ranges=[(1, n - 2), (3, 4)])
    assert np.array_equal(port_np(tdev.read_file_device(path, device="cpu"), dt), values)


@pytest.mark.parametrize("name", SPECIAL)
def test_device_read_special_columns(tmp_path, rng, name):
    """Signed (zigzag and viewu), nullable, ragged and batched-run columns."""
    values, kwargs = special_columns(rng)[name]
    kwargs.setdefault("chunk_blocks", 2)
    path = str(tmp_path / "col.flt")
    header = tfio.write_file(path, values, **kwargs)
    n = header["n_blocks"]
    check_file(path, ranges=[(0, n), (n // 2, n)] if n > 1 else [(0, 1)])


def test_transforms_are_both_covered(tmp_path, rng):
    seen = set()
    for name in SPECIAL:
        values, kwargs = special_columns(rng)[name]
        header = tfio.write_file(str(tmp_path / "c.flt"), values, **kwargs)
        seen.add(header.get("transform"))
    assert {"zigzag", "viewu", None} <= seen


def test_same_signature_chunks_decode_in_one_batch(tmp_path, rng, monkeypatch):
    """A run of equal-(codec, width) chunks is one decode call, as in the
    reference's _decode_chunks_grouped; ffor runs batch too (the port's
    unfor_pack takes one reference per block)."""
    calls = []
    real = tdev._decode_packed_device

    def spy(codec, packed, *args, **kwargs):
        calls.append((codec, packed.shape[0]))
        return real(codec, packed, *args, **kwargs)

    monkeypatch.setattr(tdev, "_decode_packed_device", spy)
    values, kwargs = special_columns(rng)["batched_bitpack"]
    path = str(tmp_path / "col.flt")
    tfio.write_file(path, values, chunk_blocks=2, **kwargs)
    tdev.read_file_device(path, device="cpu")
    assert calls == [("bitpack", 12)]
    calls.clear()
    tdev.read_blocks_device(path, 3, 9, device="cpu")  # chunks 1..4
    assert calls == [("bitpack", 8)]
    calls.clear()
    header = tfio.write_file(path, codec_blocks(rng, "u32", "ffor", 6), codec="ffor",
                             chunk_blocks=2)
    tdev.read_file_device(path, device="cpu")
    widths = [c["width"] for c in header["chunks"]]
    runs = [w for i, w in enumerate(widths) if i == 0 or widths[i - 1] != w]
    assert sum(n for _, n in calls) == 6 and len(calls) == len(runs)


def ffor_chunks(rng, dt, widths, chunk_blocks):
    """Blocks whose chunk i has its own reference and exactly widths[i] bits
    of range above it."""
    t = layout.bit_width(dt)
    chunks = []
    for i, w in enumerate(widths):
        reference = (i * 37 + 5) % (1 << (t - 1)) + (1 << (t - 2))
        block = rng.integers(0, 1 << w, size=(chunk_blocks, layout.BLOCK), dtype=np.uint64)
        block[0, 0], block[0, 1] = 0, (1 << w) - 1
        chunks.append(block + np.uint64(reference))
    return np.concatenate(chunks).astype(layout.np_dtype(dt))


@pytest.mark.parametrize("dt", ["u16", "u32", "u64"])
@pytest.mark.parametrize("widths,n_runs", [((5, 5, 5, 5, 5), 1), ((5, 9, 5, 9, 5, 9), 6),
                                           ((5, 5, 9, 9, 9, 5), 3)],
                         ids=["equal", "alternating", "runs"])
def test_ffor_runs_decode_in_one_call_each(tmp_path, rng, monkeypatch, dt, widths, n_runs):
    """A multi-chunk ffor file whose chunks have different references: whole
    and by a block range that starts and ends inside chunks it equals the
    host reader and the reference's device read, and each run of equal width
    is ONE call of unfor_pack with one reference per block."""
    cb = 3
    values = ffor_chunks(rng, dt, widths, cb)
    path = str(tmp_path / "col.flt")
    header = tfio.write_file(path, values, dtype=dt, codec="ffor", chunk_blocks=cb)
    assert [c["width"] for c in header["chunks"]] == list(widths)
    assert len({c["reference"] for c in header["chunks"]}) == len(widths)
    n = values.shape[0]
    check_file(path, ranges=[(1, n - 1), (cb + 1, 3 * cb - 1), (cb, 2 * cb)])
    calls = []
    real = ck.unfor_pack

    def spy(packed, reference, w, dtype):
        per_block = isinstance(reference, torch.Tensor)
        calls.append((packed.shape[0], w, tuple(reference.shape) if per_block else None))
        return real(packed, reference, w, dtype)

    monkeypatch.setattr(ck, "unfor_pack", spy)
    got = tdev.read_file_device(path, device="cpu")
    assert np.array_equal(port_np(got, dt), values)
    assert len(calls) == n_runs and sum(c[0] for c in calls) == n
    for blocks, _, ref_shape in calls:  # a single chunk keeps its scalar
        assert ref_shape == (None if blocks == cb else (blocks,))
    calls.clear()
    part = tdev.read_blocks_device(path, cb + 1, 3 * cb - 1, device="cpu")  # chunks 1, 2
    assert np.array_equal(port_np(part, dt), values[cb + 1:3 * cb - 1])
    assert len(calls) == (1 if widths[1] == widths[2] else 2)


@pytest.mark.parametrize("dt", ["u8", "u16", "u32", "u64"])
def test_ffor_run_reduces_header_references_like_a_single_chunk(tmp_path, rng, dt):
    """A header reference outside [0, 2^T) (negative, or 2^T too large) is
    reduced mod 2^T in a batched run exactly as in a chunk decoded alone."""
    t, cb = layout.bit_width(dt), 2
    values = ffor_chunks(rng, dt, (5, 5), cb)
    path = str(tmp_path / "col.flt")
    header = tfio.write_file(path, values, dtype=dt, codec="ffor", chunk_blocks=cb)
    assert [c["codec"] for c in header["chunks"]] == ["ffor", "ffor"]
    covering = []
    with open(path, "rb") as f:
        base = tfio._payload_base(path)
        for meta, shift in zip(header["chunks"], (-(1 << t), 1 << t)):
            f.seek(base + meta["offset"])
            covering.append((dict(meta, reference=meta["reference"] + shift),
                             f.read(meta["nbytes"])))
    cpu = torch.device("cpu")
    run = tdev._decode_chunks_grouped(covering, dt, cpu)
    assert len(run) == 1
    assert np.array_equal(port_np(run[0], dt), values)
    alone = [tdev._decode_chunks_grouped([c], dt, cpu)[0] for c in covering]
    assert np.array_equal(port_np(tdev._concat_parts(alone, dt, cpu), dt), values)


def test_natural_order_keeps_the_transposed_image(tmp_path, rng):
    """`natural=True` (order-insensitive consumers) skips the untranspose of
    delta-family chunks; the values are the same multiset per block."""
    values = codec_blocks(rng, "u32", "delta", 4)
    path = str(tmp_path / "col.flt")
    header = tfio.write_file(path, values, codec="delta", chunk_blocks=2)
    with open(path, "rb") as f:
        base = tfio._payload_base(path)
        covering = []
        for meta in header["chunks"]:
            f.seek(base + meta["offset"])
            covering.append((meta, f.read(meta["nbytes"])))
    parts = tdev._decode_chunks_grouped(covering, "u32", torch.device("cpu"), natural=True)
    nat = port_np(tdev._concat_parts(parts, "u32", torch.device("cpu")), "u32")
    from fastlanes_tpu.ref import numpy_ref as ref

    assert np.array_equal(nat, ref.transpose(values, "u32"))


def test_empty_range_and_bad_range(tmp_path, rng):
    values = codec_blocks(rng, "u16", "bitpack", 4)
    path = str(tmp_path / "col.flt")
    tfio.write_file(path, values, chunk_blocks=2)
    got = tdev.read_blocks_device(path, 2, 2, device="cpu")
    assert tuple(got.shape) == (0, 1024) and got.dtype == torch.uint16
    assert np.asarray(jdev.read_blocks_device(path, 2, 2)).shape == (0, 1024)
    assert tuple(tdev.read_blocks_device(path, 3, 99, device="cpu").shape) == (1, 1024)
    with pytest.raises(IndexError):
        tdev.read_blocks_device(path, 3, 2, device="cpu")


@pytest.mark.parametrize("codec", ["alp", "alprd"])
def test_float_chunks_are_not_ported_yet(tmp_path, rng, codec):
    """Float chunks are read on the device now (the test keeps the name it
    had when they raised NotImplementedError, so its history stays in one
    place): no codec is refused, and the read has the bits of the JAX
    package's device read and of the host reader (more in
    test_torch_fio_device_float.py)."""
    values = rng.normal(size=3000).astype(np.float32)
    path = str(tmp_path / "col.flt")
    tfio.write_file(path, values, codec=codec)
    got = tdev.read_file_device(path, device="cpu")
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy().view(np.uint32), values.view(np.uint32))
    want = np.asarray(jdev.read_file_device(path))
    assert want.dtype == np.float32
    assert np.array_equal(got.numpy().view(np.uint32), want.view(np.uint32))
    part = tdev.read_blocks_device(path, 0, 1, device="cpu")
    assert np.array_equal(part.numpy().view(np.uint32).reshape(-1),
                          values[:1024].view(np.uint32))
    assert not hasattr(tdev, "_not_ported")
