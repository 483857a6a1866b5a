"""The PyTorch port's CUDA kernels on the card, against their plain PyTorch
versions and the NumPy oracle, bit for bit: every (dtype, width) config.

These tests need an NVIDIA GPU and nvcc; they skip elsewhere. Run them on a
GPU machine with

    python -m pytest tests/test_torch_kernels_cuda.py -q

(add --noconftest where JAX is not installed: this file uses nothing of
conftest.py and imports nothing of the JAX package)."""

import numpy as np
import pytest
import torch

from fastlanes_tpu_torch import fio, fio_device
from fastlanes_tpu_torch.core import layout
from fastlanes_tpu_torch.kernels import cuda_codecs as ck
from fastlanes_tpu_torch.ref import numpy_ref as ref

pytestmark = pytest.mark.cuda

CONFIGS = [(dt, w) for dt in layout.DTYPES for w in range(layout.bit_width(dt) + 1)]
B = 67  # not a multiple of the FastLanes blocks one CUDA block holds


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU form")
    return torch.device("cuda")


def signed(t):
    return t.view({1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()])


@pytest.mark.parametrize("dt,w", CONFIGS)
def test_kernels_match_plain_and_oracle(card, dt, w):
    rng = np.random.default_rng(1000 * layout.bit_width(dt) + w)
    t, nl, np_dt = layout.bit_width(dt), layout.lanes(dt), layout.np_dtype(dt)
    words = rng.integers(0, 1 << min(t, 63), size=(B, layout.packed_len(dt, w)),
                         dtype=np.uint64).astype(np_dt)
    bases = rng.integers(0, 1 << min(t, 63), size=(B, nl), dtype=np.uint64).astype(np_dt)
    packed, base = torch.from_numpy(words).to(card), torch.from_numpy(bases).to(card)
    reference = int(rng.integers(0, 1 << min(t, 63)))
    before = dict(ck.LAUNCHES)
    cases = [
        ("unpack", (packed,), ref.unpack(words, w, dt)),
        ("unfor_pack", (packed, reference), ref.unfor_pack(words, reference, w, dt)),
        ("undelta_pack", (packed, base), ref.undelta_pack(words, bases, w, dt)),
        ("undelta_pack", (packed, base[0].clone()),
         ref.undelta_pack(words, np.broadcast_to(bases[0], bases.shape), w, dt)),
        ("unzdelta_pack", (packed, base), None),
        ("unzdelta_pack", (packed, base[0].clone()), None),
    ]
    for name, args, gold in cases:
        got = getattr(ck, name)(*args, w, dt)
        want = getattr(ck, name + "_plain")(*args, w, dt)
        torch.cuda.synchronize()
        assert got.is_cuda and got.dtype == want.dtype
        assert torch.equal(signed(got), signed(want)), (name, dt, w)
        if gold is not None:
            assert np.array_equal(got.cpu().numpy(), gold), (name, dt, w)
    assert ck.LAUNCHES["unpack"] == before["unpack"] + 1
    assert ck.LAUNCHES["unfor_pack"] == before["unfor_pack"] + 1
    assert ck.LAUNCHES["undelta_pack"] == before["undelta_pack"] + 2
    assert ck.LAUNCHES["unzdelta_pack"] == before["unzdelta_pack"] + 2


@pytest.mark.parametrize("dt,w", CONFIGS)
def test_encode_kernels_match_plain_and_oracle(card, dt, w):
    """pack, delta_pack (per-block and shared base) and for_pack: values at
    and above 2^(T-1), references at both ends."""
    rng = np.random.default_rng(2000 * layout.bit_width(dt) + w)
    t, nl, np_dt = layout.bit_width(dt), layout.lanes(dt), layout.np_dtype(dt)
    vals = rng.integers(0, 1 << min(t, 63), size=(B, layout.BLOCK), dtype=np.uint64)
    vals = (vals << np.uint64(t - min(t, 63)) | rng.integers(0, 2, size=vals.shape,
                                                             dtype=np.uint64)).astype(np_dt)
    bases = rng.integers(0, 1 << min(t, 63), size=(B, nl), dtype=np.uint64).astype(np_dt)
    values, base = torch.from_numpy(vals).to(card), torch.from_numpy(bases).to(card)
    before = dict(ck.LAUNCHES)
    cases = [
        ("pack", (values,), ref.pack(vals, w, dt)),
        ("delta_pack", (values, base), ref.delta_pack(vals, bases, w, dt)),
        ("delta_pack", (values, base[0].clone()),
         ref.delta_pack(vals, np.broadcast_to(bases[0], bases.shape), w, dt)),
        ("for_pack", (values, 0), ref.for_pack(vals, 0, w, dt)),
        ("for_pack", (values, (1 << t) - 1), ref.for_pack(vals, (1 << t) - 1, w, dt)),
    ]
    for name, args, gold in cases:
        got = getattr(ck, name)(*args, w, dt)
        want = getattr(ck, name + "_plain")(*args, w, dt)
        torch.cuda.synchronize()
        assert got.is_cuda and got.dtype == want.dtype and got.shape == want.shape
        assert torch.equal(signed(got), signed(want)), (name, dt, w)
        assert np.array_equal(got.cpu().numpy(), gold), (name, dt, w)
    launched = 0 if w == 0 else 1  # W=0 has no output words: no launch
    assert ck.LAUNCHES["pack"] == before["pack"] + launched
    assert ck.LAUNCHES["delta_pack"] == before["delta_pack"] + 2 * launched
    assert ck.LAUNCHES["for_pack"] == before["for_pack"] + 2 * launched


@pytest.mark.parametrize("dt,w", CONFIGS)
def test_orig_kernels_match_plain_and_oracle(card, dt, w):
    """The three original-order decode kernels and unfor_pack / for_pack
    with one reference per block."""
    rng = np.random.default_rng(3000 * layout.bit_width(dt) + w)
    t, nl, np_dt = layout.bit_width(dt), layout.lanes(dt), layout.np_dtype(dt)
    words = rng.integers(0, 1 << min(t, 63), size=(B, layout.packed_len(dt, w)),
                         dtype=np.uint64).astype(np_dt)
    bases = rng.integers(0, 1 << min(t, 63), size=(B, nl), dtype=np.uint64).astype(np_dt)
    vals = rng.integers(0, 1 << min(t, 63), size=(B, layout.BLOCK), dtype=np.uint64)
    vals = (vals << np.uint64(t - min(t, 63)) | vals & np.uint64(1)).astype(np_dt)
    refs = rng.integers(0, 1 << min(t, 63), size=B, dtype=np.uint64)
    refs[::2] = (1 << t) - 1
    refs[1] = 0
    refs = refs.astype(np_dt)
    packed, base = torch.from_numpy(words).to(card), torch.from_numpy(bases).to(card)
    values, ref_t = torch.from_numpy(vals).to(card), torch.from_numpy(refs).to(card)
    shared = np.broadcast_to(bases[0], bases.shape)
    before = dict(ck.LAUNCHES)
    cases = [
        ("unpack_orig", (packed,), ref.untranspose(ref.unpack(words, w, dt), dt)),
        ("undelta_pack_orig", (packed, base),
         ref.untranspose(ref.undelta_pack(words, bases, w, dt), dt)),
        ("undelta_pack_orig", (packed, base[0].clone()),
         ref.untranspose(ref.undelta_pack(words, shared, w, dt), dt)),
        ("unzdelta_pack_orig", (packed, base), None),
        ("unzdelta_pack_orig", (packed, base[0].clone()), None),
        ("unfor_pack", (packed, ref_t), np.stack(
            [ref.unfor_pack(words[b:b + 1], int(refs[b]), w, dt)[0] for b in range(B)])),
        ("for_pack", (values, ref_t), np.stack(
            [ref.for_pack(vals[b:b + 1], int(refs[b]), w, dt)[0] for b in range(B)])),
    ]
    for name, args, gold in cases:
        got = getattr(ck, name)(*args, w, dt)
        want = getattr(ck, name + "_plain")(*args, w, dt)
        torch.cuda.synchronize()
        assert got.is_cuda and got.dtype == want.dtype and got.shape == want.shape
        assert torch.equal(signed(got), signed(want)), (name, dt, w)
        if gold is not None:
            assert np.array_equal(got.cpu().numpy(), gold), (name, dt, w)
    assert ck.LAUNCHES["unpack_orig"] == before["unpack_orig"] + 1
    assert ck.LAUNCHES["undelta_pack_orig"] == before["undelta_pack_orig"] + 2
    assert ck.LAUNCHES["unzdelta_pack_orig"] == before["unzdelta_pack_orig"] + 2
    assert ck.LAUNCHES["unfor_pack"] == before["unfor_pack"] + 1
    assert ck.LAUNCHES["for_pack"] == before["for_pack"] + (0 if w == 0 else 1)
    # the transposed-order kernels and the gather were not part of it
    assert all(ck.LAUNCHES[k] == before[k] for k in ("unpack", "undelta_pack",
                                                     "unzdelta_pack", "pack", "delta_pack"))


ORIG_EDGES = [(dt, w, n) for dt, nb in ck.ORIG_DECODE_BLOCKS_PER_CTA.items()
              for w in (0, 1, layout.bit_width(dt) - 1, layout.bit_width(dt))
              for n in sorted({1, nb - 1, nb + 1, 2 * nb + 1})]


@pytest.mark.parametrize("dt,w,n_blocks", ORIG_EDGES)
def test_orig_decode_edges_on_the_card(card, dt, w, n_blocks):
    """The u32/u64 original-order decode at the edges of its grid: one
    block, a ragged group of NB - 1 or NB + 1 blocks, 2 * NB + 1; words and
    bases over all T bits; a per-block and a shared base."""
    rng = np.random.default_rng(5000 * layout.bit_width(dt) + 100 * w + n_blocks)
    t, nl, np_dt = layout.bit_width(dt), layout.lanes(dt), layout.np_dtype(dt)
    words = rng.integers(0, 1 << t, size=(n_blocks, layout.packed_len(dt, w)),
                         dtype=np.uint64).astype(np_dt)
    bases = rng.integers(0, 1 << t, size=(n_blocks, nl), dtype=np.uint64).astype(np_dt)
    packed, base = torch.from_numpy(words).to(card), torch.from_numpy(bases).to(card)
    for name, args in (("unpack_orig", (packed,)), ("undelta_pack_orig", (packed, base)),
                       ("undelta_pack_orig", (packed, base[-1].clone())),
                       ("unzdelta_pack_orig", (packed, base)),
                       ("unzdelta_pack_orig", (packed, base[-1].clone()))):
        got = getattr(ck, name)(*args, w, dt)
        want = getattr(ck, name + "_plain")(*(a.cpu() for a in args), w, dt)
        torch.cuda.synchronize()
        assert torch.equal(signed(got.cpu()), signed(want)), (name, dt, w, n_blocks)


@pytest.mark.parametrize("zigzag", [False, True], ids=["plain", "zigzag"])
@pytest.mark.parametrize("dt,w", CONFIGS)
def test_delta_pack_orig_on_the_card(card, dt, w, zigzag):
    """(packed, base) in ONE launch, W=0 included (it still makes the base),
    against the plain version and the NumPy oracle; then decoded again."""
    rng = np.random.default_rng(4000 * layout.bit_width(dt) + w)
    t, nl, np_dt = layout.bit_width(dt), layout.lanes(dt), layout.np_dtype(dt)
    vals = rng.integers(0, 1 << min(t, 63), size=(B, layout.BLOCK), dtype=np.uint64)
    vals = (vals << np.uint64(t - min(t, 63)) | vals & np.uint64(1)).astype(np_dt)
    values = torch.from_numpy(vals).to(card)
    before = dict(ck.LAUNCHES)
    packed, base = ck.delta_pack_orig(values, w, dt, zigzag=zigzag)
    want_p, want_b = ck.delta_pack_orig_plain(values, w, dt, zigzag=zigzag)
    torch.cuda.synchronize()
    assert ck.LAUNCHES["delta_pack_orig"] == before["delta_pack_orig"] + 1
    assert all(ck.LAUNCHES[k] == before[k] for k in before if k != "delta_pack_orig")
    assert packed.shape == want_p.shape and torch.equal(signed(packed), signed(want_p))
    assert base.shape == want_b.shape and torch.equal(signed(base), signed(want_b))
    assert base.is_contiguous() and base.untyped_storage().nbytes() == base.nbytes
    tr = ref.transpose(vals, dt)
    assert np.array_equal(base.cpu().numpy(), tr[:, :nl])
    if w == t:  # lossless: the fused decode gives the values back
        decode = ck.unzdelta_pack_orig if zigzag else ck.undelta_pack_orig
        assert torch.equal(signed(decode(packed, base, w, dt)), signed(values))


def unaligned_view(arr, offset, card):
    """`arr` on the card as a view that starts `offset` elements into its
    buffer, so that its address is not a multiple of 4 bytes."""
    flat = torch.from_numpy(np.ascontiguousarray(arr).reshape(-1)).to(card)
    buf = torch.empty(flat.numel() + offset, dtype=flat.dtype, device=card)
    buf[offset:] = flat
    view = buf[offset:].view(arr.shape)
    assert view.data_ptr() % 4 != 0
    return view


UNALIGNED = pytest.mark.parametrize("dt,offset", [("u8", 1), ("u8", 2), ("u8", 3), ("u16", 1)],
                                    ids=["u8-1B", "u8-2B", "u8-3B", "u16-2B"])


@UNALIGNED
def test_unaligned_views_are_copied_before_the_launch(card, dt, offset):
    """Values, a (B, LANES) or (LANES,) base and per-block references that
    start `offset` elements (1-3 bytes) into their buffers: u8/u16 encode
    threads read values and base as 32-bit words (in original order as 8-
    or 16-byte loads), so the wrapper realigns them before the launch."""
    rng = np.random.default_rng(6000 + 10 * layout.bit_width(dt) + offset)
    t, nl, np_dt = layout.bit_width(dt), layout.lanes(dt), layout.np_dtype(dt)
    w = t // 2 + 1
    vals = rng.integers(0, 1 << t, size=(B, layout.BLOCK), dtype=np.uint64).astype(np_dt)
    bases = rng.integers(0, 1 << t, size=(B, nl), dtype=np.uint64).astype(np_dt)
    refs = rng.integers(0, 1 << t, size=B, dtype=np.uint64).astype(np_dt)
    values, base = unaligned_view(vals, offset, card), unaligned_view(bases, offset, card)
    shared, ref_t = unaligned_view(bases[0], offset, card), unaligned_view(refs, offset, card)
    before = dict(ck.LAUNCHES)
    cases = [
        ("pack", (values,), ref.pack(vals, w, dt)),
        ("delta_pack", (values, base), ref.delta_pack(vals, bases, w, dt)),
        ("delta_pack", (values, shared),
         ref.delta_pack(vals, np.broadcast_to(bases[0], bases.shape), w, dt)),
        ("for_pack", (values, ref_t), np.stack(
            [ref.for_pack(vals[b:b + 1], int(refs[b]), w, dt)[0] for b in range(B)])),
    ]
    for name, args, gold in cases:
        got = getattr(ck, name)(*args, w, dt)
        want = getattr(ck, name + "_plain")(*args, w, dt)
        torch.cuda.synchronize()
        assert torch.equal(signed(got), signed(want)), (name, tuple(args[-1].shape))
        assert np.array_equal(got.cpu().numpy(), gold), (name, tuple(args[-1].shape))
    packed, made = ck.delta_pack_orig(values, t, dt)
    want_p, want_b = ck.delta_pack_orig_plain(values, t, dt)
    assert torch.equal(signed(packed), signed(want_p)) and torch.equal(signed(made), signed(want_b))
    assert torch.equal(signed(ck.undelta_pack_orig(packed, made, t, dt)), signed(values))
    assert ck.LAUNCHES["pack"] == before["pack"] + 1
    assert ck.LAUNCHES["delta_pack"] == before["delta_pack"] + 2
    assert ck.LAUNCHES["for_pack"] == before["for_pack"] + 1
    assert ck.LAUNCHES["delta_pack_orig"] == before["delta_pack_orig"] + 1


@UNALIGNED
def test_unaligned_base_and_packed_views(card, dt, offset):
    """Packed words and a (B, LANES) or (LANES,) base that start `offset`
    elements (1-3 bytes) into their buffers: u8/u16 decode threads read both
    as 32-bit words, so the wrapper realigns both before the launch."""
    rng = np.random.default_rng(5000 + 10 * layout.bit_width(dt) + offset)
    t, nl, np_dt = layout.bit_width(dt), layout.lanes(dt), layout.np_dtype(dt)
    w = t // 2 + 1
    words = rng.integers(0, 1 << t, size=(B, layout.packed_len(dt, w)),
                         dtype=np.uint64).astype(np_dt)
    bases = rng.integers(0, 1 << t, size=(B, nl), dtype=np.uint64).astype(np_dt)
    packed, base = unaligned_view(words, offset, card), unaligned_view(bases, offset, card)
    shared = unaligned_view(bases[0], offset, card)
    before = dict(ck.LAUNCHES)
    for name, seeds, gold_base in (("undelta_pack", base, bases),
                                   ("undelta_pack_orig", base, bases),
                                   ("undelta_pack", shared, np.broadcast_to(bases[0], bases.shape)),
                                   ("undelta_pack_orig", shared,
                                    np.broadcast_to(bases[0], bases.shape))):
        got = getattr(ck, name)(packed, seeds, w, dt)
        want = getattr(ck, name + "_plain")(packed, seeds, w, dt)
        torch.cuda.synchronize()
        assert torch.equal(signed(got), signed(want)), (name, tuple(seeds.shape))
        gold = ref.undelta_pack(words, gold_base, w, dt)
        if name.endswith("_orig"):
            gold = ref.untranspose(gold, dt)
        assert np.array_equal(got.cpu().numpy(), gold), (name, tuple(seeds.shape))
    assert ck.LAUNCHES["undelta_pack"] == before["undelta_pack"] + 2
    assert ck.LAUNCHES["undelta_pack_orig"] == before["undelta_pack_orig"] + 2


@pytest.mark.parametrize("w", [3, 5, 7])
def test_u8_pack_straddling_rows(card, w):
    """u8 pack at B ragged blocks and widths whose rows straddle two packed
    words (shift + W > 8), with every value bit set somewhere: a row's bits
    above W, or above what fits in the word in flight, must not reach the
    lane above in the thread's 32-bit word."""
    rng = np.random.default_rng(7000 + w)
    vals = rng.integers(0, 256, size=(B, layout.BLOCK), dtype=np.uint8)
    vals[0] = 255
    values = torch.from_numpy(vals).to(card)
    before = ck.LAUNCHES["pack"]
    got = ck.pack(values, w, "u8")
    want = ck.pack_plain(values, w, "u8")
    torch.cuda.synchronize()
    assert ck.LAUNCHES["pack"] == before + 1
    assert torch.equal(got, want)
    assert np.array_equal(got.cpu().numpy(), ref.pack(vals, w, "u8"))
    assert np.array_equal(ck.unpack(got, w, "u8").cpu().numpy(), vals & np.uint8((1 << w) - 1))


def test_public_names_launch_the_kernels(card):
    import fastlanes_tpu_torch as ft

    values = torch.arange(2048, dtype=torch.int32, device=card).view(torch.uint32) \
        .reshape(2, 1024)
    before = dict(ck.LAUNCHES)
    packed = ft.pack(values, 11, "u32")
    back = ft.unpack(packed, 11, "u32")
    assert torch.equal(signed(back), signed(values))
    assert ck.LAUNCHES["pack"] == before["pack"] + 1
    assert ck.LAUNCHES["unpack"] == before["unpack"] + 1
    # the original-order names: one kernel each, and no gather beside it
    from fastlanes_tpu_torch.ops import transpose as ops_transpose

    def no_gather(*args, **kwargs):
        raise AssertionError("an original-order entry went through ops.transpose")

    real = ops_transpose._apply
    ops_transpose._apply = no_gather
    try:
        dpacked, base = ft.delta_pack_orig(values, 1, "u32")
        zpacked, zbase = ft.delta_pack_orig(values, 2, "u32", zigzag=True)
        outs = [ft.undelta_pack_orig(dpacked, base, 1, "u32"),
                ft.unzdelta_pack_orig(zpacked, zbase, 2, "u32"),
                ft.unpack_orig(ft.pack(values, 11, "u32"), 11, "u32")]
        torch.cuda.synchronize()
    finally:
        ops_transpose._apply = real
    assert all(torch.equal(signed(out), signed(values)) for out in outs[:2])
    assert torch.equal(signed(outs[2]), signed(ops_transpose.untranspose(values, "u32")))
    assert ck.LAUNCHES["delta_pack_orig"] == before["delta_pack_orig"] + 2
    for name in ("undelta_pack_orig", "unzdelta_pack_orig", "unpack_orig"):
        assert ck.LAUNCHES[name] == before[name] + 1, name
    for name in ("undelta_pack", "unzdelta_pack", "delta_pack"):
        assert ck.LAUNCHES[name] == before[name], name


def test_cuda_wrapper_rejects_mixed_devices(card):
    packed = torch.zeros((2, 96), dtype=torch.uint32, device=card)
    with pytest.raises(ValueError):
        ck.undelta_pack(packed, torch.zeros(32, dtype=torch.uint32), 3, "u32")
    with pytest.raises(ValueError):
        ck.undelta_pack_orig(packed, torch.zeros(32, dtype=torch.uint32), 3, "u32")
    with pytest.raises(ValueError, match="reference lies on"):
        ck.unfor_pack(packed, torch.zeros(2, dtype=torch.uint32), 3, "u32")
    with pytest.raises(ValueError, match="per-block reference"):
        ck.unfor_pack(packed, torch.zeros(3, dtype=torch.uint32, device=card), 3, "u32")


def test_ffor_chunks_read_in_one_launch_per_run(card, tmp_path):
    rng = np.random.default_rng(11)
    chunks = [rng.integers(0, 1 << 7, size=(4, 1024), dtype=np.uint32) + np.uint32(1000 * i)
              for i in range(5)]
    for c in chunks:
        c[0, 0], c[0, 1] = c.min() - c.min() % 1000, c.min() - c.min() % 1000 + 127
    values = np.concatenate(chunks)
    path = str(tmp_path / "ffor.flt")
    header = fio.write_file(path, values, codec="ffor", chunk_blocks=4)
    assert {c["width"] for c in header["chunks"]} == {7}
    before = ck.LAUNCHES["unfor_pack"]
    got = fio_device.read_file_device(path)
    assert ck.LAUNCHES["unfor_pack"] == before + 1
    assert np.array_equal(got.cpu().numpy(), values)


def test_default_device_read(card, tmp_path):
    rng = np.random.default_rng(7)
    values = np.sort(rng.integers(0, 1 << 30, size=50_000, dtype=np.uint32))
    path = str(tmp_path / "col.flt")
    fio.write_file(path, values, chunk_blocks=8)
    got = fio_device.read_file_device(path)
    assert got.is_cuda and np.array_equal(got.cpu().numpy(), fio.read_file(path))


# -- float columns, tables, many files and the scans, on the card ------------


def float_bits(arr):
    return np.ascontiguousarray(arr).view(f"uint{arr.dtype.itemsize * 8}")


@pytest.mark.parametrize("np_float,d", [(np.float32, d) for d in range(11)]
                         + [(np.float64, d) for d in range(19)],
                         ids=lambda v: getattr(v, "__name__", str(v)))
def test_alp_division_on_the_card_is_the_host_division(card, np_float, d):
    """decode_device is one IEEE division; its bits equal decode_np's."""
    from fastlanes_tpu_torch import alp

    rng = np.random.default_rng(100 + d)
    bound, top = ((1 << 24) - 1, 24) if np_float is np.float32 else (1 << 52, 53)
    mag = rng.integers(0, top, 200_000)
    ints = np.clip(rng.integers(0, 1 << 62, mag.size, dtype=np.int64) >> (62 - mag), 0, bound)
    ints *= rng.integers(0, 2, mag.size, dtype=np.int64) * 2 - 1
    reference = int(ints.min())
    shifted = (ints - reference).astype(np.uint32 if np_float is np.float32 else np.uint64)
    got = alp.decode_device(torch.from_numpy(shifted).to(card), d, 0, reference, np_float)
    want = alp.decode_np(shifted, d, 0, reference, np_float)
    assert got.is_cuda
    assert np.array_equal(float_bits(got.cpu().numpy()), float_bits(want))


@pytest.mark.parametrize("np_float", [np.float32, np.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("codec", ["alp", "alprd"])
def test_float_files_read_on_the_card(card, tmp_path, np_float, codec):
    rng = np.random.default_rng(3)
    values = (np.round(rng.uniform(-900, 900, 9000), 2) if codec == "alp"
              else rng.standard_normal(9000)).astype(np_float)
    values[[5, 3000, 8000]] = [np.nan, -0.0, np.inf]
    path = str(tmp_path / "col.flt")
    fio.write_file(path, values, codec=codec, chunk_blocks=2)
    before = ck.LAUNCHES["unpack"]
    got = fio_device.read_file_device(path)
    assert got.is_cuda and ck.LAUNCHES["unpack"] > before
    assert np.array_equal(float_bits(got.cpu().numpy()), float_bits(values))
    part = fio_device.read_blocks_device(path, 1, 6)
    assert np.array_equal(float_bits(part.cpu().numpy()),
                          float_bits(fio.read_blocks(path, 1, 6)))


@pytest.mark.parametrize("vtype", ["f32", "f64"])
def test_alp_codec_on_the_card(card, vtype):
    from fastlanes_tpu_torch.models import codecs

    rng = np.random.default_rng(5)
    values = np.round(rng.uniform(0, 500, (6, 1024)), 2).astype(
        np.float32 if vtype == "f32" else np.float64)
    values[1, 1], values[4, 9] = np.nan, 1 / 3
    codec = codecs.get_codec("alp", vtype)
    before = dict(ck.LAUNCHES)
    enc = codec.encode(values)
    out = codec.decode(enc)
    assert enc.payload.is_cuda and out.is_cuda
    assert ck.LAUNCHES["pack"] == before["pack"] + 1
    assert ck.LAUNCHES["unpack"] == before["unpack"] + 1
    assert np.array_equal(float_bits(out.cpu().numpy()), float_bits(values))


def small_table(rng, n=5 * 1024 + 77):
    return {
        "key": np.sort(rng.integers(0, 1 << 44, n).astype(np.uint64)),
        "day": (np.datetime64("2021-03-01") + rng.integers(0, 700, n)).astype("datetime64[D]"),
        "change": rng.integers(-40, 40, n).astype(np.int32),
        "qty": (rng.integers(0, 500, n) + 70_000).astype(np.uint32),
        "cur": np.array(["EUR", "GBP", "JPY", "USD"])[rng.integers(0, 4, n)],
        "price": np.round(rng.uniform(0, 5000, n), 2),
        "ratio": np.round(rng.uniform(-1, 1, n), 3).astype(np.float32),
        "visits": np.ma.MaskedArray(np.cumsum(rng.integers(0, 9, n)).astype(np.uint32),
                                    mask=rng.random(n) < 0.2),
    }


def test_table_columns_and_files_read_on_the_card(card, tmp_path):
    from fastlanes_tpu_torch import fio_table

    rng = np.random.default_rng(9)
    cols = small_table(rng)
    path = str(tmp_path / "t.flt")
    fio_table.write_table(path, cols, chunk_blocks=2)
    for name in cols:
        got = fio_device.read_column_device(path, name)
        host = fio_table.read_column(path, name)
        if isinstance(got, fio_device.NullableColumn):
            assert np.array_equal(got.valid.cpu().numpy(), ~host.mask)
            got, host = got.values, host.data
        arr = got.materialize() if isinstance(got, fio_table.StringColumn) else got.cpu().numpy()
        if host.dtype.kind in "mM":
            host = host.view(np.int64)
        assert arr.dtype == host.dtype and arr.tobytes() == host.tobytes(), name
    paths = []
    for i in range(5):
        p = str(tmp_path / f"s{i}.flt")
        fio.write_file(p, rng.integers(1 << 8, 1 << 9, (4, 1024), dtype=np.uint32),
                       codec="bitpack", chunk_blocks=2)
        paths.append(p)
    before = ck.LAUNCHES["unpack"]
    got = fio_device.read_files_device(paths)
    assert ck.LAUNCHES["unpack"] == before + 1  # one launch for all five files
    for p in paths:
        assert got[p].is_cuda and np.array_equal(got[p].cpu().numpy(), fio.read_file(p))
    for p, tensor in fio_device.iter_files_device(paths):
        assert np.array_equal(tensor.cpu().numpy(), fio.read_file(p))


def test_scans_on_the_card_equal_the_cpu_path(card, tmp_path):
    """Every scan entry on the card returns what `device="cpu"` returns
    (which the CPU tests hold equal to the JAX package's), and the sorted
    column scans through the natural-order kernel."""
    from fastlanes_tpu_torch import analytics, fio_table

    rng = np.random.default_rng(13)
    cols = small_table(rng, 8 * 1024)
    path = str(tmp_path / "t.flt")
    fio_table.write_table(path, cols, chunk_blocks=2)

    def both(fn):
        a, b = fn(None), fn("cpu")
        assert repr(a) == repr(b), (a, b)  # repr: NaN-safe, type- and sign-strict
        return a

    both(lambda dev: analytics.scan_table(path, device=dev))
    before = dict(ck.LAUNCHES)
    both(lambda dev: analytics.scan_column(path, "key", device=dev))
    assert ck.LAUNCHES["undelta_pack"] > before["undelta_pack"]
    assert ck.LAUNCHES["undelta_pack_orig"] == before["undelta_pack_orig"]
    before = dict(ck.LAUNCHES)
    both(lambda dev: analytics.scan_column(path, "visits", device=dev))  # nullable
    assert ck.LAUNCHES["undelta_pack"] == before["undelta_pack"]
    assert ck.LAUNCHES["undelta_pack_orig"] > before["undelta_pack_orig"]
    probes = {"key": 1 << 43, "day": np.datetime64("2022-01-01"), "change": -3,
              "qty": 70_250, "cur": "GBP", "price": 2500.25, "ratio": 0.125, "visits": 900}
    for name, probe in probes.items():
        for op in ("lt", "le", "gt", "ge", "eq", "ne", "in", "notin"):
            value = [probe] if op in ("in", "notin") else probe
            both(lambda dev: analytics.count_where(path, op, value, column=name, device=dev))
            both(lambda dev: analytics.scan_where(path, op, value, column=name, device=dev))
        both(lambda dev: analytics.scan_where(path, "ge", probe, column="price", where=name,
                                              device=dev))


def test_aggregations_on_the_card_equal_the_cpu_path(card, tmp_path):
    """group_stats, scan_where_multi, value_counts, top_k and quantile on the
    card return what `device="cpu"` returns (which the CPU tests hold equal
    to the JAX package's), on a mid-size table: several lockstep windows,
    few groups (the spread accumulator) and many."""
    from fastlanes_tpu_torch import analytics, fio_table

    rng = np.random.default_rng(17)
    n = 200 * 1024 + 333
    cols = small_table(rng, n)
    cols["store"] = rng.integers(0, 1000, n).astype(np.uint16)
    cols["amount"] = rng.integers(-(1 << 50), 1 << 50, n, dtype=np.int64)
    cols["units"] = rng.integers(0, 200, n).astype(np.uint8)
    cols["price"][rng.integers(0, n, 40)] = np.nan
    cols["price"][cols["store"] == 7] = -0.0
    path = str(tmp_path / "agg.flt")
    fio_table.write_table(path, cols, chunk_blocks=8)

    def both(fn):
        a, b = fn(None), fn("cpu")
        assert repr(a) == repr(b), (a, b)  # repr: NaN-safe, type- and sign-strict
        return a

    for key, value in (("cur", "price"), ("cur", "qty"), ("cur", "ratio"), ("cur", "visits"),
                       ("cur", "cur"), ("store", "price"), ("store", "amount"),
                       ("units", "key"), ("change", "qty")):
        if key == "change":
            with pytest.raises(ValueError):
                analytics.group_stats(path, key, value)
            continue
        both(lambda dev: analytics.group_stats(path, key, value, device=dev))
    both(lambda dev: analytics.group_stats(path, "cur", "price", device=dev,
                                           preds=[("qty", "ge", 70_250)]))
    both(lambda dev: analytics.scan_where_multi(
        path, [("cur", "eq", "EUR"), ("qty", "ge", 70_100),
               ("day", "ge", np.datetime64("2022-01-01"))], column="price", device=dev))
    for column in ("cur", "units", "change", "store"):
        both(lambda dev: analytics.value_counts(path, column, device=dev))
    for column in ("price", "key", "ratio", "amount", "visits", "cur"):
        for largest in (True, False):
            both(lambda dev: analytics.top_k(path, column, k=20, largest=largest, device=dev))
    both(lambda dev: analytics.quantile(path, "qty", [0.01, 0.5, 0.99], device=dev))
    both(lambda dev: analytics.median(path, "ratio", device=dev))
    both(lambda dev: analytics.quantile(path, "amount", 0.9, device=dev))


def same_rows(got, want):
    """select / join results equal (types, dtypes, masks, and bit for bit
    wherever no mask hides a value)."""
    assert list(got) == list(want)
    for name, w in want.items():
        g = got[name]
        assert type(g) is type(w) and g.dtype == w.dtype and g.shape == w.shape, name
        present = ~np.ma.getmaskarray(w)
        assert np.array_equal(np.ma.getmaskarray(g), ~present), name
        gd, wd = np.ma.getdata(g)[present], np.ma.getdata(w)[present]
        if wd.dtype.kind == "f":
            gd, wd = gd.view(f"u{wd.itemsize}"), wd.view(f"u{wd.itemsize}")
        assert np.array_equal(gd, wd), name


def test_select_and_join_on_the_card_equal_the_cpu_path(card, tmp_path):
    """select (plain, LIMIT, ORDER BY with and without LIMIT, heavy ties at
    32 and 64 bits, a two-file dataset) and join (integer and string keys,
    inner and left) on the card give the CPU path's rows exactly."""
    from fastlanes_tpu_torch import analytics, fio_table

    rng = np.random.default_rng(19)
    n = 200 * 1024 + 333
    cols = small_table(rng, n)
    cols["store"] = rng.integers(0, 40, n).astype(np.uint16)
    cols["tick"] = rng.integers(0, 5, n).astype(np.int64)  # 64-bit ties
    cols["price"][rng.integers(0, n, 40)] = np.nan
    path = str(tmp_path / "rows.flt")
    fio_table.write_table(path, cols, chunk_blocks=8)
    halves = [str(tmp_path / f"half{i}.flt") for i in range(2)]
    for p, rows in zip(halves, (slice(0, n // 2), slice(n // 2, None))):
        fio_table.write_table(p, {k: v[rows] for k, v in cols.items()}, chunk_blocks=8)
    dim = str(tmp_path / "dim.flt")
    fio_table.write_table(dim, {"store": np.arange(0, 40, 2, dtype=np.uint16)[::-1].copy(),
                                "name": np.array([f"s{i}" for i in range(20)])})
    curs = str(tmp_path / "curs.flt")
    fio_table.write_table(curs, {"cur": np.array(["EUR", "JPY", "ZAR"]),
                                 "rate": np.array([1.0, 0.006, 0.05])})

    def both(fn):
        same_rows(fn(None), fn("cpu"))

    for kw in ({"preds": [("cur", "eq", "EUR"), ("qty", "ge", 70_100)]},
               {"columns": ["key", "visits"], "preds": [("qty", "lt", 70_300)], "limit": 5000},
               {"columns": ["price", "key"], "order_by": "price", "desc": True, "limit": 100},
               {"columns": ["store", "key"], "order_by": "store", "limit": 3000},
               {"columns": ["tick", "key"], "order_by": "tick", "desc": True, "limit": 3000},
               {"columns": ["visits", "day"], "order_by": "visits", "limit": 700,
                "preds": [("cur", "ne", "JPY")]},
               {"columns": ["qty", "cur"], "order_by": "qty",
                "preds": [("store", "eq", 3)]}):
        both(lambda dev: analytics.select(path, device=dev, **kw))
        both(lambda dev: analytics.select(halves, device=dev, **kw))
    both(lambda dev: analytics.join(path, dim, "store", columns=["key", "store"], device=dev))
    both(lambda dev: analytics.join(path, dim, "store", how="left", limit=9000, device=dev,
                                    preds=[("qty", "gt", 70_500)]))
    both(lambda dev: analytics.join(halves, curs, "cur", how="left", columns=["key"],
                                    device=dev))


def test_warmup_launches_each_kernel_once_per_entry(card):
    """kernels.warmup on the card: the library loads, and each requested
    (kernel, dtype, width) is one launch of that kernel."""
    ck.reset_launches()
    count = ck.warmup(ops=tuple(ck.LAUNCHES), n_blocks=257)
    n_widths = sum(layout.bit_width(dt) for dt in layout.DTYPES)
    assert count == len(ck.LAUNCHES) * n_widths
    assert ck.LAUNCHES == {name: n_widths for name in ck.LAUNCHES}
    assert ck.LAUNCHES_BY_DTYPE == {(name, dt): layout.bit_width(dt)
                                    for name in ck.LAUNCHES for dt in layout.DTYPES}


def group_values(rng, kind, n, one_bin):
    """A value column of `kind` for the group accumulator: integers over
    their whole range; floats with NaN, +-inf, -0.0 and subnormals, or (one
    bin) decimals that share one exponent bucket."""
    if kind in ("u8", "i32", "u32", "i64"):
        dt = {"u8": np.uint8, "i32": np.int32, "u32": np.uint32, "i64": np.int64}[kind]
        info = np.iinfo(dt)
        return rng.integers(info.min, info.max, n, dtype=dt, endpoint=True)
    dt = np.float32 if kind == "f32" else np.float64
    if one_bin:
        return np.round(rng.uniform(1024.0, 2047.99, n), 2).astype(dt)
    vals = np.round(rng.uniform(-1e5, 1e5, n), 2).astype(dt)
    at = rng.choice(n, 64, replace=False)
    tiny = np.finfo(dt).smallest_subnormal
    vals[at] = np.array([np.nan, np.inf, -np.inf, -0.0, 0.0, tiny, -tiny, 3 * tiny] * 8, dt)
    vals[rng.integers(0, n, 500)] = rng.integers(-9, 9, 500) * tiny
    return vals


GROUP_VALUE_COLS = {"u8": 2, "i32": 2, "u32": 2, "i64": 3, "f32": 68, "f64": 1028}
GROUP_CASES = [(kind, side, masked, False) for kind in GROUP_VALUE_COLS
               for side in ("few", "shared_limit", "past_limit") for masked in (False, True)]
GROUP_CASES += [(kind, "few", True, True) for kind in ("f32", "f64")]


@pytest.mark.parametrize("kind,side,masked,one_bin", GROUP_CASES,
                         ids=[f"{c[0]}-{c[1]}-{'mask' if c[2] else 'nomask'}"
                              f"{'-one_bin' if c[3] else ''}" for c in GROUP_CASES])
def test_group_accumulator_kernel_equals_the_plain_version(card, kind, side, masked, one_bin):
    """The group accumulator's kernel (kernels/cuda_group.py) and its plain
    version (_GroupAcc.feed_plain) fed the same two windows on the card
    fetch equal state, bit for bit: every value kind, with and without a
    mask, negative keys and keys >= k, `valid` short of the tensor and not
    a multiple of the block, and k on both sides of the shared-memory limit."""
    from fastlanes_tpu_torch import analytics
    from fastlanes_tpu_torch.kernels import cuda_group

    cols = GROUP_VALUE_COLS[kind]
    limit = cuda_group.shared_bytes(card) // ((cols + 2) * 8) - 1  # the largest shared k
    k = {"few": 3, "shared_limit": limit, "past_limit": limit + 1}[side]
    assert cuda_group.fits_shared(limit, cols, cuda_group.shared_bytes(card))
    assert not cuda_group.fits_shared(limit + 1, cols, cuda_group.shared_bytes(card))
    rng = np.random.default_rng(4000 + GROUP_CASES.index((kind, side, masked, one_bin)))
    n = 200_003
    valid = n - 77
    # signed keys (int8, int16, int32) reach below 0 and past k; u8 keys are
    # a flipped int8 and an offset of 128
    if side == "few":
        keys = (rng.integers(0, k + 3, n).astype(np.uint8) if masked
                else rng.integers(-6, k + 3, n).astype(np.int8))
    else:
        keys = rng.integers(-5, k + 5, n).astype(np.int16 if side == "shared_limit" else np.int32)
    flat_k = analytics._flatten_logical(torch.from_numpy(keys).to(card), None, None)
    flat_v = analytics._flatten_logical(
        torch.from_numpy(group_values(rng, kind, n, one_bin)).to(card), None, None)
    mask = torch.from_numpy(rng.random(n) < 0.7).to(card) if masked else None
    gk = analytics._GroupAcc(k, flat_v, card)
    gp = analytics._GroupAcc(k, flat_v, card, plain=True)
    assert gk.mode == ("global" if side == "past_limit" else "shared")
    assert gp.mode == "plain"
    launches, shared = cuda_group.LAUNCHES, cuda_group.SHARED_LAUNCHES
    for acc in (gk, gp):
        acc.feed(flat_k, flat_v, valid, mask)
        acc.feed(flat_k, flat_v, valid // 3, None)
    torch.cuda.synchronize()
    assert cuda_group.LAUNCHES == launches + 2
    assert cuda_group.SHARED_LAUNCHES == shared + (0 if side == "past_limit" else 2)
    (kind_k, off_k, parts_k), (kind_p, off_p, parts_p) = gk.host_state(), gp.host_state()
    assert (kind_k, off_k, len(parts_k)) == (kind_p, off_p, len(parts_p)) == (kind_p, off_p, 1)
    for got, want in zip(parts_k[0], parts_p[0]):
        assert got.dtype == want.dtype and np.array_equal(got, want), (kind, side, masked)
