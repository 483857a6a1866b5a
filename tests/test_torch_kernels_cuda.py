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


def test_unaligned_views_are_copied_before_the_launch(card):
    """A (B, 1024) u8 view that starts one byte into its buffer: the
    original-order kernels move 4-byte words, so the wrapper realigns it."""
    raw = torch.arange(3 * 1024 + 1, dtype=torch.int32, device=card).to(torch.uint8)
    values = raw[1:].reshape(3, 1024)
    assert values.data_ptr() % 4 != 0
    packed, base = ck.delta_pack_orig(values, 8, "u8")
    want_p, want_b = ck.delta_pack_orig_plain(values, 8, "u8")
    assert torch.equal(packed, want_p) and torch.equal(base, want_b)
    assert torch.equal(ck.undelta_pack_orig(packed, base, 8, "u8"), values)


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
