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


@pytest.mark.parametrize("dt", layout.DTYPES)
def test_delta_pack_orig_on_the_card(card, dt):
    from fastlanes_tpu_torch.ops import orig as ops_orig

    rng = np.random.default_rng(31)
    t, np_dt = layout.bit_width(dt), layout.np_dtype(dt)
    vals = np.sort(rng.integers(0, 1 << (t - 1), size=(B, layout.BLOCK),
                                dtype=np.uint64).astype(np_dt), axis=1)
    values = torch.from_numpy(vals).to(card)
    for zigzag in (False, True):
        for w in (0, t // 2, t):
            packed, base = ck.delta_pack_orig(values, w, dt, zigzag=zigzag)
            want_p, want_b = ops_orig.delta_pack_orig(values, w, dt, zigzag=zigzag)
            assert torch.equal(signed(packed), signed(want_p))
            assert torch.equal(signed(base), signed(want_b))
            assert base.is_contiguous() and base.untyped_storage().nbytes() == base.nbytes


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


def test_cuda_wrapper_rejects_mixed_devices(card):
    packed = torch.zeros((2, 96), dtype=torch.uint32, device=card)
    with pytest.raises(ValueError):
        ck.undelta_pack(packed, torch.zeros(32, dtype=torch.uint32), 3, "u32")


def test_default_device_read(card, tmp_path):
    rng = np.random.default_rng(7)
    values = np.sort(rng.integers(0, 1 << 30, size=50_000, dtype=np.uint32))
    path = str(tmp_path / "col.flt")
    fio.write_file(path, values, chunk_blocks=8)
    got = fio_device.read_file_device(path)
    assert got.is_cuda and np.array_equal(got.cpu().numpy(), fio.read_file(path))
