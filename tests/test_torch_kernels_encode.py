"""The PyTorch port's encode entries on the CPU (their plain versions) held
against the JAX package, bit for bit (tolerance 0: integer codecs).

pack, delta_pack and for_pack: port == JAX Pallas kernel (interpret mode, as
tests/test_pallas_kernels.py runs it) on a sample of widths, and == JAX ops
== NumPy oracle over every (dtype, width) config. delta_pack_orig against the
JAX package's original-order encode. Inputs are made with numpy from a seed
and handed to the port through convert.py."""

import hashlib
import json
import os

import numpy as np
import pytest
import torch

from fastlanes_tpu.core import layout
from fastlanes_tpu.kernels import pallas_codecs as pk
from fastlanes_tpu.ops import bitpack as jbitpack
from fastlanes_tpu.ops import delta as jdelta
from fastlanes_tpu.ops import ffor as jffor
from fastlanes_tpu.ops import orig as jorig
from fastlanes_tpu.ref import numpy_ref as ref

from fastlanes_tpu_torch import convert
from fastlanes_tpu_torch.kernels import cuda_codecs as ck
from fastlanes_tpu_torch.ops import bitpack as tbitpack
from fastlanes_tpu_torch.ops import delta as tdelta
from fastlanes_tpu_torch.ops import ffor as tffor
from fastlanes_tpu_torch.ops import orig as torig
from fastlanes_tpu_torch.ref import numpy_ref as tref

from conftest import ref_pattern, width_sweep
from test_ops_vs_ref import from_jax_form, to_jax_form

B = 6  # 1.5 Pallas tiles of 4: the reference pads, the port does not
TILE = 4

#: widths where the reference side is the Pallas interpreter (its trace is
#: what these tests cost): both ends, one below each end, one odd width
PALLAS_SAMPLE = [(dt, w) for dt in layout.DTYPES
                 for w in sorted({0, 1, 3, layout.bit_width(dt) - 1, layout.bit_width(dt)})]


def port_in(arr, dt):
    return convert.from_reference(arr, dt, device="cpu")


def port_out(tensor, dt):
    assert tensor.device.type == "cpu"
    return convert.to_reference(tensor, dt)


def jax_out(arr, dt):
    return from_jax_form(arr, dt)


def same(got, want):
    """dtype, shape and bytes."""
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want)


def full_range(rng, dt, n_blocks=B, cols=layout.BLOCK):
    """Values over the whole of [0, 2^T), so about half lie at or above
    2^(T-1): negative in the port's signed view."""
    t = layout.bit_width(dt)
    raw = rng.integers(0, 1 << 63, size=(n_blocks, cols), dtype=np.uint64)
    raw = (raw << np.uint64(1)) | rng.integers(0, 2, size=raw.shape, dtype=np.uint64)
    return (raw >> np.uint64(64 - t)).astype(layout.np_dtype(dt))


@pytest.fixture(autouse=True)
def _no_kernel_launch_on_cpu():
    before = dict(ck.LAUNCHES)
    yield
    assert ck.LAUNCHES == before  # CPU tensors never count as kernel launches


@pytest.mark.parametrize("dt,w", PALLAS_SAMPLE)
def test_pack_matches_pallas(dt, w, rng):
    values = full_range(rng, dt)
    got = port_out(ck.pack(port_in(values, dt), w, dt), dt)
    same(got, ref.pack(values, w, dt))
    same(got, jax_out(pk.pack(to_jax_form(values, dt), w, dt, tile_b=TILE,
                              interpret=True), dt))


@pytest.mark.parametrize("dt,w", PALLAS_SAMPLE)
def test_delta_pack_matches_pallas(dt, w, rng):
    values = full_range(rng, dt)
    bases = full_range(rng, dt, cols=layout.lanes(dt))
    for base in (bases, bases[0]):  # per-block (B, LANES) and shared (LANES,)
        got = port_out(ck.delta_pack(port_in(values, dt), port_in(base, dt), w, dt), dt)
        same(got, ref.delta_pack(values, np.broadcast_to(base, bases.shape), w, dt))
        if base.ndim == 1 and w != 3:
            continue  # one Pallas trace of the shared base per dtype is enough
        same(got, jax_out(pk.delta_pack(to_jax_form(values, dt), to_jax_form(base, dt),
                                        w, dt, tile_b=TILE, interpret=True), dt))


@pytest.mark.parametrize("dt,w", PALLAS_SAMPLE)
def test_for_pack_matches_pallas(dt, w, rng):
    t = layout.bit_width(dt)
    values = full_range(rng, dt)
    for reference in (0, 1, (1 << t) - 1):
        got = port_out(ck.for_pack(port_in(values, dt), reference, w, dt), dt)
        same(got, ref.for_pack(values, reference, w, dt))
    # one Pallas trace per config: the JAX side runs on the last reference,
    # below which almost every value lies (the subtraction wraps)
    same(got, jax_out(pk.for_pack(to_jax_form(values, dt), reference, w, dt,
                                  tile_b=TILE, interpret=True), dt))


@pytest.mark.parametrize("dt,w", width_sweep())
def test_encode_full_sweep(dt, w, rng):
    """All 124 (dtype, width) configs: the port's ops and wrappers against
    the port's own oracle, the JAX package's oracle and its ops."""
    t, nl = layout.bit_width(dt), layout.lanes(dt)
    values = full_range(rng, dt, n_blocks=2)
    bases = full_range(rng, dt, n_blocks=2, cols=nl)
    reference = int(full_range(rng, dt, 1, 1)[0, 0])
    v, b = port_in(values, dt), port_in(bases, dt)
    jv, jb = to_jax_form(values, dt), to_jax_form(bases, dt)

    gold = ref.pack(values, w, dt)
    same(gold, tref.pack(values, w, dt))
    same(port_out(tbitpack.pack(v, w, dt), dt), gold)
    same(port_out(ck.pack(v, w, dt), dt), gold)
    same(jax_out(jbitpack.pack(jv, w, dt), dt), gold)
    same(port_out(ck.pack_map(lambda row: row, v, w, dt), dt), gold)

    gold = ref.delta_pack(values, bases, w, dt)
    same(gold, tref.delta_pack(values, bases, w, dt))
    same(port_out(tdelta.delta_pack(v, b, w, dt), dt), gold)
    same(port_out(ck.delta_pack(v, b, w, dt), dt), gold)
    same(jax_out(jdelta.delta_pack(jv, jb, w, dt), dt), gold)
    # the composition the fused form replaces
    same(port_out(tbitpack.pack(tdelta.delta(v, b, dt), w, dt), dt), gold)

    gold = ref.for_pack(values, reference, w, dt)
    same(gold, tref.for_pack(values, reference, w, dt))
    same(port_out(tffor.for_pack(v, reference, w, dt), dt), gold)
    same(port_out(ck.for_pack(v, reference, w, dt), dt), gold)
    same(jax_out(jffor.for_pack(jv, reference, w, dt), dt), gold)


@pytest.mark.parametrize("dt,w", width_sweep())
def test_pack_golden_sha256(dt, w):
    """The pinned sha256 of the reference crate's test pattern, packed by the
    port's pack entry."""
    with open(os.path.join(os.path.dirname(__file__), "golden_sweep_sha256.json")) as f:
        pins = json.load(f)
    t = layout.bit_width(dt)
    pattern = ref_pattern(dt, w, n_blocks=1)
    packed = port_out(ck.pack(port_in(pattern, dt), w, dt), dt)
    digest = hashlib.sha256(packed[0].astype(f"<u{t // 8}").tobytes()).hexdigest()
    assert digest == pins[f"{dt}_w{w}"]
    same(port_out(ck.unpack(port_in(packed, dt), w, dt), dt), pattern)


@pytest.mark.parametrize("zigzag", [False, True])
@pytest.mark.parametrize("dt", layout.DTYPES)
def test_delta_pack_orig_matches_reference(dt, zigzag, rng):
    """Payload and base of the original-order encode, wrapper and plain op,
    against the JAX package's; and the width probe deltas_orig."""
    t = layout.bit_width(dt)
    steps = rng.integers(-3, 20, size=(3, layout.BLOCK))
    # noisy-sorted, crossing 2^(T-1) (wrapping mod 2^T for the narrow dtypes)
    values = (np.cumsum(steps, axis=1).astype(np.uint64)
              + np.uint64(((1 << (t - 1)) - 2000) % (1 << 64))).astype(layout.np_dtype(dt))
    v, jv = port_in(values, dt), to_jax_form(values, dt)
    same(port_out(torig.deltas_orig(v, dt, zigzag=zigzag), dt),
         jax_out(jorig.deltas_orig(jv, dt, zigzag=zigzag)
                 if dt != "u64" else np.stack(jorig.deltas_orig(jv, dt, zigzag=zigzag), -1),
                 dt))
    for w in (0, 5, t - 1, t):
        jp, jbase = jorig.delta_pack_orig(jv, w, dt, zigzag=zigzag)
        for fn in (ck.delta_pack_orig, torig.delta_pack_orig):
            p, base = fn(v, w, dt, zigzag=zigzag)
            same(port_out(p, dt), jax_out(jp, dt))
            same(port_out(base, dt), jax_out(jbase, dt))
            assert base.is_contiguous()
            assert base.untyped_storage().nbytes() == base.numel() * base.element_size()
    # the compose form of the reference's kernel module, on one width
    jp, jbase = pk.delta_pack_orig(jv, 5, dt, zigzag=zigzag, strategy="compose")
    p, base = ck.delta_pack_orig(v, 5, dt, zigzag=zigzag)
    same(port_out(p, dt), jax_out(jp, dt))
    same(port_out(base, dt), jax_out(jbase, dt))
    # unbatched input keeps its rank
    p1, base1 = ck.delta_pack_orig(v[0], 5, dt, zigzag=zigzag)
    same(port_out(p1, dt), port_out(p, dt)[0])
    same(port_out(base1, dt), port_out(base, dt)[0])


@pytest.mark.parametrize("w", [0, 1, 33, 63, 64])
def test_u64_input_forms(w, rng):
    """uint64 and the (..., 2) uint32 limb image are one buffer to the encode
    wrappers; the result is a native uint64 tensor."""
    values = full_range(rng, "u64")
    bases = full_range(rng, "u64", cols=16)
    image, base_image = to_jax_form(values, "u64"), to_jax_form(bases, "u64")
    gold = ref.delta_pack(values, bases, w, "u64")
    for vform, bform in ((values, bases), (image, base_image)):
        got = ck.delta_pack(torch.from_numpy(vform.copy()), torch.from_numpy(bform.copy()),
                            w, "u64")
        assert got.dtype == torch.uint64
        same(port_out(got, "u64"), gold)
    same(convert.to_reference(got, "u64", form="limbs"),
         np.asarray(pk.delta_pack(image, base_image, w, "u64", tile_b=TILE,
                                  interpret=True)))
    same(port_out(ck.pack(torch.from_numpy(image.copy()), w, "u64"), "u64"),
         ref.pack(values, w, "u64"))
    same(port_out(ck.for_pack(torch.from_numpy(image.copy()), (1 << 64) - 3, w, "u64"), "u64"),
         ref.for_pack(values, (1 << 64) - 3, w, "u64"))


@pytest.mark.parametrize("dt", layout.DTYPES)
def test_width_zero_empty_and_unbatched(dt, rng):
    nl, np_dt = layout.lanes(dt), layout.np_dtype(dt)
    values = full_range(rng, dt, n_blocks=3)
    v = port_in(values, dt)
    base = port_in(full_range(rng, dt, n_blocks=3, cols=nl), dt)
    for got in (ck.pack(v, 0, dt), ck.delta_pack(v, base, 0, dt), ck.for_pack(v, 5, 0, dt)):
        same(port_out(got, dt), np.zeros((3, 0), np_dt))
    empty = port_in(np.zeros((0, layout.BLOCK), np_dt), dt)
    out = ck.pack(empty, 3, dt)
    assert tuple(out.shape) == (0, layout.packed_len(dt, 3)) and out.dtype == empty.dtype
    same(port_out(ck.pack(v[0], 3, dt), dt), ref.pack(values, 3, dt)[0])
    same(port_out(ck.delta_pack(v[0], base[0], 3, dt), dt),
         ref.delta_pack(values[:1], port_out(base, dt)[:1], 3, dt)[0])


def test_for_pack_per_block_reference(rng):
    """The plain op takes one reference per block as a (B,) or (B, 1) array,
    like the JAX op; the kernel wrapper takes the scalar form."""
    values = full_range(rng, "u16")
    refs = full_range(rng, "u16", cols=1)[:, 0]
    gold = np.concatenate([ref.for_pack(values[i:i + 1], int(refs[i]), 7, "u16")
                           for i in range(B)])
    same(port_out(tffor.for_pack(port_in(values, "u16"), port_in(refs, "u16"), 7, "u16"),
                  "u16"), gold)
    same(np.asarray(jffor.for_pack(values, refs, 7, "u16")), gold)
    back = tffor.unfor_pack(port_in(gold, "u16"), port_in(refs[:, None].copy(), "u16"), 7, "u16")
    same(port_out(back, "u16") - refs[:, None], (values - refs[:, None]) & np.uint16(127))
    with pytest.raises(ValueError):
        ck.for_pack(port_in(values, "u16"), port_in(refs, "u16"), 7, "u16")
    with pytest.raises(ValueError):
        tffor.for_pack(port_in(values, "u16"), port_in(refs[:3].copy(), "u16"), 7, "u16")


def test_encode_wrappers_reject_bad_input(rng):
    values = full_range(rng, "u32")
    v = port_in(values, "u32")
    with pytest.raises(ValueError):
        ck.pack(v, 33, "u32")
    with pytest.raises(ValueError):
        ck.pack(v[:, :1000], 5, "u32")
    with pytest.raises(ValueError):
        ck.pack(v.view(torch.int32), 5, "u32")
    with pytest.raises(ValueError):
        ck.pack(v[None], 5, "u32")  # 3-D
    with pytest.raises(ValueError):
        ck.delta_pack(v, port_in(values[:, :5].copy(), "u32"), 5, "u32")
    with pytest.raises(ValueError):
        ck.delta_pack(v, port_in(values[:3, :32].copy(), "u32"), 5, "u32")
    with pytest.raises(TypeError):
        ck.pack(values.tolist(), 5, "u32")
