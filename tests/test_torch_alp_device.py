"""The port's ALP device decoders on the CPU against the JAX package's, bit
for bit (tolerance 0: float results are compared as their unsigned bit
patterns). `decode_device` is ONE IEEE division here and an integer-domain
emulation of that division there; `rd_decode_device` is integer ops on both
sides. The same seeded inputs go through both, over the inputs of
tests/test_alp.py and the sweep of tests/test_alp_f64_device.py, and
`ALPCodec` goes both ways through convert.encoded_from_reference."""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastlanes_tpu import alp as jalp
from fastlanes_tpu.models import codecs as jcodecs

from fastlanes_tpu_torch import alp as talp
from fastlanes_tpu_torch import convert
from fastlanes_tpu_torch.models import codecs as tcodecs

UINT = {np.float32: np.uint32, np.float64: np.uint64}
MAX_D = {np.float32: 10, np.float64: 18}


def bits_of(arr, fdt):
    """A float result of either package as its flat unsigned bit pattern: a
    float array, or the (..., 2) uint32 limb image of float64 bits."""
    arr = np.ascontiguousarray(np.asarray(arr))
    if arr.dtype == np.uint32 and fdt is np.float64:
        return arr.view(np.uint64).reshape(-1)
    assert arr.dtype == fdt
    return arr.view(UINT[fdt]).reshape(-1)


def reference_form(shifted, fdt):
    """The unpacked payload as the JAX package's decoder takes it: uint32,
    or the (..., 2) uint32 limb image of a uint64 payload."""
    if fdt is np.float64:
        shifted = np.ascontiguousarray(shifted)
        return jnp.asarray(shifted.view(np.uint32).reshape(*shifted.shape, 2))
    return jnp.asarray(shifted)


def both_decode(ints, d, fdt, exc_pos=None, exc_val=None):
    """ints / 10^d through numpy, the JAX device decoder and the port's."""
    reference = int(ints.min())
    shifted = (ints - reference).astype(UINT[fdt])
    want = talp.decode_np(shifted, d, 0, reference, fdt, exc_pos, exc_val)
    ref = jalp.decode_device(reference_form(shifted, fdt), d, 0, reference, fdt,
                             exc_pos, exc_val)
    got = talp.decode_device(torch.from_numpy(shifted), d, 0, reference, fdt,
                             exc_pos, exc_val)
    assert got.dtype == (torch.float64 if fdt is np.float64 else torch.float32)
    assert tuple(got.shape) == shifted.shape
    assert np.array_equal(bits_of(got.numpy(), fdt), bits_of(want, fdt))
    assert np.array_equal(bits_of(got.numpy(), fdt), bits_of(ref, fdt))


def in_range_ints(rng, d, fdt, n):
    """Random ints over the encoder's range for exponent d, all magnitudes."""
    if fdt is np.float32:
        bound, top = (1 << 24) - 1, 24  # |i * 10^f| < 2^24, f = 0 here
    else:
        bound, top = 1 << 52, 53
    mag = rng.integers(0, top, n)
    i = rng.integers(0, 1 << 62, n, dtype=np.int64) >> (62 - mag)
    i = np.clip(i, 0, bound) * (rng.integers(0, 2, n, dtype=np.int64) * 2 - 1)
    corners = [0, 1, -1, bound, -bound, 3, 7]
    for k in range(1, top):
        corners += [(1 << k) - 1, (1 << k) + 1, -(1 << k)]
    five = 5 ** d
    corners += [five * m + s for m in (1, 2, 3, 977) for s in (-1, 0, 1)]
    corners = np.array([c for c in corners if abs(c) <= bound], np.int64)
    return np.concatenate([i, corners])


@pytest.mark.parametrize("fdt,d", [(f, d) for f in (np.float32, np.float64)
                                   for d in range(MAX_D[f] + 1)],
                         ids=lambda v: v.__name__ if isinstance(v, type) else str(v))
def test_division_is_the_reference_division(rng, fdt, d):
    both_decode(in_range_ints(rng, d, fdt, 3000), d, fdt)


@pytest.mark.parametrize("d", [0, 1, 2, 5, 9, 13, 18])
def test_division_near_halfway_f64(rng, d):
    """i built so that i / 5^d sits close to a rounding boundary."""
    five = 5 ** d
    k = int(five).bit_length()
    m = rng.integers(1 << 52, 1 << 53, 1500, dtype=np.int64)
    cand = np.asarray([(int(mm) * five) >> (k + 1) for mm in m], dtype=np.int64)
    ints = np.unique(np.concatenate(
        [np.clip(cand + delta, -(2 ** 52), 2 ** 52) for delta in (-2, -1, 0, 1, 2)]))
    both_decode(ints, d, np.float64)


def decimal_data(rng, fdt, digits=2, n=4096, scale=1000):
    ints = rng.integers(-scale * 10 ** digits, scale * 10 ** digits, size=n)
    return (ints / 10 ** digits).astype(fdt)


CASES = ("decimal", "specials", "mantissas", "two_d", "negative_reference")


def case_values(rng, name, fdt):
    if name == "decimal":
        return decimal_data(rng, fdt)
    if name == "specials":
        v = decimal_data(rng, fdt, n=2048)
        v[7], v[100], v[200], v[300] = np.nan, np.inf, -np.inf, -0.0
        return v
    if name == "mantissas":  # not decimal: nearly every value an exception
        return rng.standard_normal(1024).astype(fdt)
    if name == "two_d":
        return decimal_data(rng, fdt, digits=3).reshape(4, 1024)
    return -np.abs(decimal_data(rng, fdt, digits=1)) - fdt(1e4)


@pytest.mark.parametrize("fdt", [np.float32, np.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("name", CASES)
def test_decode_device_matches_reference(rng, name, fdt):
    values = case_values(rng, name, fdt)
    enc = talp.encode_np(values)
    args = (enc["e"], enc["f"], enc["reference"], fdt, enc["exc_pos"], enc["exc_val"])
    got = talp.decode_device(torch.from_numpy(enc["ints"]), *args)
    assert tuple(got.shape) == values.shape
    assert np.array_equal(bits_of(got.numpy(), fdt), bits_of(values, fdt))
    ref = jalp.decode_device(reference_form(enc["ints"], fdt), *args)
    assert np.array_equal(bits_of(got.numpy(), fdt), bits_of(ref, fdt))
    # the signed tensor with the same bits is the same payload
    signed = torch.from_numpy(enc["ints"]).view(
        torch.int64 if fdt is np.float64 else torch.int32)
    again = talp.decode_device(signed, *args)
    assert np.array_equal(bits_of(again.numpy(), fdt), bits_of(values, fdt))


def test_decode_device_rejects_a_payload_of_the_wrong_width():
    with pytest.raises(ValueError, match="64-bit"):
        talp.decode_device(torch.zeros(4, dtype=torch.int32), 2, 0, 0, np.float64)
    with pytest.raises(ValueError, match="32-bit"):
        talp.decode_device(torch.zeros(4, dtype=torch.float32), 2, 0, 0, np.float32)


def wide_left_f64(rng, n=4096):
    """Doubles whose top 32 bits cluster: the cut lands at right_bits=32
    and rare wide lefts ride the exception lane."""
    common = np.asarray([0x3FF00000 + k * 0x111 for k in range(8)], np.uint64)
    rare = np.asarray([0x40100000 + k * 0x7 for k in range(4)], np.uint64)
    hi = common[rng.integers(0, len(common), n)]
    hi[rng.choice(n, 16, replace=False)] = rare[rng.integers(0, len(rare), 16)]
    bits = (hi << np.uint64(32)) | rng.integers(0, 1 << 32, n, np.int64).astype(np.uint64)
    return bits.view(np.float64)


def rd_values(rng, name, fdt):
    if name == "normal":
        return (rng.standard_normal(2048) * 1e6).astype(fdt)
    if name == "two_d":
        return rng.standard_normal((3, 1024)).astype(fdt)
    if name == "wide_left":
        if fdt is np.float64:
            return wide_left_f64(rng)
        base = rng.integers(0, 1 << 16, 2048).astype(np.uint32) << np.uint32(7)
        return (base | rng.integers(0, 1 << 7, 2048).astype(np.uint32)).view(np.float32)
    v = rng.standard_normal(2048).astype(fdt)  # many distinct lefts: exceptions
    v[::5] *= fdt(1e30) if fdt is np.float32 else fdt(1e200)
    v[3], v[11] = np.nan, -np.inf
    return v


@pytest.mark.parametrize("fdt", [np.float32, np.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("name", ["normal", "two_d", "wide_left", "exceptions"])
def test_rd_decode_device_matches_reference(rng, name, fdt):
    values = rd_values(rng, name, fdt)
    enc = talp.rd_encode_np(values)
    if name == "exceptions":
        assert len(enc["exc_pos"])
    got = talp.rd_decode_device(
        torch.from_numpy(enc["left_idx"]), torch.from_numpy(enc["rights"]),
        enc["dict"], enc["right_bits"], fdt, enc["exc_pos"], enc["exc_left"])
    assert got.dtype == (torch.float64 if fdt is np.float64 else torch.float32)
    assert tuple(got.shape) == values.shape
    assert np.array_equal(bits_of(got.numpy(), fdt), bits_of(values, fdt))
    ref = jalp.rd_decode_device(
        jnp.asarray(enc["left_idx"]), reference_form(enc["rights"], fdt), enc["dict"],
        enc["right_bits"], fdt, enc["exc_pos"], enc["exc_left"])
    assert np.array_equal(bits_of(got.numpy(), fdt), bits_of(ref, fdt))


def test_rd_decode_device_f64_needs_the_cut_above_32_bits():
    idx = torch.zeros(4, dtype=torch.uint16)
    rights = torch.zeros(4, dtype=torch.uint64)
    for decode, args in ((talp.rd_decode_device, (idx, rights)),
                         (jalp.rd_decode_device, (jnp.zeros(4, jnp.uint16),
                                                  jnp.zeros((4, 2), jnp.uint32)))):
        with pytest.raises(ValueError, match="right_bits >= 32"):
            decode(*args, np.zeros(1, np.uint32), 31, np.float64)


def codec_values(rng, vtype, one_block=False):
    fdt = np.float32 if vtype == "f32" else np.float64
    values = decimal_data(rng, fdt, n=4 * 1024).reshape(4, 1024)
    values[2, 17] = fdt(1.0) / 3  # exceptions
    values[3, 0], values[0, 5] = np.nan, -0.0
    return (values[1].copy() if one_block else values), fdt


@pytest.mark.parametrize("one_block", [False, True], ids=["batch", "block"])
@pytest.mark.parametrize("vtype", ["f32", "f64"])
def test_alp_codec_round_trip_and_registry(rng, vtype, one_block):
    values, fdt = codec_values(rng, vtype, one_block)
    codec = tcodecs.get_codec("alp", vtype)
    assert type(codec) is tcodecs.ALPCodec
    enc = codec.encode(values, device="cpu")
    assert enc.codec == "alp" and enc.dtype == ("u32" if vtype == "f32" else "u64")
    assert enc.packed_bytes < values.nbytes
    assert enc.n_blocks == (1 if one_block else 4)
    out = codec.decode(enc)
    assert out.device.type == "cpu" and tuple(out.shape) == values.shape
    assert np.array_equal(bits_of(out.numpy(), fdt), bits_of(values, fdt))
    with pytest.raises(ValueError, match="f32"):
        tcodecs.ALPCodec("u32")
    with pytest.raises(ValueError, match="float"):
        codec.encode(values.astype(np.float32 if vtype == "f64" else np.float64),
                     device="cpu")
    with pytest.raises(ValueError, match="1024"):
        codec.encode(values.reshape(-1)[:100], device="cpu")


def test_alp_codec_f32_crosses_packages(rng):
    """What either package encoded, the other decodes to the same bits, and
    the two encodings are the same bytes."""
    values, fdt = codec_values(rng, "f32")
    jenc = jcodecs.ALPCodec("f32").encode(values)
    tenc = tcodecs.ALPCodec("f32").encode(values, device="cpu")
    carried = convert.encoded_from_reference(
        types.SimpleNamespace(codec=jenc.codec, dtype=jenc.dtype, width=jenc.width,
                              n_blocks=jenc.n_blocks, payload=np.asarray(jenc.payload),
                              params=jenc.params), device="cpu")
    assert carried.width == tenc.width and carried.n_blocks == tenc.n_blocks
    assert torch.equal(carried.payload, tenc.payload)
    for key in ("e", "f", "reference", "vtype"):
        assert carried.params[key] == tenc.params[key]
    assert tuple(carried.params["shape"]) == tuple(tenc.params["shape"])
    for key in ("exc_pos", "exc_val"):
        assert isinstance(carried.params[key], np.ndarray)
        assert np.array_equal(carried.params[key].view(np.uint32),
                              tenc.params[key].view(np.uint32))
    out = tcodecs.ALPCodec("f32").decode(carried)
    assert np.array_equal(bits_of(out.numpy(), fdt), bits_of(values, fdt))
    back = jcodecs.Encoded(**convert.encoded_to_reference(tenc))
    ref = np.asarray(jcodecs.ALPCodec("f32").decode(back))
    assert np.array_equal(bits_of(ref, fdt), bits_of(values, fdt))


def test_alp_codec_f64_crosses_packages(rng):
    """An f64 column rides a u64 payload: the JAX package packs and carries
    it as the (..., 2) uint32 limb image, the port as uint64; the bytes are
    the same, and the port decodes what the JAX package encoded."""
    values, fdt = codec_values(rng, "f64")
    jenc = jcodecs.ALPCodec("f64").encode(values)
    payload = np.asarray(jenc.payload)
    assert payload.dtype == np.uint32 and payload.shape[-1] == 2
    tenc = tcodecs.ALPCodec("f64").encode(values, device="cpu")
    carried = convert.encoded_from_reference(
        types.SimpleNamespace(codec=jenc.codec, dtype=jenc.dtype, width=jenc.width,
                              n_blocks=jenc.n_blocks, payload=payload,
                              params=jenc.params), device="cpu")
    assert carried.payload.dtype == torch.uint64
    assert torch.equal(carried.payload.view(torch.int64), tenc.payload.view(torch.int64))
    out = tcodecs.ALPCodec("f64").decode(carried)
    assert out.dtype == torch.float64
    assert np.array_equal(bits_of(out.numpy(), fdt), bits_of(values, fdt))
    fields = convert.encoded_to_reference(tenc, form="limbs")
    assert np.array_equal(fields["payload"], payload)
    assert fields["params"]["exc_pos"] is tenc.params["exc_pos"]


def test_nothing_on_the_path_is_built_with_fast_math():
    """`decode_device` is one IEEE division only while no build flag relaxes
    it, and while the divisor is a tensor: torch's CUDA kernel for a Python
    scalar divisor multiplies by the reciprocal (checked on the card by
    chip_smoke.py's division proof)."""
    import inspect

    from fastlanes_tpu_torch.kernels import build

    assert not any("fast" in flag for flag in build.NVCC_FLAGS)
    source = inspect.getsource(talp.decode_device)
    assert "/ pow10" in source and "torch.tensor(" in source
