"""The PyTorch port's codec classes (models/codecs.py) on the CPU held against
the JAX package's, bit for bit (tolerance 0): the same values through both
give the same codec, width, payload bytes and params; each package decodes
what the other encoded (through convert.py); the cost model and the codec
that auto_encode picks agree."""

import numpy as np
import pytest
import torch

from fastlanes_tpu.core import layout
from fastlanes_tpu.models import codecs as jcodecs

from fastlanes_tpu_torch import convert
from fastlanes_tpu_torch.kernels import cuda_codecs as ck
from fastlanes_tpu_torch.models import codecs as tcodecs

from conftest import random_values
from test_ops_vs_ref import from_jax_form, to_jax_form

B = 3
CODECS = ("bitpack", "ffor", "delta", "zdelta", "rle", "dict")


def np_u(x, dt):
    return np.asarray(x).astype(layout.np_dtype(dt))


def data_for(name, dt, rng):
    """(B, 1024) values that suit codec `name`, with values at and above
    2^(T-1) (negative in the port's signed view) in every set."""
    t = layout.bit_width(dt)
    np_dt = layout.np_dtype(dt)
    top = np.uint64(1 << (t - 1))
    if name == "bitpack":
        v = random_values(rng, dt, t // 2 - 1, n_blocks=B)
        v[0, 5] = np_dt.type((1 << t) - 2)  # forces W = T through the max probe
        return v
    if name == "ffor":  # narrow spread around an offset at the top bit
        return (random_values(rng, dt, 5, n_blocks=B).astype(np.uint64) + top - np.uint64(7)
                ).astype(np_dt)
    if name == "delta":  # sorted over the full range
        raw = rng.integers(0, 1 << 63, size=(B, layout.BLOCK), dtype=np.uint64)
        return np.sort(((raw << np.uint64(1)) >> np.uint64(64 - t)).astype(np_dt), axis=1)
    if name == "zdelta":  # noisy-sorted, crossing 2^(T-1)
        steps = rng.integers(-3, 20, size=(B, layout.BLOCK))
        return (np.cumsum(steps, axis=1).astype(np.uint64)
                + np.uint64(((1 << (t - 1)) - 2000) % (1 << 64))).astype(np_dt)
    if name == "rle":  # variable-length runs
        reps = rng.integers(20, 100, 200)
        vals = np_u(rng.integers(0, 1 << min(t, 20), 200).astype(np.uint64) + top, dt)
        return np.repeat(vals, reps)[:B * layout.BLOCK].reshape(B, layout.BLOCK)
    if name == "dict":  # low cardinality
        entries = np_u(rng.integers(0, 1 << (t - 1), 11).astype(np.uint64) * np.uint64(2)
                       + np.uint64(1), dt)
        return entries[rng.integers(0, 11, size=(B, layout.BLOCK))]
    raise AssertionError(name)


def same(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want)


def assert_same_encoded(enc, jenc, dt):
    """Port Encoded == JAX Encoded: codec, width, n_blocks, payload bytes and
    every param."""
    assert (enc.codec, enc.dtype, enc.width, enc.n_blocks) == \
        (jenc.codec, jenc.dtype, jenc.width, jenc.n_blocks)
    wire = "u16" if enc.codec in ("rle", "dict") else dt
    assert enc.payload.device.type == "cpu"
    same(convert.to_reference(enc.payload, wire), from_jax_form(jenc.payload, wire))
    assert set(enc.params or {}) == set(jenc.params or {})
    for key, val in (enc.params or {}).items():
        jval = jenc.params[key]
        if key == "reference":
            assert isinstance(val, int) and val == int(jval)
        elif key == "base":
            same(convert.to_reference(val, wire), from_jax_form(jval, wire))
        elif key == "counts":
            same(val.numpy(), np.asarray(jval))
        else:  # run_values, dictionary: native dtype on both sides
            same(convert.to_reference(val, dt), np.asarray(jval))
    assert enc.packed_bytes == jenc.packed_bytes
    assert enc.raw_bytes == jenc.raw_bytes
    assert enc.compression_ratio == jenc.compression_ratio


def jax_decode(name, dt, enc_fields):
    out = jcodecs.get_codec(name, dt).decode(jcodecs.Encoded(**enc_fields))
    return from_jax_form(out, dt)


@pytest.fixture(autouse=True)
def _no_kernel_launch_on_cpu():
    before = dict(ck.LAUNCHES)
    yield
    assert ck.LAUNCHES == before


def test_bits_needed():
    for x in (0, 1, 7, 8, (1 << 63), (1 << 64) - 1):
        assert tcodecs.bits_needed(x) == jcodecs.bits_needed(x)


@pytest.mark.parametrize("dt", layout.DTYPES)
def test_device_probes_use_unsigned_order(dt, rng):
    t = layout.bit_width(dt)
    np_dt = layout.np_dtype(dt)
    for vals in ([0, 1, (1 << (t - 1)) - 1], [(1 << (t - 1)) - 1, 1 << (t - 1)],
                 [1 << (t - 1), (1 << t) - 1], [3, (1 << t) - 1, 1 << (t - 1)]):
        arr = np.resize(np.array(vals, dtype=np_dt), (2, layout.BLOCK))
        tensor = torch.from_numpy(arr.copy())
        jarr = to_jax_form(arr, dt)
        assert tcodecs._device_max(tensor, dt) == max(vals) == jcodecs._device_max(jarr, dt)
        assert tcodecs._device_min(tensor, dt) == min(vals) == jcodecs._device_min(jarr, dt)
        assert isinstance(tcodecs._device_max(tensor, dt), int)


@pytest.mark.parametrize("name", CODECS)
@pytest.mark.parametrize("dt", layout.DTYPES)
def test_codec_matches_reference(dt, name, rng):
    values = data_for(name, dt, rng)
    jenc = jcodecs.get_codec(name, dt).encode(to_jax_form(values, dt))
    codec = tcodecs.get_codec(name, dt)
    enc = codec.encode(values, device="cpu")
    assert_same_encoded(enc, jenc, dt)
    # round trip, and each package decodes what the other encoded
    same(convert.to_reference(codec.decode(enc), dt), values)
    same(convert.to_reference(
        codec.decode(convert.encoded_from_reference(jenc, device="cpu")), dt), values)
    same(jax_decode(name, dt, convert.encoded_to_reference(enc, form="limbs")), values)
    # a tensor input and a numpy input are the same column
    enc2 = codec.encode(torch.from_numpy(values.copy()), device="cpu")
    same(convert.to_reference(enc2.payload, "u16" if name in ("rle", "dict") else dt),
         convert.to_reference(enc.payload, "u16" if name in ("rle", "dict") else dt))


@pytest.mark.parametrize("dt", layout.DTYPES)
def test_u64_and_limb_inputs_and_fixed_params(dt, rng):
    """Explicit width / reference, and for u64 the limb image as input."""
    t = layout.bit_width(dt)
    values = data_for("ffor", dt, rng)
    ref = int(values.min()) - 3
    jenc = jcodecs.FFoRCodec(dt, width=6, reference=ref).encode(to_jax_form(values, dt))
    enc = tcodecs.FFoRCodec(dt, width=6, reference=ref).encode(values, device="cpu")
    assert_same_encoded(enc, jenc, dt)
    same(convert.to_reference(tcodecs.FFoRCodec(dt).decode(enc), dt), values)
    for cls in ("BitPackedCodec", "DeltaCodec", "ZDeltaCodec"):
        jenc = getattr(jcodecs, cls)(dt, width=t - 1).encode(to_jax_form(values, dt))
        enc = getattr(tcodecs, cls)(dt, width=t - 1).encode(values, device="cpu")
        assert_same_encoded(enc, jenc, dt)
    if dt == "u64":
        enc = tcodecs.DeltaCodec(dt).encode(to_jax_form(values, dt), device="cpu")
        assert enc.payload.dtype == torch.uint64
        same(convert.to_reference(tcodecs.DeltaCodec(dt).decode(enc), dt), values)
        # the uint64 form of an Encoded crosses over as well as the limb image
        fields = convert.encoded_to_reference(enc)
        assert fields["payload"].dtype == np.uint64
        back = convert.encoded_from_reference(jcodecs.Encoded(**fields), device="cpu")
        same(convert.to_reference(tcodecs.DeltaCodec(dt).decode(back), dt), values)


@pytest.mark.parametrize("dt", layout.DTYPES)
def test_decode_single(dt, rng):
    values = data_for("bitpack", dt, rng)
    values[0, 5] = 0  # back to W = T/2 - 1, where values straddle words
    codec = tcodecs.BitPackedCodec(dt)
    enc = codec.encode(values, device="cpu")
    jenc = jcodecs.BitPackedCodec(dt).encode(to_jax_form(values, dt))
    idx = np.array([0, 1, 31, 517, 1023])
    same(convert.to_reference(codec.decode_single(enc, idx), dt), values[:, idx])
    same(convert.to_reference(codec.decode_single(enc, idx), dt),
         from_jax_form(jcodecs.BitPackedCodec(dt).decode_single(jenc, idx), dt))
    same(convert.to_reference(codec.decode_single(enc, 700), dt), values[:, 700])


@pytest.mark.parametrize("dt", layout.DTYPES)
@pytest.mark.parametrize("shape", CODECS)
def test_auto_costs_and_choice_match_reference(shape, dt, rng):
    values = data_for(shape, dt, rng)
    jvals = to_jax_form(values, dt)
    costs = tcodecs.auto_costs(values, dt, device="cpu")
    jcosts = jcodecs.auto_costs(jvals, dt)
    assert list(costs) == list(jcosts)
    for key in jcosts:
        assert costs[key] == jcosts[key], (key, costs, jcosts)
    enc = tcodecs.auto_encode(values, dt, device="cpu")
    jenc = jcodecs.auto_encode(jvals, dt)
    assert_same_encoded(enc, jenc, dt)
    assert enc.packed_bytes == costs[enc.codec]
    same(convert.to_reference(tcodecs.get_codec(enc.codec, dt).decode(enc), dt), values)


@pytest.mark.parametrize("dt", ["u16", "u64"])
def test_auto_costs_byte_exact(dt, rng):
    """auto_costs == the Encoded.packed_bytes each codec actually produces."""
    values = np.sort(random_values(rng, dt, layout.bit_width(dt) - 1, n_blocks=3), axis=1)
    costs = tcodecs.auto_costs(values, dt, device="cpu")
    for name, cost in costs.items():
        enc = tcodecs.get_codec(name, dt).encode(values, device="cpu")
        assert enc.packed_bytes == cost, (name, enc.packed_bytes, cost)


def test_auto_encode_picks_like_reference_on_named_shapes(rng):
    """The data shapes of tests/test_codecs.py: offset, sorted, noisy-sorted,
    runs, low-cardinality, and the all-zero tie."""
    steps = rng.integers(-3, 20, (2, 1024), np.int64)
    reps = rng.integers(20, 100, 200)
    cases = {
        "ffor": random_values(rng, "u32", 4, n_blocks=2) + np.uint32(1 << 30),
        "delta": np.sort(rng.integers(0, 1 << 31, (2, 1024), np.int64).astype(np.uint32),
                         axis=1),
        "zdelta": (np.cumsum(steps, axis=1) + 50_000).astype(np.uint32),
        "rle": np.repeat(rng.integers(0, 1 << 20, 200).astype(np.uint32),
                         reps)[:4 * 1024].reshape(4, 1024),
        "dict": rng.integers(1 << 24, 1 << 31, 9).astype(np.uint32)[
            rng.integers(0, 9, size=(4, 1024))],
        "bitpack": np.zeros((2, 1024), np.uint32),
    }
    for want, values in cases.items():
        enc = tcodecs.auto_encode(values, "u32", device="cpu")
        jenc = jcodecs.auto_encode(values, "u32")
        assert enc.codec == jenc.codec == want
        assert_same_encoded(enc, jenc, "u32")
    assert enc.width == 0 and tuple(enc.payload.shape) == (2, 0)  # the tie


def test_get_codec_names():
    assert type(tcodecs.get_codec("alp", "f32")) is tcodecs.ALPCodec
    assert sorted(tcodecs._CODECS) == sorted(jcodecs._CODECS)
    with pytest.raises(ValueError, match="unknown codec"):
        tcodecs.get_codec("zstd", "u32")
    assert tcodecs._TIE_ORDER == jcodecs._TIE_ORDER
    for name in CODECS:
        assert tcodecs.get_codec(name, "uint32").dtype == "u32"
    with pytest.raises(ValueError):
        tcodecs.BitPackedCodec("u8", width=9)


def test_dict_codec_rejects_too_many_values(rng):
    values = np.arange(65 * 1024, dtype=np.uint32).reshape(65, 1024)
    with pytest.raises(ValueError, match="exceed"):
        tcodecs.DictCodec("u32").encode(values, device="cpu")
    assert tcodecs.auto_costs(values, "u32", device="cpu")["dict"] == float("inf")


def test_packed_bytes_counts_tensors_without_a_copy(rng, monkeypatch):
    enc = tcodecs.RLECodec("u32").encode(data_for("rle", "u32", rng), device="cpu")
    monkeypatch.setattr(torch.Tensor, "cpu", lambda self: pytest.fail("copied to the host"))
    monkeypatch.setattr(torch.Tensor, "numpy", lambda self: pytest.fail("copied to the host"))
    p = enc.params
    assert enc.packed_bytes == enc.n_blocks * 128 + p["base"].numel() * 2 \
        + p["counts"].numel() * 8 + p["run_values"].numel() * 4


def test_default_device_is_the_gpu_or_an_error(rng):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    values = data_for("delta", "u32", rng)
    for call in (lambda: tcodecs.auto_encode(values, "u32"),
                 lambda: tcodecs.auto_costs(values, "u32"),
                 lambda: tcodecs.DeltaCodec("u32").encode(values),
                 lambda: convert.encoded_from_reference(
                     tcodecs.DeltaCodec("u32").encode(values, device="cpu"))):
        with pytest.raises(RuntimeError, match="cuda"):
            call()
