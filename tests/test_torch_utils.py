"""The PyTorch port's utils (`fastlanes_tpu_torch.utils`) against the JAX
package's: an Encoded saved by either package loads in the other and
decodes to the same values (six codecs at u32 and u64, and ALP), the
testing helpers give the same answers, and the timing helpers time."""

import numpy as np
import pytest
import torch

from fastlanes_tpu.models import codecs as jcodecs
from fastlanes_tpu.utils import load_encoded as jload, save_encoded as jsave
from fastlanes_tpu.utils import testing as jtesting

from fastlanes_tpu_torch import convert
from fastlanes_tpu_torch.models import codecs as tcodecs
from fastlanes_tpu_torch.utils import load_encoded, save_encoded, testing, timing

from conftest import random_values
from test_ops_vs_ref import from_jax_form, to_jax_form
from test_torch_codecs import CODECS, assert_same_encoded, data_for, same


@pytest.mark.parametrize("dt", ["u32", "u64"])
@pytest.mark.parametrize("name", CODECS)
def test_a_file_either_package_saves_loads_in_the_other(tmp_path, rng, name, dt):
    """u32 runs the JAX package's encoder and decoder. u64 holds the loaded
    fields to the port's (the JAX package's u64 encode and decode of these
    same fields are pinned by tests/test_torch_codecs.py; their limb-engine
    compiles would cost seconds a case)."""
    values = data_for(name, dt, rng)
    enc = tcodecs.get_codec(name, dt).encode(values, device="cpu")
    # the port saves, the JAX package loads (and decodes)
    path = str(tmp_path / "port.npz")
    save_encoded(path, enc)
    jenc = jload(path)
    assert_same_encoded(enc, jenc, dt)
    if dt == "u32":
        same(from_jax_form(jcodecs.get_codec(name, dt).decode(jenc), dt), values)
        theirs = jcodecs.get_codec(name, dt).encode(to_jax_form(values, dt))
    else:
        theirs = jcodecs.Encoded(**convert.encoded_to_reference(enc, form="limbs"))
    # the JAX package saves, the port loads and decodes
    jpath = str(tmp_path / "jax.npz")
    jsave(jpath, theirs)
    back = load_encoded(jpath, device="cpu")
    assert_same_encoded(back, jload(jpath), dt)
    same(tcodecs.get_codec(name, dt).decode(back).numpy(), values)


@pytest.mark.parametrize("vtype", ["f32", "f64"])
def test_alp_encoded_crosses_both_ways(tmp_path, rng, vtype):
    """ALP's str / tuple / array params survive disk in both directions. The
    JAX package decodes ALP f64 under x64 only (tests/test_alp.py): for f64
    the fields it loads are held to the port's, bit for bit, instead."""
    np_f = np.float32 if vtype == "f32" else np.float64
    values = (rng.integers(0, 1 << 16, (3, 1024)) / 100.0).astype(np_f)
    values[1, 7] = np_f(1.0) / 3  # an exception
    bits = values.view(np.uint32 if vtype == "f32" else np.uint64)
    enc = tcodecs.ALPCodec(vtype).encode(values, device="cpu")
    path = str(tmp_path / "port.npz")
    save_encoded(path, enc)
    jenc = jload(path)
    assert jenc.params["vtype"] == vtype and jenc.params["shape"] == (3, 1024)
    fields = convert.encoded_to_reference(enc, form="limbs")
    assert (jenc.codec, jenc.dtype, jenc.width, jenc.n_blocks) == \
        (fields["codec"], fields["dtype"], fields["width"], fields["n_blocks"])
    np.testing.assert_array_equal(jenc.payload, fields["payload"])
    for key in ("exc_pos", "exc_val"):
        np.testing.assert_array_equal(jenc.params[key].view(np.uint8),
                                      fields["params"][key].view(np.uint8))
    if vtype == "f32":
        out = np.asarray(jcodecs.ALPCodec(vtype).decode(jenc))
        np.testing.assert_array_equal(out.view(bits.dtype), bits)
    jpath = str(tmp_path / "jax.npz")
    jsave(jpath, jcodecs.ALPCodec(vtype).encode(values))
    back = load_encoded(jpath, device="cpu")
    assert back.params["vtype"] == vtype and back.params["shape"] == (3, 1024)
    np.testing.assert_array_equal(
        tcodecs.ALPCodec(vtype).decode(back).numpy().view(bits.dtype), bits)


def test_load_refuses_another_version_and_a_bad_width(tmp_path, rng):
    enc = tcodecs.BitPackedCodec("u32").encode(random_values(rng, "u32", 9), device="cpu")
    path = str(tmp_path / "enc.npz")
    save_encoded(path, enc)
    with np.load(path) as data:
        arrays = {k: data[k] for k in data.files}
    for meta, err in (({"version": 2}, "unsupported format version 2"),
                      ({"width": 33}, "width 33 not supported")):
        import json

        m = json.loads(bytes(arrays["__meta__"]).decode())
        m.update(meta)
        bad = dict(arrays, __meta__=np.frombuffer(json.dumps(m).encode(), np.uint8))
        np.savez(str(tmp_path / "bad.npz"), **bad)
        for load in (load_encoded, jload):
            with pytest.raises(ValueError, match=err):
                load(str(tmp_path / "bad.npz"), **({"device": "cpu"} if load is load_encoded
                                                    else {}))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            load_encoded(path)


def test_testing_helpers_match_the_reference(rng):
    v = random_values(rng, "u64", 64, n_blocks=2)
    limb = testing.to_limb_view(v)
    np.testing.assert_array_equal(limb, jtesting.to_limb_view(v))
    assert limb.shape == (2, 1024, 2) and limb.dtype == np.uint32
    np.testing.assert_array_equal(testing.from_limb_view(limb), v)
    assert testing.GOLDEN_SHA256 == jtesting.GOLDEN_SHA256
    from fastlanes_tpu_torch.ref import numpy_ref as ref

    packed = ref.pack((np.arange(1024) % 8).astype(np.uint16), 3, "u16")[0]
    assert testing.sha256_le(packed) == jtesting.sha256_le(packed) == \
        testing.GOLDEN_SHA256["readme_u16_w3"]
    big = packed.astype(">u2")  # the little-endian image, whatever the order
    assert testing.sha256_le(big) == testing.sha256_le(packed)


def test_timing_helpers():
    calls = []

    def fn(x):
        calls.append(1)
        return {"out": (x + 1, [x])}

    x = torch.arange(8)
    t = timing.median_time(fn, x, warmup=2, iters=5)
    assert t > 0 and len(calls) == 2 + 5
    assert timing.throughput_ints(fn, 1000, x, warmup=1, iters=3) > 0
