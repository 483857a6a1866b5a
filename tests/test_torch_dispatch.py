"""The PyTorch port's runtime-width dispatch (ops/dispatch.py) and
unpack_single (ops/single.py) on the CPU against the JAX package's, bit for
bit (tolerance 0)."""

import numpy as np
import pytest
import torch

from fastlanes_tpu.core import layout
from fastlanes_tpu.models.codecs import _as_param
from fastlanes_tpu.ops import dispatch as jdispatch
from fastlanes_tpu.ops import single as jsingle
from fastlanes_tpu.ref import numpy_ref as ref

from fastlanes_tpu_torch import convert
from fastlanes_tpu_torch.kernels import cuda_codecs as ck
from fastlanes_tpu_torch.ops import dispatch as tdispatch
from fastlanes_tpu_torch.ops import single as tsingle

from conftest import random_values, width_sample, width_sweep
from test_ops_vs_ref import from_jax_form, to_jax_form


def port_in(arr, dt):
    return convert.from_reference(arr, dt, device="cpu")


def port_out(tensor, dt):
    return convert.to_reference(tensor, dt)


def same(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want)


def test_same_op_names_as_reference():
    assert sorted(tdispatch._OPS) == sorted(jdispatch._OPS)
    assert len(tdispatch._OPS) == 11


#: the ops whose result does not depend on the width: the JAX package jits
#: them once per (op, dtype, width) all the same
WIDTH_FREE_OPS = ("delta", "undelta", "transpose", "untranspose")


@pytest.fixture(scope="module")
def width_free_reference():
    """dtype -> (values, base, {op: the JAX dispatch's output}) for the
    width-free ops, computed once per dtype on values made from a seed of
    its own; every width of the dtype compares against them."""
    cache = {}

    def get(dt):
        if dt not in cache:
            rng = np.random.default_rng(0xD15 + layout.bit_width(dt))
            values = random_values(rng, dt, layout.bit_width(dt), n_blocks=3)
            base = values[:, :layout.lanes(dt)].copy()
            args = {"delta": (values, base), "undelta": (values, base),
                    "transpose": (values,), "untranspose": (values,)}
            cache[dt] = (values, base, {
                op: from_jax_form(jdispatch.get(op, dt, 0)(
                    *(to_jax_form(a, dt) for a in op_args)), dt)
                for op, op_args in args.items()})
        return cache[dt]
    return get


@pytest.mark.parametrize("dt,w", width_sample())
def test_get_every_op_matches_reference(dt, w, rng, width_free_reference):
    values, base, width_free = width_free_reference(dt)
    packed = ref.pack(random_values(rng, dt, w, n_blocks=3), w, dt)
    reference = int(values[0, 0])
    args = {
        "pack": (values,), "unpack": (packed,), "undelta_pack": (packed, base),
        "delta_pack": (values, base), "for_pack": (values, reference),
        "unfor_pack": (packed, reference),
        "unpack_single": (packed, np.array([0, 3, 64, 1023])),
        "delta": (values, base), "undelta": (values, base),
        "transpose": (values,), "untranspose": (values,),
    }
    for op, op_args in args.items():
        t_args = [port_in(a, dt) if isinstance(a, np.ndarray) and a.dtype != np.int64 else a
                  for a in op_args]
        got = tdispatch.get(op, dt, w)(*t_args)
        assert got.dtype == convert.from_reference(values[:1], dt, device="cpu").dtype
        if op in WIDTH_FREE_OPS:  # the JAX output of width 0, the same function
            same(port_out(got, dt), width_free[op])
            continue
        j_args = [to_jax_form(a, dt) if isinstance(a, np.ndarray) and a.dtype != np.int64
                  else a for a in op_args]
        if op in ("for_pack", "unfor_pack"):  # under jit the reference is an array
            j_args[1] = _as_param(reference, dt)
        want = jdispatch.get(op, dt, w)(*j_args)
        same(port_out(got, dt), from_jax_form(want, dt))


def test_get_returns_the_kernel_wrappers():
    """The six ops with a CUDA kernel go through the wrappers (kernel on a
    CUDA tensor); the others are plain ops."""
    calls = []
    real = {name: getattr(ck, name) for name in
            ("pack", "unpack", "undelta_pack", "delta_pack", "for_pack", "unfor_pack")}
    values = torch.zeros((1, 1024), dtype=torch.uint32)
    packed = torch.zeros((1, 96), dtype=torch.uint32)
    base = torch.zeros(32, dtype=torch.uint32)
    args = {"pack": (values,), "unpack": (packed,), "undelta_pack": (packed, base),
            "delta_pack": (values, base), "for_pack": (values, 0),
            "unfor_pack": (packed, 0)}
    try:
        for name, fn in real.items():
            setattr(ck, name, lambda *a, _n=name, _f=fn: (calls.append(_n), _f(*a))[1])
        for name, op_args in args.items():
            tdispatch.get(name, "uint32", 3)(*op_args)
    finally:
        for name, fn in real.items():
            setattr(ck, name, fn)
    assert calls == list(args)


@pytest.mark.parametrize("dt", layout.DTYPES)
def test_unchecked_entries_and_width_validation(dt, rng):
    t = layout.bit_width(dt)
    w = t // 2 + 1
    values = random_values(rng, dt, w, n_blocks=2)
    packed = tdispatch.unchecked_pack(w, port_in(values, dt), dt)
    same(port_out(packed, dt), ref.pack(values, w, dt))
    same(port_out(packed, dt),
         from_jax_form(jdispatch.unchecked_pack(w, to_jax_form(values, dt), dt), dt))
    same(port_out(tdispatch.unchecked_unpack(w, packed, dt), dt), values)
    idx = np.array([5, 900])
    same(port_out(tdispatch.unchecked_unpack_single(w, packed, idx, dt), dt), values[:, idx])
    for bad in (-1, t + 1):
        with pytest.raises(ValueError):
            tdispatch.get("pack", dt, bad)
        with pytest.raises(ValueError):
            tdispatch.unchecked_pack(bad, port_in(values, dt), dt)
        with pytest.raises(ValueError):
            tdispatch.unchecked_unpack(bad, packed, dt)
        with pytest.raises(ValueError):
            tdispatch.unchecked_unpack_single(bad, packed, 0, dt)
    with pytest.raises(ValueError, match="unknown op"):
        tdispatch.get("zstd", dt, 1)
    with pytest.raises(ValueError):
        tdispatch.get("pack", "f32", 1)


def test_precompile_counts_the_variants():
    assert tdispatch.precompile(device="cpu") == 2 * 124
    assert tdispatch.precompile(ops=("pack",), dtypes=("u8", "u16"), device="cpu") == 9 + 17
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tdispatch.precompile()


@pytest.mark.parametrize("dt,w", width_sweep())
def test_unpack_single_sweep(dt, w, rng):
    """Every (dtype, width): all 1024 positions at once, against the values
    and the JAX function's two-word gather."""
    values = random_values(rng, dt, w, n_blocks=2)
    packed = ref.pack(values, w, dt)
    idx = np.arange(layout.BLOCK)
    got = port_out(tsingle.unpack_single(port_in(packed, dt), w, idx, dt), dt)
    same(got, values)
    if (dt, w) not in width_sample():
        return  # the JAX side costs a trace per config: sampled widths only
    some = np.array([0, 1, 17, 511, 1023])
    same(got[:, some],
         from_jax_form(jsingle.unpack_single(to_jax_form(packed, dt), w, some, dt), dt))


@pytest.mark.parametrize("dt", layout.DTYPES)
def test_unpack_single_index_forms(dt, rng):
    """Scalar and array index, W=0 and W=T, unbatched payload, tensor index,
    and an index whose value straddles two packed words."""
    t = layout.bit_width(dt)
    w = t - 3 if t > 8 else 5  # odd width: most rows straddle a word boundary
    values = random_values(rng, dt, w, n_blocks=3)
    packed = port_in(ref.pack(values, w, dt), dt)
    rows = layout.rows_by_index(dt)
    straddling = [i for i in range(layout.BLOCK)
                  if (rows[i] * w) % t + w > t]
    assert straddling
    i = straddling[len(straddling) // 2]
    same(port_out(tsingle.unpack_single(packed, w, i, dt), dt), values[:, i])
    same(port_out(tsingle.unpack_single(packed, w, np.int64(i), dt), dt),
         from_jax_form(jsingle.unpack_single(to_jax_form(ref.pack(values, w, dt), dt), w, i, dt),
                       dt))
    same(port_out(tsingle.unpack_single(packed, w, torch.tensor(straddling[:7]), dt), dt),
         values[:, straddling[:7]])
    same(port_out(tsingle.unpack_single(packed[1], w, [i, 0], dt), dt), values[1, [i, 0]])
    same(port_out(tsingle.unpack_single(packed[1], w, i, dt), dt), values[1, i])
    # W = 0 and W = T
    zero = port_in(np.zeros((3, 0), layout.np_dtype(dt)), dt)
    same(port_out(tsingle.unpack_single(zero, 0, [4, 9], dt), dt),
         np.zeros((3, 2), layout.np_dtype(dt)))
    full = random_values(rng, dt, t, n_blocks=3)
    same(port_out(tsingle.unpack_single(port_in(ref.pack(full, t, dt), dt), t,
                                        np.arange(0, 1024, 37), dt), dt),
         full[:, ::37])
    with pytest.raises(ValueError):
        tsingle.unpack_single(packed, w + 1, 0, dt)
