"""unfor_pack / for_pack of the PyTorch port with one reference per block
(a `(B,)` or `(B, 1)` array), on the CPU, against the JAX package's
`unfor_pack` / `for_pack` and its ops layer, bit for bit (tolerance 0). The
JAX package answers such a reference through `ops.ffor`, which broadcasts it
over the block's rows; the port's public entries must answer it too."""

import numpy as np
import pytest
import torch

import fastlanes_tpu
from fastlanes_tpu.core import layout
from fastlanes_tpu.ops import ffor as jffor
from fastlanes_tpu.ref import numpy_ref as ref

import fastlanes_tpu_torch
from fastlanes_tpu_torch.kernels import cuda_codecs as ck

from test_ops_vs_ref import to_jax_form
from test_torch_kernels_plain import jax_out, port_in, port_out, same

CASES = [(dt, w) for dt in layout.DTYPES
         for w in sorted({0, 1, layout.bit_width(dt) // 2 - 1,
                          layout.bit_width(dt) - 1, layout.bit_width(dt)})]


def make_refs(rng, dt, n_blocks):
    """Per-block references with both ends of the range among them."""
    t = layout.bit_width(dt)
    refs = rng.integers(0, 1 << min(t, 63), size=n_blocks, dtype=np.uint64)
    refs[0] = (1 << t) - 1
    if n_blocks > 1:
        refs[1] = 0
    return refs.astype(layout.np_dtype(dt))


def oracle_unfor(packed, refs, w, dt):
    return np.stack([ref.unfor_pack(packed[b:b + 1], int(refs[b]), w, dt)[0]
                     for b in range(packed.shape[0])])


@pytest.mark.parametrize("column", [False, True], ids=["(B,)", "(B,1)"])
@pytest.mark.parametrize("n_blocks", [1, 3])
@pytest.mark.parametrize("dt,w", CASES)
def test_unfor_pack_per_block_reference(dt, w, n_blocks, column, rng):
    t = layout.bit_width(dt)
    packed = rng.integers(0, 1 << min(t, 63), size=(n_blocks, layout.packed_len(dt, w)),
                          dtype=np.uint64).astype(layout.np_dtype(dt))
    refs = make_refs(rng, dt, n_blocks)
    shaped = refs.reshape(-1, 1) if column else refs
    got = port_out(fastlanes_tpu_torch.unfor_pack(
        port_in(packed, dt), port_in(shaped, dt), w, dt), dt)
    same(got, oracle_unfor(packed, refs, w, dt))
    jax_args = (to_jax_form(packed, dt), to_jax_form(shaped, dt))
    same(got, jax_out(fastlanes_tpu.unfor_pack(*jax_args, w, dt), dt))
    same(got, jax_out(jffor.unfor_pack(*jax_args, w, dt), dt))


@pytest.mark.parametrize("column", [False, True], ids=["(B,)", "(B,1)"])
@pytest.mark.parametrize("n_blocks", [1, 3])
@pytest.mark.parametrize("dt,w", CASES)
def test_for_pack_per_block_reference(dt, w, n_blocks, column, rng):
    t = layout.bit_width(dt)
    values = rng.integers(0, 1 << min(t, 63), size=(n_blocks, layout.BLOCK),
                          dtype=np.uint64).astype(layout.np_dtype(dt))
    refs = make_refs(rng, dt, n_blocks)
    shaped = refs.reshape(-1, 1) if column else refs
    got = port_out(fastlanes_tpu_torch.for_pack(
        port_in(values, dt), port_in(shaped, dt), w, dt), dt)
    want = np.stack([ref.for_pack(values[b:b + 1], int(refs[b]), w, dt)[0]
                     for b in range(n_blocks)])
    same(got, want)
    jax_args = (to_jax_form(values, dt), to_jax_form(shaped, dt))
    same(got, jax_out(fastlanes_tpu.for_pack(*jax_args, w, dt), dt))
    same(got, jax_out(jffor.for_pack(*jax_args, w, dt), dt))
    # and back: the per-block decode inverts the per-block encode mod 2^W
    back = port_out(ck.unfor_pack(port_in(got, dt), port_in(refs, dt), w, dt), dt)
    mask = layout.np_dtype(dt).type((1 << w) - 1 if w < t else (1 << t) - 1)
    same((back - refs[:, None]) & mask, (values - refs[:, None]) & mask)


def test_numpy_reference_and_scalar_forms_still_work(rng):
    packed = rng.integers(0, 1 << 32, size=(3, layout.packed_len("u32", 7)),
                          dtype=np.uint64).astype(np.uint32)
    refs = np.array([5, 0, (1 << 32) - 1], dtype=np.uint32)
    tensor = port_in(packed, "u32")
    want = oracle_unfor(packed, refs, 7, "u32")
    same(port_out(ck.unfor_pack(tensor, refs, 7, "u32"), "u32"), want)  # numpy reference
    for scalar in (5, np.uint32(5), torch.tensor([5], dtype=torch.uint32)):
        same(port_out(ck.unfor_pack(tensor, scalar, 7, "u32"), "u32"),
             ref.unfor_pack(packed, 5, 7, "u32"))


def test_per_block_reference_of_the_wrong_length_raises(rng):
    tensor = torch.zeros((3, layout.packed_len("u16", 4)), dtype=torch.uint16)
    values = torch.zeros((3, layout.BLOCK), dtype=torch.uint16)
    for bad in (torch.zeros(2, dtype=torch.uint16), torch.zeros((4, 1), dtype=torch.uint16)):
        with pytest.raises(ValueError, match="per-block reference"):
            ck.unfor_pack(tensor, bad, 4, "u16")
        with pytest.raises(ValueError, match="per-block reference"):
            ck.for_pack(values, bad, 4, "u16")
    with pytest.raises(ValueError):
        ck.unfor_pack(tensor, torch.zeros(3, dtype=torch.uint32), 4, "u16")
