"""The original-order entries of the PyTorch port on the CPU (the plain
versions of the fused kernels) against the JAX package's `*_orig` entries,
the TPU experiment whose kernels they port, and the NumPy oracle, bit for
bit. See test_torch_kernels_plain.py for the scheme."""

import numpy as np
import pytest

from fastlanes_tpu import transforms as jtransforms
from fastlanes_tpu.core import layout
from fastlanes_tpu.kernels import pallas_codecs as pk
from fastlanes_tpu.ops import orig as jorig
from fastlanes_tpu.ref import numpy_ref as ref

from fastlanes_tpu_torch.kernels import cuda_codecs as ck
from fastlanes_tpu_torch.ops import transpose as ttranspose

from conftest import width_sample
from test_ops_vs_ref import to_jax_form
from test_torch_kernels_plain import (
    jax_out, make_case, np_unzdelta, port_in, port_out, same)


@pytest.mark.parametrize("op", ["unpack_orig", "undelta_pack_orig", "unzdelta_pack_orig"])
@pytest.mark.parametrize("dt,w", width_sample())
def test_orig_entries_match_reference(op, dt, w, rng):
    _, packed, bases = make_case(rng, dt, w, n_blocks=4)
    args_np = (packed,) if op == "unpack_orig" else (packed, bases)
    if op == "unpack_orig":
        gold = ref.untranspose(ref.unpack(packed, w, dt), dt)
    elif op == "undelta_pack_orig":
        gold = ref.untranspose(ref.undelta_pack(packed, bases, w, dt), dt)
    else:
        gold = ref.untranspose(np_unzdelta(packed, bases, w, dt), dt)
    got = port_out(getattr(ck, op)(*(port_in(a, dt) for a in args_np), w, dt), dt)
    same(got, gold)
    jax_args = tuple(to_jax_form(a, dt) for a in args_np)
    # the reference's fused original-order formulation on XLA ops
    fused = getattr(jorig, op)(*jax_args, w, dt)
    if dt == "u64":  # a (lo, hi) plane pair there: stack to the limb image
        fused = np.stack([np.asarray(fused[0]), np.asarray(fused[1])], axis=-1)
    same(got, jax_out(fused, dt))
    # its `compose` strategy with the Pallas kernel in interpret mode, at
    # two widths per dtype (the kernels themselves are swept in
    # test_torch_kernels_plain.py and test_torch_kernels_delta.py)
    if w in (3, layout.bit_width(dt) - 1):
        same(got, jax_out(getattr(pk, op)(*jax_args, w, dt, strategy="compose",
                                          interpret=True), dt))


# ---------------------------------------------------------------------------
# the fused original-order entries: every edge width, shared and per-block
# base, one and three blocks, against the reference's own *_orig entries on
# their default route (tolerance 0: integer codecs). The JAX side runs once
# per (entry, dtype, width, base form) on three blocks, in a module fixture;
# a one-block case holds the port's one-block output against its first block
# (the blocks are independent).

EDGE_CASES = [(dt, w) for dt in layout.DTYPES
              for w in sorted({0, 1, layout.bit_width(dt) // 2 - 1,
                               layout.bit_width(dt) - 1, layout.bit_width(dt)})]
EDGE_BLOCKS = 3


def _original_order_values(rng, dt, n_blocks):
    """Values over the whole range of the dtype, so that the wrapping deltas
    reach both ends and the zigzag's arithmetic shift meets set top bits."""
    t = layout.bit_width(dt)
    vals = rng.integers(0, 1 << min(t, 63), size=(n_blocks, layout.BLOCK), dtype=np.uint64)
    return (vals << np.uint64(t - min(t, 63)) | vals & np.uint64(1)).astype(
        layout.np_dtype(dt))


@pytest.fixture(scope="module")
def edge_reference():
    """(dt, w) -> the EDGE_BLOCKS-block inputs (packed, bases, original-order
    values), made from a seed of their own, and `entry(name, *key)`: the
    reference's entry on them, computed once per key."""
    inputs, outputs = {}, {}

    def case(dt, w):
        if (dt, w) not in inputs:
            rng = np.random.default_rng(1000 * layout.bit_width(dt) + w)
            _, packed, bases = make_case(rng, dt, w, n_blocks=EDGE_BLOCKS)
            inputs[dt, w] = (packed, bases, _original_order_values(rng, dt, EDGE_BLOCKS))
        return inputs[dt, w]

    def entry(op, dt, w, form):
        """form: "shared" or "per_block" base, or the zigzag flag of the encode."""
        key = (op, dt, w, form)
        if key not in outputs:
            packed, bases, values = case(dt, w)
            if op == "delta_pack_orig":
                want_p, want_b = pk.delta_pack_orig(to_jax_form(values, dt), w, dt,
                                                    zigzag=form)
                outputs[key] = (jax_out(want_p, dt), jax_out(want_b, dt))
            else:
                args = (packed,) if op == "unpack_orig" else \
                    (packed, bases[0] if form == "shared" else bases)
                outputs[key] = jax_out(getattr(pk, op)(
                    *(to_jax_form(a, dt) for a in args), w, dt), dt)
        return outputs[key]

    return case, entry


@pytest.mark.parametrize("n_blocks", [1, 3])
@pytest.mark.parametrize("shared_base", [False, True], ids=["per_block", "shared"])
@pytest.mark.parametrize("op", ["undelta_pack_orig", "unzdelta_pack_orig"])
@pytest.mark.parametrize("dt,w", EDGE_CASES)
def test_orig_delta_decodes_match_reference_entries(op, dt, w, shared_base, n_blocks,
                                                    edge_reference):
    case, entry = edge_reference
    packed, bases, _ = case(dt, w)
    packed, bases = packed[:n_blocks], bases[:n_blocks]
    base = bases[0] if shared_base else bases
    got = port_out(getattr(ck, op)(port_in(packed, dt), port_in(base, dt), w, dt), dt)
    if op == "undelta_pack_orig":
        gold = ref.untranspose(ref.undelta_pack(
            packed, np.broadcast_to(base, bases.shape), w, dt), dt)
    else:
        gold = ref.untranspose(np_unzdelta(packed, base, w, dt), dt)
    same(got, gold)
    same(got, entry(op, dt, w, "shared" if shared_base else "per_block")[:n_blocks])


@pytest.mark.parametrize("n_blocks", [1, 3])
@pytest.mark.parametrize("dt,w", EDGE_CASES)
def test_unpack_orig_matches_reference_entry(dt, w, n_blocks, edge_reference):
    case, entry = edge_reference
    packed = case(dt, w)[0][:n_blocks]
    got = port_out(ck.unpack_orig(port_in(packed, dt), w, dt), dt)
    same(got, ref.untranspose(ref.unpack(packed, w, dt), dt))
    same(got, entry("unpack_orig", dt, w, None)[:n_blocks])


@pytest.mark.parametrize("n_blocks", [1, 3])
@pytest.mark.parametrize("zigzag", [False, True], ids=["plain", "zigzag"])
@pytest.mark.parametrize("dt,w", EDGE_CASES)
def test_delta_pack_orig_matches_reference_entry(dt, w, zigzag, n_blocks, edge_reference):
    """(packed, base) of the encode dual against the reference's entry on its
    default route and on `compose` with the Pallas kernel in interpret mode
    (one middle width per dtype, three blocks), and against the NumPy oracle."""
    case, entry = edge_reference
    values = case(dt, w)[2][:n_blocks]
    packed, base = ck.delta_pack_orig(port_in(values, dt), w, dt, zigzag=zigzag)
    packed, base = port_out(packed, dt), port_out(base, dt)
    nl = layout.lanes(dt)
    tr = ref.transpose(values, dt)
    deltas = ref.delta(tr, tr[:, :nl], dt)
    if zigzag:
        deltas = jtransforms.zigzag_encode_np(
            deltas.view(np.dtype(f"int{layout.bit_width(dt)}"))).view(layout.np_dtype(dt))
    same(base, np.ascontiguousarray(tr[:, :nl]))
    same(packed, ref.pack(deltas & layout.np_dtype(dt).type((1 << w) - 1)
                          if w < layout.bit_width(dt) else deltas, w, dt))
    want_p, want_b = entry("delta_pack_orig", dt, w, zigzag)
    same(packed, want_p[:n_blocks])
    same(base, want_b[:n_blocks])
    if w == layout.bit_width(dt) // 2 - 1 and n_blocks == 3:
        want_p, want_b = pk.delta_pack_orig(to_jax_form(values, dt), w, dt, zigzag=zigzag,
                                            strategy="compose", interpret=True)
        same(packed, jax_out(want_p, dt))
        same(base, jax_out(want_b, dt))


def test_delta_pack_orig_unbatched_and_base_ownership(rng):
    values = _original_order_values(rng, "u16", 2)
    packed, base = ck.delta_pack_orig(port_in(values[0], "u16"), 9, "u16")
    assert tuple(packed.shape) == (layout.packed_len("u16", 9),)
    assert tuple(base.shape) == (layout.lanes("u16"),)
    full_p, full_b = ck.delta_pack_orig(port_in(values, "u16"), 9, "u16")
    assert np.array_equal(port_out(packed, "u16"), port_out(full_p, "u16")[0])
    assert np.array_equal(port_out(base, "u16"), port_out(full_b, "u16")[0])
    assert full_b.is_contiguous()


@pytest.mark.parametrize("dt", layout.DTYPES)
def test_original_order_keeps_a_lanes_rows_contiguous(dt):
    """The layout fact the original-order kernels rest on: untranspose sends
    row r of lane l (transposed position index(r, l)) to seg(l)*T + r, with
    seg(l) = (l % 16) * (64 / T) + bitreverse(l / 16) a permutation of the
    lanes (the reversal over the log2(64 / T) bits that l / 16 has)."""
    from fastlanes_tpu_torch.core import layout as tlayout
    from fastlanes_tpu_torch.ops import orig as tops_orig

    t, nl = tlayout.bit_width(dt), tlayout.lanes(dt)
    bits = (64 // t).bit_length() - 1

    def seg(lane):
        h = lane // 16
        rev = int(format(h, f"0{bits}b")[::-1], 2) if bits else 0
        return (lane % 16) * (64 // t) + rev

    assert sorted(seg(lane) for lane in range(nl)) == list(range(nl))
    assert tuple(seg(lane) for lane in range(nl)) == tops_orig._seg_of_lane(dt)
    perm = tlayout.untranspose_perm()  # out[i] = in[perm[i]]
    for lane in range(nl):
        for r in range(t):
            assert perm[seg(lane) * t + r] == tlayout.index(r, lane, dt)
    # the same on data, through the port's untranspose and the oracle's
    block = np.arange(1024, dtype=layout.np_dtype("u16"))
    orig = ref.untranspose(block[None], "u16")[0]
    assert np.array_equal(port_out(ttranspose.untranspose(port_in(block, "u16"), "u16"),
                                   "u16"), orig)


# ---------------------------------------------------------------------------
# the TPU experiment the fused kernels port, run in interpret mode


@pytest.fixture(scope="module")
def experiment():
    """benchmarks/exp_untranspose_pallas.py, loaded by path (it is a script,
    not a module of a package; its `main` stays guarded)."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "benchmarks", "exp_untranspose_pallas.py")
    spec = importlib.util.spec_from_file_location("exp_untranspose_pallas", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("body", ["pB", "pG"])
@pytest.mark.parametrize("w", [3, 17])
def test_undelta_pack_orig_matches_the_tpu_experiment(experiment, body, w, rng):
    """The port's plain undelta_pack_orig against the experiment's fused
    kernel bodies (u32, two tiles of two blocks, interpret mode)."""
    import jax
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    dt, tile_b, n_blocks = "u32", 2, 4
    nl, t = layout.lanes(dt), layout.bit_width(dt)
    _, packed, bases = make_case(rng, dt, w, n_blocks=n_blocks)
    base_spec = pl.BlockSpec((tile_b, nl), lambda i: (i, 0), memory_space=pltpu.VMEM)
    if body == "pB":
        kernel, out_shape = experiment._kernel_pB(w, dt), 1024
    else:
        kernel, out_shape = experiment._kernel_pG(w, dt, tile_b), (nl, t)
    call = experiment._call(kernel, n_blocks, tile_b, layout.packed_len(dt, w), out_shape,
                            dt, (base_spec,), interpret=True)
    want = np.asarray(jax.jit(call)(packed, bases)).reshape(n_blocks, 1024)
    got = port_out(ck.undelta_pack_orig_plain(port_in(packed, dt), port_in(bases, dt), w, dt),
                   dt)
    same(got, want)
