"""The sharded codecs of the PyTorch port (`fastlanes_tpu_torch.parallel`)
against the JAX package's (`fastlanes_tpu.parallel`), bit for bit.

The reference side runs on the conftest's 8-device CPU mesh through the ops
path (`use_kernels=False`), each (op, dtype) once, in a module fixture. The
port runs at world size 1 in this process (a gloo group on an in-process
store, created and destroyed by a module fixture) and at world size 2 in two
processes on a gloo group joined through a `file://` store: one spawn for
the module, whose children write every op's local part and gathered result
to one .npz. 13 blocks split 7 / 6 over two ranks, and 1 block leaves the
second rank empty."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from fastlanes_tpu_torch import parallel
from fastlanes_tpu_torch.core import layout
from fastlanes_tpu_torch.utils.testing import from_limb_view, to_limb_view

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WIDTH = {"u8": 5, "u16": 11, "u32": 19, "u64": 13}
N_BLOCKS = 13
#: dtype -> ((base, orig) of the undelta case, (base, orig) of the unzdelta
#: case): over the four dtypes each family meets both bases in both orders
DELTA_CASES = {"u8": (("base", False), ("bases", True)),
               "u16": (("bases", True), ("base", False)),
               "u32": (("bases", False), ("base", True)),
               "u64": (("base", True), ("bases", False))}
REFERENCE = {"u8": 200, "u16": 40_000, "u32": 3_000_000_000, "u64": (1 << 63) + 12345}



class _Reference:
    """fastlanes_tpu.parallel, imported at first use: the two-rank children
    import this module for its port calls and inputs, and need no jax."""

    def __getattr__(self, name):
        from fastlanes_tpu import parallel as reference

        return getattr(reference, name)


jpar = _Reference()

#: op -> (port call, reference call); `a` holds one dtype's inputs. (The
#: decodes take random words of all 64 bits and bases and references at and
#: above 2^63: both of the JAX package's u64 limbs carry data at any width)
OPS = {
    "pack": (lambda m, a, w, dt: parallel.sharded_pack(m, a["values"], w, dt),
             lambda m, a, w, dt: jpar.sharded_pack(m, a["values"], w, dt, use_kernels=False)),
    # blocks are independent: the reference is the first block of "pack"
    "pack_1_block": (lambda m, a, w, dt: parallel.sharded_pack(m, a["values"][:1], w, dt),
                     None),
    "unpack": (lambda m, a, w, dt: parallel.sharded_unpack(m, a["packed"], w, dt),
               lambda m, a, w, dt: jpar.sharded_unpack(m, a["packed"], w, dt,
                                                       use_kernels=False)),
    "unpack_orig": (
        lambda m, a, w, dt: parallel.sharded_unpack(m, a["packed"], w, dt, orig=True),
        lambda m, a, w, dt: jpar.sharded_unpack(m, a["packed"], w, dt, use_kernels=False,
                                                orig=True)),
    # each delta family with the base and order of DELTA_CASES[dtype]
    "undelta": (
        lambda m, a, w, dt: parallel.sharded_undelta_pack(
            m, a["packed"], a[DELTA_CASES[dt][0][0]], w, dt, orig=DELTA_CASES[dt][0][1]),
        lambda m, a, w, dt: jpar.sharded_undelta_pack(
            m, a["packed"], a[DELTA_CASES[dt][0][0]], w, dt, use_kernels=False,
            orig=DELTA_CASES[dt][0][1])),
    "unzdelta": (
        lambda m, a, w, dt: parallel.sharded_unzdelta_pack(
            m, a["packed"], a[DELTA_CASES[dt][1][0]], w, dt, orig=DELTA_CASES[dt][1][1]),
        lambda m, a, w, dt: jpar.sharded_unzdelta_pack(
            m, a["packed"], a[DELTA_CASES[dt][1][0]], w, dt, use_kernels=False,
            orig=DELTA_CASES[dt][1][1])),
    "for_pack": (
        lambda m, a, w, dt: parallel.sharded_for_pack(m, a["ffor_values"], REFERENCE[dt],
                                                      w, dt),
        lambda m, a, w, dt: jpar.sharded_for_pack(m, a["ffor_values"], REFERENCE[dt], w, dt,
                                                  use_kernels=False)),
    "unfor_pack": (
        lambda m, a, w, dt: parallel.sharded_unfor_pack(m, a["packed"], REFERENCE[dt], w, dt),
        lambda m, a, w, dt: jpar.sharded_unfor_pack(m, a["packed"], REFERENCE[dt], w, dt,
                                                    use_kernels=False)),
}


def make_inputs(dt):
    """Seeded inputs of one dtype, native numpy (uint64 for u64). Random
    packed words are a valid input of every decode."""
    rng = np.random.default_rng(layout.bit_width(dt) * 7919)
    t, w = layout.bit_width(dt), WIDTH[dt]
    np_dt = layout.np_dtype(dt)

    def draw(shape, bits):
        return rng.integers(0, 1 << bits, shape, dtype=np.uint64).astype(np_dt)

    nl, plen = layout.lanes(dt), layout.packed_len(dt, w)
    values = draw((N_BLOCKS, layout.BLOCK), w)
    return {"values": values, "packed": draw((N_BLOCKS, plen), t),
            "base": draw((nl,), t), "bases": draw((N_BLOCKS, nl), t),
            "ffor_values": (values.astype(np.uint64) + np.uint64(REFERENCE[dt]))
            .astype(np_dt)}


def jax_form(arr, dt):
    return to_limb_view(arr) if dt == "u64" else arr


def from_jax(arr, dt):
    out = np.asarray(arr)
    return from_limb_view(out) if dt == "u64" else out


@pytest.fixture(scope="module")
def inputs():
    return {dt: make_inputs(dt) for dt in layout.DTYPES}


@pytest.fixture(scope="module")
def reference(inputs):
    """(op, dtype) -> the JAX package's result, and 'max_bits'. One
    shard_map compile each, shared by every case below. (The reference's
    round-trip check is 0 by its definition; the port's is held to 0.)"""
    import jax

    mesh = jpar.make_mesh()
    assert mesh.shape["blocks"] == len(jax.devices()) == 8
    out = {}
    for dt in layout.DTYPES:
        a = {k: jax_form(v, dt) for k, v in inputs[dt].items()}
        for op, (_, ref_call) in OPS.items():
            if ref_call is not None:
                out[op, dt] = from_jax(ref_call(mesh, a, WIDTH[dt], dt), dt)
        out["pack_1_block", dt] = out["pack", dt][:1]
        out["max_bits", dt] = int(jpar.global_max_bits(mesh, a["values"], dt))
    return out


@pytest.fixture(scope="module")
def mesh1():
    """A one-rank gloo group for this module only."""
    assert not dist.is_initialized()
    mesh = parallel.make_mesh(device="cpu")
    yield mesh
    dist.destroy_process_group()


CASES = [(op, dt) for op in OPS for dt in layout.DTYPES]


@pytest.mark.parametrize("op,dt", CASES)
def test_one_rank_equals_the_reference(mesh1, inputs, reference, op, dt):
    got = OPS[op][0](mesh1, inputs[dt], WIDTH[dt], dt)
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    want = reference[op, dt]
    assert got.numpy().dtype == want.dtype and np.array_equal(got.numpy(), want)
    gathered = parallel.all_gather_packed(mesh1, got, dt)
    assert np.array_equal(gathered.numpy(), want)


@pytest.mark.parametrize("dt", layout.DTYPES)
def test_one_rank_width_and_roundtrip(mesh1, inputs, reference, dt):
    bits = parallel.global_max_bits(mesh1, inputs[dt]["values"], dt)
    assert int(bits) == reference["max_bits", dt] == WIDTH[dt]
    bad = parallel.sharded_roundtrip_check(mesh1, inputs[dt]["values"], WIDTH[dt], dt)
    assert int(bad) == 0


def test_one_rank_takes_the_reference_forms_and_checks(mesh1, inputs, reference):
    """A u64 limb image in, the same words out; the mesh's errors."""
    a = inputs["u64"]
    got = parallel.sharded_pack(mesh1, to_limb_view(a["values"]), WIDTH["u64"], "u64")
    assert np.array_equal(got.numpy(), reference["pack", "u64"])
    empty = parallel.sharded_pack(mesh1, a["values"], 0, "u64")  # W=0: no words
    assert tuple(parallel.all_gather_packed(mesh1, empty, "u64").shape) == (N_BLOCKS, 0)
    ones = np.full((3, 1024), np.uint64((1 << 64) - 1))
    assert int(parallel.global_max_bits(mesh1, ones, "u64")) == 64
    with pytest.raises(ValueError, match="asked for 2 devices, have 1"):
        parallel.make_mesh(2, device="cpu")
    with pytest.raises(KeyError):
        parallel.sharded_pack(mesh1, a["values"], 3, "u64", axis="rows")
    with pytest.raises(ValueError, match="one scalar reference"):
        parallel.sharded_for_pack(mesh1, a["values"], a["values"][:, 0], 3, "u64")
    named = parallel.make_mesh(axis="rows", device="cpu")
    assert named.mesh_dim_names == ("rows",)
    assert parallel.setup_distributed(num_processes=1, device="cpu") == 1
    assert parallel.local_device_count("cpu") == 1
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            parallel.local_device_count()


WORKER = r"""
import sys
import numpy as np
import torch
sys.path.insert(0, sys.argv[4])
import test_torch_parallel as t
from fastlanes_tpu_torch import parallel

rank, store, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
assert parallel.setup_distributed("file://" + store, 2, rank, device="cpu") == 2
mesh = parallel.make_mesh(device="cpu")
res = {}
for dt in t.layout.DTYPES:
    a = t.make_inputs(dt)
    for op, (call, _) in t.OPS.items():
        local = call(mesh, a, t.WIDTH[dt], dt)
        res[f"{op}|{dt}|local"] = local.numpy()
        res[f"{op}|{dt}|gathered"] = parallel.all_gather_packed(mesh, local, dt).numpy()
    res[f"max_bits|{dt}"] = np.int64(parallel.global_max_bits(mesh, a["values"], dt))
    res[f"roundtrip|{dt}"] = np.int64(
        parallel.sharded_roundtrip_check(mesh, a["values"], t.WIDTH[dt], dt))
np.savez(out, **res)
torch.distributed.destroy_process_group()
"""


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """One spawn of two gloo ranks for the whole module: rank -> results."""
    tmp = tmp_path_factory.mktemp("two_ranks")
    store = str(tmp / "store")
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(rank), store, str(tmp / f"rank{rank}.npz"),
         os.path.join(ROOT, "tests")], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for rank in range(2)]
    try:
        outs = [p.communicate(timeout=240) for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0, 0], [err[-3000:] for _, err in outs]
    results = []
    for rank in range(2):
        with np.load(tmp / f"rank{rank}.npz") as data:
            results.append({k: data[k] for k in data.files})
    return results


@pytest.mark.parametrize("op,dt", CASES)
def test_two_ranks_equal_the_reference(two_ranks, reference, op, dt):
    """Rank r holds blocks [r*s, min((r+1)*s, B)), s = ceil(B / 2): the
    local parts in rank order are the reference's result, and the gather
    gives it whole on both ranks."""
    want = reference[op, dt]
    s = -(-want.shape[0] // 2)
    for rank in range(2):
        local = two_ranks[rank][f"{op}|{dt}|local"]
        assert local.dtype == want.dtype
        assert np.array_equal(local, want[rank * s:(rank + 1) * s])
        assert np.array_equal(two_ranks[rank][f"{op}|{dt}|gathered"], want)


@pytest.mark.parametrize("dt", layout.DTYPES)
def test_two_ranks_agree_on_width_and_roundtrip(two_ranks, reference, dt):
    for rank in range(2):
        assert int(two_ranks[rank][f"max_bits|{dt}"]) == reference["max_bits", dt]
        assert int(two_ranks[rank][f"roundtrip|{dt}"]) == 0
    # unequal shards: 7 and 6 blocks, and 1 and 0
    assert [len(two_ranks[r][f"pack|{dt}|local"]) for r in range(2)] == [7, 6]
    assert [len(two_ranks[r][f"pack_1_block|{dt}|local"]) for r in range(2)] == [1, 0]
