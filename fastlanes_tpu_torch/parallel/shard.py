"""Sharded codecs over the block axis, on torch.distributed.

The port of fastlanes_tpu/parallel/shard.py. The JAX package runs one
controller over a mesh (`shard_map`); here one process drives each device
and the ranks of a mesh (parallel/mesh.py) meet only in collectives. The
semantics are the JAX package's:

* every rank passes the WHOLE array, (B, cols) of one dtype;
* the block axis splits as `shard_map` splits it: padded with zero blocks to
  a multiple of the group size n, rank r takes blocks [r*s, (r+1)*s) with
  s = ceil(B / n);
* each rank runs the port's public entry on its blocks, on its device: the
  CUDA kernel wrapper on a card, the plain version on the CPU. A per-block
  base splits with the blocks; a shared base or the scalar FoR reference is
  replicated;
* each call returns the rank's LOCAL part, blocks [r*s, min((r+1)*s, B)), as
  a plain tensor on the rank's device. Every op works per block, so the zero
  padding blocks would only be computed and dropped: they are never made.

Blocks are independent, so the codecs run collective-free; collectives appear
only where the framework coordinates across blocks:

  global_max_bits          all-reduce MAX, to agree on one packing width
  all_gather_packed        the local parts in block order on every rank
                           (counts first: ranks may hold unequal parts)
  sharded_roundtrip_check  all-reduce SUM of the mismatches

The reads and aggregations of `fio_device` and `analytics` take `mesh=` too.
There the split is by CHUNK of an FLT file, not by block: rank r of n takes
the chunks [r*s, min((r+1)*s, C)) of the C chunks an entry covers, with the
rule above (`_chunk_span`), so the columns of a table stay aligned and a rank
reads from disk only its own chunks. A read returns the rank's local part;
an aggregation feeds the rank's parts into its exact accumulators and meets
the other ranks once, in `_combine`.

What the port leaves out, by its ground rules (ROADMAP.md): `use_kernels` and
the routing behind it (one path per op), `planes=` (a u64 column is one
native tensor here, not two limb planes), the `od` original-order strategy
(the `*_orig` kernels decode straight to original order) and the limb branch
of the zdelta decode.
"""

from __future__ import annotations

import pickle
from typing import NamedTuple

import torch
import torch.distributed as dist

from ..core import layout
from ..kernels import cuda_codecs as ck
from ..ops import _engine as eng
from ..ops import ffor as ops_ffor
from ..utils.trace import span

_DECODE = {
    ("unpack", False): ck.unpack, ("unpack", True): ck.unpack_orig,
    ("undelta_pack", False): ck.undelta_pack, ("undelta_pack", True): ck.undelta_pack_orig,
    ("unzdelta_pack", False): ck.unzdelta_pack,
    ("unzdelta_pack", True): ck.unzdelta_pack_orig,
}


def _shard(mesh, axis):
    """-> (group, n, r, device) of this rank on the mesh dimension `axis`."""
    names = tuple(mesh.mesh_dim_names or ())
    if axis not in names:
        raise KeyError(axis)
    if mesh.get_coordinate() is None:
        raise ValueError(f"rank {dist.get_rank()} is not in the mesh")
    if mesh.device_type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    else:
        device = torch.device(mesh.device_type)
    return (mesh.get_group(axis), mesh.size(names.index(axis)),
            mesh.get_local_rank(axis), device)


def _bounds(n_blocks: int, n: int, r: int):
    """Rank r's blocks [lo, hi) of n_blocks split n ways, padding dropped."""
    s = -(-n_blocks // n)
    return min(r * s, n_blocks), min((r + 1) * s, n_blocks)


class _Part(NamedTuple):
    """This rank's place on a 1-D mesh: its group, the group size n and its
    index r."""
    group: object
    n: int
    r: int


def _placement(device, mesh):
    """-> (device, part) of a read or an aggregation called with `device` and
    `mesh`: without a mesh the device rule and no part; with one, the
    rank's device on the mesh (a `device` that names another raises
    ValueError) and its _Part."""
    if mesh is None:
        return eng.resolve_device(device), None
    if mesh.ndim != 1:
        raise ValueError(f"a read or an aggregation takes a 1-D mesh, got {mesh.ndim}-D")
    group, n, r, mesh_device = _shard(mesh, mesh.mesh_dim_names[0])
    if device is not None:
        asked = torch.device(device)
        if asked.type != mesh_device.type or (
                asked.index is not None and asked.index != mesh_device.index):
            raise ValueError(f"device {asked} disagrees with the mesh's device {mesh_device}")
    return mesh_device, _Part(group, n, r)


def _chunk_span(part, n_chunks: int):
    """This rank's chunks [lo, hi) of `n_chunks` (all of them without a
    part): the block split of `_bounds`, applied to chunks."""
    if part is None:
        return 0, n_chunks
    return _bounds(n_chunks, part.n, part.r)


def _portable(exc: Exception) -> Exception:
    """`exc`, or a RuntimeError naming it where it does not pickle."""
    try:
        return pickle.loads(pickle.dumps(exc))
    except Exception:  # noqa: BLE001  (any failure to pickle)
        return RuntimeError(f"{type(exc).__name__}: {exc}")


def _combine(part, local) -> list:
    """The one collective of a sharded aggregation: `local()` on every rank,
    gathered in rank order (one `all_gather_object` of a small host state,
    so Python ints stay exact on every backend). Without a part, [local()].
    A rank whose `local` raised still joins the gather, and then EVERY rank
    raises the exception of the lowest rank that failed: the one the walk
    without a mesh would meet first, since the ranks' ranges are in order."""
    if part is None:
        return [local()]
    try:
        mine, failed = (None, local()), None
    except Exception as exc:  # noqa: BLE001  (re-raised on every rank below)
        mine, failed = (_portable(exc), None), exc
    got = [None] * part.n
    with span("combine"):
        dist.all_gather_object(got, mine, group=part.group)
    for r, (exc, _) in enumerate(got):
        if exc is not None:
            if r == part.r:
                raise failed
            raise exc
    return [value for _, value in got]


def _whole(arr, dtype) -> torch.Tensor:
    """The whole (B, cols) array as the unsigned tensor, where it lies
    (a u64 limb image becomes its uint64 view)."""
    full = eng.as_unsigned(arr, dtype)
    if full.ndim != 2:
        raise ValueError(f"sharded arrays are (blocks, cols), got {tuple(full.shape)}")
    return full


def _local(full: torch.Tensor, n: int, r: int, device) -> torch.Tensor:
    lo, hi = _bounds(full.shape[0], n, r)
    return full[lo:hi].to(device)


def _sharded_unary(fn, mesh, arr, width, dtype, axis):
    _, n, r, device = _shard(mesh, axis)
    return fn(_local(_whole(arr, dtype), n, r, device), width, dtype)


def sharded_pack(mesh, values, width, dtype, axis="blocks"):
    """Data-parallel pack: each rank packs its blocks. No collectives."""
    return _sharded_unary(ck.pack, mesh, values, width, dtype, axis)


def sharded_unpack(mesh, packed, width, dtype, axis="blocks", *, orig=False):
    """Data-parallel unpack; orig=True decodes straight to ORIGINAL order
    (the fused original-order kernel)."""
    return _sharded_unary(_DECODE["unpack", orig], mesh, packed, width, dtype, axis)


def _sharded_delta_family(op, mesh, packed, base, width, dtype, axis, orig):
    _, n, r, device = _shard(mesh, axis)
    full = _whole(packed, dtype)
    base = eng.as_unsigned(base, dtype)
    if base.ndim == full.ndim and base.shape[0] == full.shape[0]:
        base = _local(base, n, r, device)  # per-block: split with the blocks
    else:
        base = base.to(device)  # shared per-lane base: replicated
    return _DECODE[op, orig](_local(full, n, r, device), base, width, dtype)


def sharded_undelta_pack(mesh, packed, base, width, dtype, axis="blocks", *, orig=False):
    """Fused delta decode. A shared per-lane base (LANES,) is replicated; a
    per-block base (B, LANES) splits with the packed blocks. orig=True
    decodes straight to original order."""
    return _sharded_delta_family("undelta_pack", mesh, packed, base, width, dtype,
                                 axis, orig)


def sharded_unzdelta_pack(mesh, packed, base, width, dtype, axis="blocks", *, orig=False):
    """Fused zdelta decode (unpack -> unzigzag -> prefix sum); base rules as
    sharded_undelta_pack."""
    return _sharded_delta_family("unzdelta_pack", mesh, packed, base, width, dtype,
                                 axis, orig)


def _ref_int(reference, dtype) -> int:
    if ops_ffor.is_per_block(reference, dtype):
        raise ValueError("the sharded FFoR codecs take one scalar reference, replicated")
    return ops_ffor.ref_int(reference, dtype)


def sharded_for_pack(mesh, values, reference, width, dtype, axis="blocks"):
    """FFoR encode with a replicated scalar reference."""
    ref = _ref_int(reference, dtype)
    _, n, r, device = _shard(mesh, axis)
    return ck.for_pack(_local(_whole(values, dtype), n, r, device), ref, width, dtype)


def sharded_unfor_pack(mesh, packed, reference, width, dtype, axis="blocks"):
    """FFoR decode with a replicated scalar reference."""
    ref = _ref_int(reference, dtype)
    _, n, r, device = _shard(mesh, axis)
    return ck.unfor_pack(_local(_whole(packed, dtype), n, r, device), ref, width, dtype)


def global_max_bits(mesh, values, dtype, axis="blocks") -> torch.Tensor:
    """Agree on one packing width across the mesh: the bit length of the
    global maximum, the same 0-dim int64 tensor on every rank. Each rank
    takes the bit length of its own maximum (unsigned order), and an
    all-reduce MAX of those is the global maximum's bit length: bit length
    is monotone, and it keeps a u64 maximum at or above 2^63 out of a signed
    reduction."""
    group, n, r, device = _shard(mesh, axis)
    dtype = layout.canon_dtype(dtype)
    local = _local(_whole(values, dtype), n, r, device)
    top = eng.umax(eng.to_vec(local, dtype), dtype) if local.numel() else 0
    bits = torch.tensor(top.bit_length(), dtype=torch.int64, device=device)
    dist.all_reduce(bits, op=dist.ReduceOp.MAX, group=group)
    return bits


def all_gather_packed(mesh, packed_sharded, dtype, axis="blocks") -> torch.Tensor:
    """Every rank's local part `packed_sharded` (a sharded op's output),
    gathered in block order on every rank. Parts may hold unequal block
    counts: the counts are exchanged first, each part is padded to the
    largest, gathered as bytes (every backend carries uint8) and trimmed."""
    group, n, _, device = _shard(mesh, axis)
    part = eng.as_unsigned(packed_sharded, dtype).to(device).contiguous()
    if part.ndim != 2:
        raise ValueError(f"a local part is (blocks, cols), got {tuple(part.shape)}")
    counts = [torch.zeros(1, dtype=torch.int64, device=device) for _ in range(n)]
    dist.all_gather(counts, torch.tensor([part.shape[0]], dtype=torch.int64,
                                         device=device), group=group)
    counts = [int(c) for c in counts]
    row_bytes = part.shape[1] * part.element_size()
    if row_bytes == 0:  # a W=0 payload: nothing to gather
        return part.new_empty((sum(counts), part.shape[1]))
    wire = torch.zeros((max(counts), row_bytes), dtype=torch.uint8, device=device)
    wire[:part.shape[0]] = part.view(torch.uint8)
    parts = [torch.empty_like(wire) for _ in range(n)]
    dist.all_gather(parts, wire, group=group)
    whole = torch.cat([p[:c] for p, c in zip(parts, counts)])
    return whole.view(part.dtype)


def sharded_roundtrip_check(mesh, values, width, dtype, axis="blocks") -> torch.Tensor:
    """pack -> unpack per shard, the mismatches summed over the mesh: a
    0-dim int64 tensor, the same on every rank (0 == bit-exact everywhere).
    The framework's distributed self-validation step."""
    group, n, r, device = _shard(mesh, axis)
    dtype = layout.canon_dtype(dtype)
    local = _local(_whole(values, dtype), n, r, device)
    back = ck.unpack(ck.pack(local, width, dtype), width, dtype)
    bad = (eng.to_vec(back, dtype) != eng.to_vec(local, dtype)).sum(dtype=torch.int64)
    dist.all_reduce(bad, op=dist.ReduceOp.SUM, group=group)
    return bad

