#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (fastlanes_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from csrc/ with nvcc, holds each of the eleven against
its plain PyTorch version on the card (bit for bit; the u32/u64
original-order decode also at the edges of its grid: W = 0, 1, a middle
width, T - 1, T; 1, NB - 1, NB + 1, 2 NB + 1 and 257 blocks; shared and
per-block bases over all T bits), then drives the port's main paths. The
device-side column read: FLT files of every integer codec
are written with the port's host writer from seeded numpy data, read back
with `read_file_device` / `read_blocks_device` on the GPU and compared bit
for bit with the host reader. The device-side column encode: the same columns,
moved to the card, go through the codec classes (`BitPackedCodec.encode`,
`auto_encode`, `get_codec(...).encode`), every `Encoded` is decoded again by
its codec and compared bit for bit with the input, and its payload is held
against the NumPy oracle on the first and last 1 024 blocks. The headline
column is 131 072 blocks (2^27 u32 values, 512 MiB) at W=3 on both paths.
Delta, zdelta and rle chunks are read and written in ORIGINAL order by the
fused original-order kernels (no gather pass), a run of ffor chunks decodes
in one launch with one reference per block, and the transposed-order delta
entries are driven through their public names on the encoded columns. It
then drives the float, table, multi-file and scan paths (all at tolerance
0): the ALP division proof on the card (every exponent, the whole f32 integer
range and over a million f64 integers each) and float files of 2^25 / 2^24
values read back bit for bit; a table of 2^24 + 777 rows whose columns take
every codec between them, column by column through `read_column_device`; 20
shard files through `read_files_device` (one launch per signature group) and
`iter_files_device`; and `scan_table`, `scan_column`, `count_where` (all
eight operators on an integer, a float, a date and a string column) and
`scan_where` held against NumPy oracles written here, with the launches
counted: natural-order kernels on the sorted columns, original-order kernels
only under a validity bitmap or a padded tail, none for a probe the zone maps
resolve. The aggregations follow, on that table and on a second one of
2^24 + 333 rows (a 1000-group store key, a Zipf-skewed 65536-group sku key,
a nullable region key): `scan_where_multi`, `group_stats` (string and
integer keys, float, 64-bit and string values, WHERE, a two-file dataset),
`value_counts`, `top_k`, `distinct`, `quantile` and `median`, each equal to
a NumPy oracle written here with the launches and host fetches of every call
counted. The C++ host codec (built with g++ beside nvcc) must load, and is
timed against the NumPy host codec at 2^24 values of every dtype. The rows
follow: `select` (two predicates, a date range over every column, LIMIT
without ORDER BY, ORDER BY ... LIMIT over f64, string, date and u16 keys
with heavy ties, over a u8 key under WHERE, where a row the WHERE drops ties
the worst real key, and over a two-file dataset) and `join` (the group
table with a 65536-sku dimension on a u32 key, inner, and the table with a
20-currency dimension on a string key, left), each equal to a NumPy oracle
that spells out the tie rule; beside them the two tables are written again
with the host codec and without it. The sharded codecs (`parallel/`) come
next: at one rank over NCCL in this process, every sharded encode and decode
on the headline, ffor, delta and zdelta columns and on a u8, a u16 and a u64
column, each equal to the single-process entry and, at both ends, to
numpy_ref; then two ranks over gloo on the one card, two child processes
that pass the headline column at 131 072 + 5 blocks (unequal shards) and
gather a payload whose sha256 must be the single-process `pack`'s; the path
must launch `pack`, `unpack`, `unpack_orig`, `undelta_pack`,
`undelta_pack_orig`, `unzdelta_pack`, `unzdelta_pack_orig`, `for_pack` and
`unfor_pack` (SHARD_KERNELS). Just before it, `mesh=` on the five reads and
ten aggregations (`mesh` path): at one rank over NCCL in this process and at
two ranks over gloo on the one card (two child processes, one spawn), on the
headline file, three other read files, the table and the group table; every
rank reads and decodes only its chunks, each local read equals the host
reader's rows of those chunks, every aggregation answer equals the NumPy
oracle and the call without a mesh, and the two ranks agree; the path must
launch `unpack`, `unfor_pack`, `undelta_pack`, `undelta_pack_orig` and
`unzdelta_pack_orig` (MESH_KERNELS). Then the command line (`cli.main` in this
process, on the card): decompress --device, scan --where and --group-by, a
select with ORDER BY ... LIMIT and a join, each answer equal to the library
call's; the path must launch `unpack`, `unfor_pack` and `undelta_pack_orig`
(CLI_KERNELS). Then the five example scripts (examples/torch_*.py), each
`main(["--on", "cuda"])` in this process at its default size, every answer
held to a NumPy oracle written here from the same seed and size; the path
must launch `unpack`, `pack`, `undelta_pack_orig`, `unfor_pack` and
`delta_pack_orig` (EXAMPLE_KERNELS). Right after the build, `kernels.warmup`
of all eleven kernels over every dtype and width (1320 launches) gives the
cold start. Last it times each kernel at the largest shape its path gave it,
beside its bound, its plain version and a device copy, all eleven kernels
of every dtype at a size whose bytes bound is at least 0.1 ms, the group
accumulator's kernel beside its plain version (TPC-H Q1's shape and the
group table's 1000 and 65536 groups), and each read, encode, scan,
aggregation and query end to end (a query also in rows out per second). On every driven path, each (kernel,
dtype) pair is held against its plain version on the tensors of its largest
launch there, and the `kernels` line counts the launches by dtype. The
`kernels_by_width` line times every (kernel, dtype, width) the paths
launched (at most 60, the widths of the most launches first), each held bit
for bit against its plain version first: at a bytes bound of at least
0.1 ms beside a clone, and at the median block count the paths gave it,
with launches x (ms - bound) there.

Needs one CUDA device and nvcc; it never runs on the CPU. Every phase prints
one JSON line; any failed phase raises and the exit code is not 0. The last
line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import hashlib
import io
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

import fastlanes_tpu_torch
from fastlanes_tpu_torch import alp, analytics, fio, fio_device, fio_table, native, transforms
from fastlanes_tpu_torch.core import layout
from fastlanes_tpu_torch import kernels
from fastlanes_tpu_torch.kernels import build
from fastlanes_tpu_torch.kernels import cuda_codecs as ck
from fastlanes_tpu_torch.models import codecs
from fastlanes_tpu_torch.ops import _engine as eng
from fastlanes_tpu_torch.ops import delta as ops_delta
from fastlanes_tpu_torch.ops import transpose as ops_transpose
from fastlanes_tpu_torch.ref import numpy_ref as npref

SEED = 20240607
HEADLINE_BLOCKS = 131_072  # 2^27 values, 512 MiB decoded as u32
LARGE_BLOCKS = 32_768  # one whole secondary column (2^25 u32 values)
CHECK_BLOCKS = 257  # not a multiple of the CUDA block's FastLanes blocks
ORACLE_BLOCKS = 1024  # blocks at each end of a payload held against the oracle

#: published device-memory rate of one H100 SXM (bytes/s), for `bound_ms`
HBM_BYTES_PER_S = 3.35e12
#: 32-bit integer operations per second outside the tensor cores: half the
#: published 67 TFLOP/s float32 rate, which counts a fused multiply-add as 2
INT_OPS_PER_S = 33.5e12
#: integer operations per value in each kernel's row loop (decode: shift,
#: stitch, mask; + add; + running sum; + unzigzag. encode: mask, shift, or,
#: carry; + subtract), for the operations bound
OPS_PER_VALUE = {"unpack": 4, "unfor_pack": 5, "undelta_pack": 5,
                 "unzdelta_pack": 9, "pack": 4, "delta_pack": 5, "for_pack": 5,
                 "unpack_orig": 4, "undelta_pack_orig": 5, "unzdelta_pack_orig": 9,
                 "delta_pack_orig": 8}

#: kernel -> the TPU kernel it replaces
KERNELS = {
    "unpack": "fastlanes_tpu/kernels/pallas_codecs.py:635",
    "unfor_pack": "fastlanes_tpu/kernels/pallas_codecs.py:721",
    "undelta_pack": "fastlanes_tpu/kernels/pallas_codecs.py:656",
    "unzdelta_pack": "fastlanes_tpu/kernels/pallas_codecs.py:674",
    "pack": "fastlanes_tpu/kernels/pallas_codecs.py:611",
    "delta_pack": "fastlanes_tpu/kernels/pallas_codecs.py:706",
    "for_pack": "fastlanes_tpu/kernels/pallas_codecs.py:898",
    "unpack_orig": "benchmarks/exp_untranspose_pallas.py:164",
    "undelta_pack_orig": "benchmarks/exp_untranspose_pallas.py:171",
    "unzdelta_pack_orig": "fastlanes_tpu/kernels/pallas_codecs.py:841",
    "delta_pack_orig": "fastlanes_tpu/kernels/pallas_codecs.py:861",
}
ENCODE_KERNELS = ("pack", "delta_pack", "for_pack", "delta_pack_orig")
ORIG_DECODE_KERNELS = ("unpack_orig", "undelta_pack_orig", "unzdelta_pack_orig")
#: which of the smoke's three driven paths must launch which kernels: the
#: file reads, the codec-class encodes, and the transposed-order delta
#: entries called by their public names on the encoded columns
READ_KERNELS = ("unpack", "unfor_pack", "unpack_orig", "undelta_pack_orig",
                "unzdelta_pack_orig")
ENCODE_PATH_KERNELS = ("pack", "for_pack", "delta_pack_orig")
TRANSPOSED_KERNELS = ("undelta_pack", "unzdelta_pack", "delta_pack")
#: the sharded codecs (parallel/) at one rank over NCCL: every sharded decode
#: and encode, transposed and original order
SHARD_KERNELS = ("pack", "unpack", "unpack_orig", "undelta_pack", "undelta_pack_orig",
                 "unzdelta_pack", "unzdelta_pack_orig", "for_pack", "unfor_pack")
#: the command line on the card: decompress --device of the headline file
#: (unpack), a scan of the ffor qty column (unfor_pack), a select that
#: gathers the sorted delta key column in original order (undelta_pack_orig)
CLI_KERNELS = ("unpack", "unfor_pack", "undelta_pack_orig")
#: the example scripts (examples/torch_*.py, `main(["--on", "cuda"])` in this
#: process at their default sizes): the ALP encode and the u16 README example
#: (pack), every read (unpack), the table query's ffor chunks (unfor_pack),
#: the sorted columns in original order (undelta_pack_orig), the delta
#: encode on the card (delta_pack_orig)
EXAMPLE_KERNELS = ("unpack", "pack", "undelta_pack_orig", "unfor_pack", "delta_pack_orig")
EXAMPLES = ("float_columns", "end_to_end", "compressed_scan", "table_analytics",
            "query_tour")
SOURCE = "fastlanes_tpu_torch/csrc/codecs.cu"


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bit-for-bit equality (dtype, shape, bytes). Compared on the signed
    view: the unsigned dtypes wider than 8 bits have few device ops."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    signed = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    if a.dtype != torch.bool:
        a = a.view(signed[a.element_size()])
        b = b.view(signed[b.element_size()])
    return torch.equal(a, b)


def max_abs_err(a, b) -> float:
    """0.0 for equal tensors (or equal tuples of tensors), else the largest
    |a - b| of the unsigned values."""
    if isinstance(a, tuple):
        return max(max_abs_err(x, y) for x, y in zip(a, b))
    if same(a, b):
        return 0.0
    if a.shape != b.shape:
        return float("inf")
    a64 = torch.from_numpy(a.cpu().numpy().astype(np.float64))
    b64 = torch.from_numpy(b.cpu().numpy().astype(np.float64))
    return float((a64 - b64).abs().max())


def call_kernel(name, src, param, width, dtype, plain=False):
    """The wrapper `name` (or its plain version) on `src`. `param` is the
    base, the reference (an int or a per-block tensor), None, or for
    delta_pack_orig the zigzag flag (it returns (packed, base))."""
    fn = getattr(ck, name + "_plain" if plain else name)
    if name == "delta_pack_orig":
        return fn(src, width, dtype, zigzag=bool(param))
    if name in ("unpack", "pack", "unpack_orig"):
        return fn(src, width, dtype)
    return fn(src, param, width, dtype)


@contextlib.contextmanager
def count_gathers():
    """While active, counts the calls into ops.transpose (the index_select
    gather of transpose / untranspose): the original-order paths must make
    none. Yields a one-element list holding the count."""
    real, calls = ops_transpose._apply, [0]

    def counted(*args, **kwargs):
        calls[0] += 1
        return real(*args, **kwargs)

    ops_transpose._apply = counted
    try:
        yield calls
    finally:
        ops_transpose._apply = real


def compose_form(name, src, param, width, dtype):
    """What the original-order entries were before they had kernels of their
    own: the transposed-order kernel and a transpose / untranspose gather
    (for the zigzag encode: gather, plain delta and zigzag, pack kernel).
    Timed beside the fused kernels, used by nothing in the port."""
    if name == "delta_pack_orig":
        tr = ops_transpose.transpose(src, dtype)
        base = tr[..., :layout.lanes(dtype)].contiguous()
        if not param:
            return ck.delta_pack(tr, base, width, dtype), base
        zz = transforms.zigzag_unsigned(ops_delta.delta(tr, base, dtype))
        return ck.pack(zz, width, dtype), base
    inner = name[:-len("_orig")]
    return ops_transpose.untranspose(call_kernel(inner, src, param, width, dtype), dtype)


# ---------------------------------------------------------------------------
# phases


def phase_device() -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    info = {"phase": "device", "nvidia_smi": smi,
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(), "torch": torch.__version__,
            "cuda": torch.version.cuda}
    emit(info)
    return info


def phase_build() -> None:
    """nvcc of the CUDA kernels, with the g++ build of the native host codec
    running beside it (phase_native reports it)."""
    t0 = time.perf_counter()
    host_codec = threading.Thread(target=native.available)
    host_codec.start()
    path = build.build(force=True)
    build.load()
    host_codec.join()
    usage = build.ptxas_usage(build.last_build_log or "")
    registers = [u.get("registers", 0) for u in usage.values()]
    spills = [u.get("spill_store_bytes", 0) for u in usage.values()]
    emit({"phase": "build", "library": os.path.relpath(path),
          "nvcc_seconds": build.last_build_seconds,
          "kernel_instantiations": len(usage),
          "max_registers": max(registers, default=None),
          "max_spill_store_bytes": max(spills, default=None),
          "ptxas": usage, "seconds": time.perf_counter() - t0})


def phase_warmup(card: str) -> None:
    """`kernels.warmup` of all eleven kernels over every dtype and width at
    CHECK_BLOCKS blocks: the port's cold start on the card (each kernel's
    first launches), then the same call warm. Every entry is one launch."""
    n_widths = sum(layout.bit_width(dt) for dt in layout.DTYPES)
    walls = []
    for _ in range(2):
        ck.reset_launches()
        t0 = time.perf_counter()
        count = kernels.warmup(ops=tuple(KERNELS), n_blocks=CHECK_BLOCKS)
        walls.append(time.perf_counter() - t0)
        if count != len(KERNELS) * n_widths or ck.LAUNCHES != dict.fromkeys(KERNELS, n_widths):
            raise AssertionError(f"warmup drove {count} entries, launches {ck.LAUNCHES}")
    ck.reset_launches()
    emit({"phase": "warmup", "card": card, "ops": list(KERNELS), "n_blocks": CHECK_BLOCKS,
          "count": count, "launches_per_kernel": n_widths, "cold_wall_s": walls[0],
          "warm_wall_s": walls[1]})


def phase_kernels(rng) -> dict:
    """Each kernel against its plain version on the card, every dtype and a
    sample of widths, shared and per-block bases, both extreme references."""
    worst = {name: 0.0 for name in KERNELS}
    cases = {name: 0 for name in KERNELS}
    # the encode kernels' inputs come from a stream of their own, so that the
    # columns of make_columns stay what they were before these checks existed
    values_rng = np.random.default_rng(SEED + 1)
    for dtype in layout.DTYPES:
        t = layout.bit_width(dtype)
        nl = layout.lanes(dtype)
        np_dt = layout.np_dtype(dtype)
        for width in sorted({0, 1, 3, t // 2, t - 1, t}):
            plen = layout.packed_len(dtype, width)
            words = rng.integers(0, 1 << t, size=(CHECK_BLOCKS, plen), dtype=np.uint64)
            packed = torch.from_numpy(words.astype(np_dt)).cuda()
            bases = rng.integers(0, 1 << min(t, 63), size=(CHECK_BLOCKS, nl),
                                 dtype=np.uint64).astype(np_dt)
            per_block = torch.from_numpy(bases).cuda()
            raw = values_rng.integers(0, 1 << t, size=(CHECK_BLOCKS, layout.BLOCK),
                                      dtype=np.uint64)
            values = torch.from_numpy(raw.astype(np_dt)).cuda()
            # one reference per block, both extremes mixed among them
            refs = np.where(np.arange(CHECK_BLOCKS) % 2 == 0, (1 << t) - 1, 0)
            block_refs = torch.from_numpy(refs.astype(np.uint64).astype(np_dt)).cuda()
            shared = per_block[0].clone()
            params = {
                "unpack": [None],
                "unfor_pack": [0, (1 << t) - 1, block_refs],
                "undelta_pack": [shared, per_block],
                "unzdelta_pack": [shared, per_block],
                "pack": [None],
                "delta_pack": [shared, per_block],
                "for_pack": [0, (1 << t) - 1, block_refs],
                "unpack_orig": [None],
                "undelta_pack_orig": [shared, per_block],
                "unzdelta_pack_orig": [shared, per_block],
                "delta_pack_orig": [False, True],  # the zigzag flag
            }
            for name, plist in params.items():
                src = values if name in ENCODE_KERNELS else packed
                for param in plist:
                    want = call_kernel(name, src, param, width, dtype, plain=True)
                    got = call_kernel(name, src, param, width, dtype)
                    torch.cuda.synchronize()
                    err = max_abs_err(got, want)
                    worst[name] = max(worst[name], err)
                    cases[name] += 1
                    if err != 0.0:
                        raise AssertionError(
                            f"kernel {name} disagrees with its plain version: "
                            f"{dtype} W={width} B={CHECK_BLOCKS} max_abs_err={err}")
    edges = hold_orig_edges(values_rng)
    for name, err in edges["max_abs_err"].items():
        worst[name] = max(worst[name], err)
    # an empty batch launches nothing and keeps its shape
    before = dict(ck.LAUNCHES)
    empty = ck.unpack(torch.empty((0, 96), dtype=torch.uint32, device="cuda"), 3, "u32")
    if tuple(empty.shape) != (0, 1024):
        raise AssertionError(f"B=0 unpack gave shape {tuple(empty.shape)}")
    none = torch.empty((0, 1024), dtype=torch.uint32, device="cuda")
    shapes = [tuple(ck.pack(none, 3, "u32").shape),
              tuple(ck.for_pack(none, 7, 3, "u32").shape),
              tuple(ck.delta_pack(none, torch.zeros(32, dtype=torch.uint32, device="cuda"),
                                  3, "u32").shape)]
    nothing = ck.delta_pack_orig(none, 3, "u32")
    shapes += [tuple(nothing[0].shape),
               tuple(ck.undelta_pack_orig(nothing[0], nothing[1], 3, "u32").shape)]
    if shapes != [(0, 96)] * 4 + [(0, 1024)] or tuple(nothing[1].shape) != (0, 32) \
            or ck.LAUNCHES != before:
        raise AssertionError(f"B=0 encode gave shapes {shapes}, launches {ck.LAUNCHES}")
    # the package's public names are the kernel wrappers: on CUDA tensors
    # they launch the kernels, not the plain versions
    probe = torch.from_numpy(values_rng.integers(0, 8, size=(CHECK_BLOCKS, layout.BLOCK),
                                                 dtype=np.uint32)).cuda()
    packed = fastlanes_tpu_torch.pack(probe, 3, "u32")
    back = fastlanes_tpu_torch.unpack(packed, 3, "u32")
    torch.cuda.synchronize()
    if not (ck.LAUNCHES["pack"] == before["pack"] + 1
            and ck.LAUNCHES["unpack"] == before["unpack"] + 1 and same(back, probe)):
        raise AssertionError("fastlanes_tpu_torch.pack / .unpack did not launch the kernels")
    emit({"phase": "kernels", "tolerance": 0, "blocks": CHECK_BLOCKS,
          "cases": cases, "max_abs_err": worst, "orig_edges": edges})
    return worst


def hold_orig_edges(rng) -> dict:
    """The original-order decode of u32 and u64 (`decode_orig_kernel`) bit
    for bit against its plain versions at its edge shapes: W = 0, 1, a
    middle width, T - 1 and T; one block, NB - 1 and NB + 1 blocks (a ragged
    group), 2 * NB + 1 and CHECK_BLOCKS; a per-block base and a shared one
    (base stride 0), each drawn over all T bits."""
    worst = dict.fromkeys(ORIG_DECODE_KERNELS, 0.0)
    cases = 0
    for dtype, nb in ck.ORIG_DECODE_BLOCKS_PER_CTA.items():
        t, nl, np_dt = layout.bit_width(dtype), layout.lanes(dtype), layout.np_dtype(dtype)

        def draw(*shape):
            return torch.from_numpy(rng.integers(
                0, 1 << t, size=shape, dtype=np.uint64).astype(np_dt)).cuda()

        for width in (0, 1, t // 2 + 3, t - 1, t):
            for blocks in sorted({1, nb - 1, nb + 1, 2 * nb + 1, CHECK_BLOCKS}):
                packed = draw(blocks, layout.packed_len(dtype, width))
                per_block = draw(blocks, nl)
                for name, param in (("unpack_orig", None),
                                    ("undelta_pack_orig", per_block),
                                    ("undelta_pack_orig", per_block[-1].clone()),
                                    ("unzdelta_pack_orig", per_block),
                                    ("unzdelta_pack_orig", per_block[-1].clone())):
                    got = call_kernel(name, packed, param, width, dtype)
                    want = call_kernel(name, packed, param, width, dtype, plain=True)
                    torch.cuda.synchronize()
                    err = max_abs_err(got, want)
                    worst[name] = max(worst[name], err)
                    cases += 1
                    if err != 0.0:
                        raise AssertionError(
                            f"{name} {dtype} W={width} B={blocks} base "
                            f"{None if param is None else tuple(param.shape)} disagrees "
                            f"with its plain version: max_abs_err={err}")
    return {"cases": cases, "max_abs_err": worst}


def make_columns(rng, scale: int) -> dict:
    """name -> (values, codec argument, expected chunk codecs or None).
    `scale` divides every size (1 = the full run). The headline is 2^27
    values; ffor, delta and zdelta are 2^25 (the shapes the kernel rows are
    timed at), the other side columns 2^24 (rle and dict were 2^25 until the
    float, table and scan phases took their share of the run's time: their
    host encoders are the slowest part of the encode phase)."""
    n27, n25 = HEADLINE_BLOCKS * layout.BLOCK // scale, (1 << 25) // scale
    n24 = (1 << 24) // scale
    n22 = (1 << 22) // scale
    run_lengths = rng.integers(200, 3000, size=n24 // 200)
    run_values = rng.integers(0, 1 << 30, size=run_lengths.size, dtype=np.uint32)
    dictionary = rng.integers(1 << 24, 1 << 31, size=200, dtype=np.uint32)
    nullable = rng.integers(1000, 5000, size=n22 + 777, dtype=np.uint32)
    return {
        "headline_u32_w3": (rng.integers(0, 8, size=n27, dtype=np.uint32),
                            "bitpack", {"bitpack"}),
        "ffor_u32": (rng.integers(0, 1000, size=n25, dtype=np.uint32)
                     + np.uint32(1_000_000_000), "auto", {"ffor"}),
        "delta_u32": (np.sort(rng.integers(0, 1 << 31, size=n25, dtype=np.uint32)),
                      "auto", {"delta"}),
        "zdelta_u32": ((1_000_000_000 + np.cumsum(
            rng.integers(-500, 500, size=n25))).astype(np.uint32),
            "auto", {"zdelta"}),
        "rle_u32": (np.repeat(run_values, run_lengths)[:n24], "auto", {"rle"}),
        "dict_u32": (dictionary[rng.integers(0, 200, size=n24)], "auto", {"dict"}),
        "timestamps_u64": (np.uint64(1_700_000_000_000_000) + np.cumsum(
            rng.integers(1, 1000, size=n24, dtype=np.uint64)), "auto", {"delta"}),
        "signed_i32": (rng.integers(-50, 50, size=n24).astype(np.int32), "auto", None),
        "small_u16": (rng.integers(0, 1 << 9, size=n24, dtype=np.uint16), "auto", None),
        "small_u8": (rng.integers(0, 1 << 5, size=n24, dtype=np.uint8), "auto", None),
        "nullable_u32": (np.ma.MaskedArray(
            nullable, mask=rng.random(nullable.size) < 0.1), "auto", None),
    }


def read_and_check(path: str, device) -> dict:
    """One column through read_file_device, held against the host reader."""
    t0 = time.perf_counter()
    got = fio_device.read_file_device(path, device=device)
    if torch.device(device or "cuda").type == "cuda":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    host = fio.read_file(path)
    if isinstance(host, np.ma.MaskedArray):
        if not isinstance(got, fio_device.NullableColumn):
            raise AssertionError(f"{path}: nullable column came back as {type(got)}")
        ok = (np.array_equal(got.valid.cpu().numpy(), ~np.ma.getmaskarray(host))
              and np.array_equal(got.values.cpu().numpy(), host.data)
              and got.values.cpu().numpy().dtype == host.dtype)
        n = host.size
    else:
        ok = same(got, torch.from_numpy(host).to(got.device))
        n = host.size
    if not ok:
        raise AssertionError(f"{path}: device read differs from the host read")
    return {"values": int(n), "dtype": str(host.dtype), "read_seconds": seconds}


def equal_width_runs(header: dict) -> int:
    """Runs of consecutive chunks with the same (codec, width): the launches
    a whole-file read of a single-codec file makes."""
    sigs = [(c["codec"], c["width"]) for c in header["chunks"]]
    return sum(1 for i, sig in enumerate(sigs) if i == 0 or sigs[i - 1] != sig)


def unpack_orig_of_headline(path: str, device) -> None:
    """`unpack_orig` has no reader that calls it (bitpack chunks are stored
    in file order), so it is driven through the package's public name on the
    headline file's packed words; the first and last ORACLE_BLOCKS blocks
    are held against the oracle's unpack + untranspose on the host."""
    header = fio.read_header(path)
    widths = {c["width"] for c in header["chunks"]}
    if {c["codec"] for c in header["chunks"]} != {"bitpack"} or len(widths) != 1:
        raise AssertionError(f"headline chunks: {widths}")
    w, dtype = widths.pop(), header["dtype"]
    plen = layout.packed_len(dtype, w)
    base_off = fio._payload_base(path)
    with open(path, "rb") as f:
        parts = []
        for c in header["chunks"]:
            f.seek(base_off + c["offset"])
            parts.append(np.frombuffer(f.read(c["nbytes"]), layout.np_dtype(dtype),
                                       count=c["n_blocks"] * plen))
    words = np.concatenate(parts).reshape(-1, plen)
    got = fastlanes_tpu_torch.unpack_orig(torch.from_numpy(words).to(device), w, dtype)
    n = min(ORACLE_BLOCKS, words.shape[0])
    for lo in (0, words.shape[0] - n):
        want = npref.untranspose(npref.unpack(words[lo:lo + n], w, dtype), dtype)
        if not np.array_equal(got[lo:lo + n].cpu().numpy(), want):
            raise AssertionError(f"unpack_orig of blocks [{lo}, {lo + n}) differs "
                                 "from the oracle")
    if tuple(got.shape) != (header["n_blocks"], layout.BLOCK):
        raise AssertionError(f"unpack_orig gave shape {tuple(got.shape)}")


def phase_read(columns: dict, tmp: str, device=None) -> dict:
    """The read path: write every column of `make_columns`, then read each on
    the device with the launch counts reset just before and read just after.
    Original-order reads must come from the fused kernels alone (no gather
    pass), and ffor chunks must decode one launch per run of equal width."""
    paths, report = {}, {}
    # (a rehearsal on the CPU takes the plain versions, gathers included)
    on_card = eng.resolve_device(device).type == "cuda"
    t0 = time.perf_counter()
    for name, (values, codec, expect) in columns.items():
        path = os.path.join(tmp, name + ".flt")
        header = fio.write_file(path, values, codec=codec)
        codecs = {c["codec"] for c in header["chunks"]}
        if expect is not None and codecs != expect:
            raise AssertionError(f"{name}: writer chose {codecs}, meant {expect}")
        back = fio.read_file(path)
        present = ~np.ma.getmaskarray(values)  # nulls read back as fillers
        if not (np.array_equal(np.ma.getmaskarray(back), ~present) and np.array_equal(
                np.ma.getdata(back)[present], np.ma.getdata(values)[present])):
            raise AssertionError(f"{name}: host read differs from the values written")
        paths[name] = path
        report[name] = {"codecs": sorted(codecs), "chunks": len(header["chunks"]),
                        "file_bytes": os.path.getsize(path)}
    write_seconds = time.perf_counter() - t0

    ck.reset_launches()
    t0 = time.perf_counter()
    with count_gathers() as gathers:
        for name, path in paths.items():
            before = dict(ck.LAUNCHES)
            report[name].update(read_and_check(path, device))
            report[name]["launches"] = {k: v - before[k] for k, v in ck.LAUNCHES.items()
                                        if v != before[k]}
        unpack_orig_of_headline(paths["headline_u32_w3"], eng.resolve_device(device))
        n_gathers = gathers[0]
    for name, kernel in (("delta_u32", "undelta_pack_orig"), ("timestamps_u64",
                         "undelta_pack_orig"), ("zdelta_u32", "unzdelta_pack_orig"),
                         ("rle_u32", "undelta_pack_orig")):
        if on_card and report[name]["launches"].get(kernel, 0) == 0:
            raise AssertionError(f"{name}: the read launched no {kernel} kernel: "
                                 f"{report[name]['launches']}")
    if on_card and (n_gathers or ck.LAUNCHES["undelta_pack"]
                    or ck.LAUNCHES["unzdelta_pack"]):
        raise AssertionError(f"the original-order reads made {n_gathers} gather passes "
                             f"and transposed-order launches {ck.LAUNCHES}")
    ffor_header = fio.read_header(paths["ffor_u32"])
    ffor_runs = equal_width_runs(ffor_header)
    if on_card and report["ffor_u32"]["launches"] != {"unfor_pack": ffor_runs}:
        raise AssertionError(f"ffor_u32: {len(ffor_header['chunks'])} chunks in "
                             f"{ffor_runs} runs of equal width decoded with "
                             f"{report['ffor_u32']['launches']}")
    report["ffor_u32"]["equal_width_runs"] = ffor_runs
    # a block range that crosses chunk boundaries
    header = fio.read_header(paths["delta_u32"])
    cb, n = header["chunk_blocks"], header["n_blocks"]
    start, stop = max(0, min(cb, n // 2) - 24), min(n, 3 * cb + 28)
    got = fio_device.read_blocks_device(paths["delta_u32"], start, stop, device=device)
    want = fio.read_blocks(paths["delta_u32"], start, stop)
    if not same(got, torch.from_numpy(want).to(got.device)):
        raise AssertionError("read_blocks_device range differs from the host read")
    launches, by_dtype = launch_counts()
    read_seconds = time.perf_counter() - t0
    emit({"phase": "read", "tolerance": 0, "columns": report,
          "range": [start, stop], "launches": launches, "gather_passes": n_gathers,
          "unfor_pack_launches": launches["unfor_pack"],
          "write_seconds": write_seconds, "read_and_compare_seconds": read_seconds})
    return {"paths": paths, "launches": launches, "by_dtype": by_dtype}


class largest_launches:
    """While active, keeps per kernel the arguments of the largest launch
    made: the shapes a path gives a kernel. `seen[name]` holds the source
    tensor, base, reference, width and dtype of that launch (the zigzag form
    of delta_pack_orig under `delta_pack_orig_zigzag`). With `per_dtype`
    the largest launch of every (kernel, dtype) pair is kept, under
    `seen[name, dtype]`. `launched` lists every launch made since the last
    reset of the launch counts, in order (a call that launches nothing is
    left out): see `by_width`."""

    def __init__(self, per_dtype: bool = False):
        self.seen = {}
        self.per_dtype = per_dtype
        self.launched = []

    def by_width(self, counted: dict) -> dict:
        """{(name, dtype, width): {"blocks": [...], "forms": {(base form,
        reference form): n}}} over the first `counted[kernel]` launches of
        each kernel: the launches a path counted before it read its counts
        (a path checks its results after that, with more launches)."""
        out, seen = {}, {}
        for kernel, name, dtype, width, blocks, form in self.launched:
            seen[kernel] = seen.get(kernel, 0) + 1
            if seen[kernel] > counted.get(kernel, 0):
                continue
            rec = out.setdefault((name, dtype, width), {"blocks": [], "forms": {}})
            rec["blocks"].append(blocks)
            rec["forms"][form] = rec["forms"].get(form, 0) + 1
        short = {k: n for k, n in counted.items() if seen.get(k, 0) < n}
        if short:
            raise AssertionError(f"launches counted but not seen by the hook: {short}")
        return out

    def __enter__(self):
        self.real = ck._launch

        def spy(name, src2d, base, reference, width, dtype, zigzag=False):
            size = src2d.numel() * src2d.element_size()
            kname = name + "_zigzag" if zigzag else name
            key = (kname, dtype) if self.per_dtype else kname
            if key not in self.seen or size > self.seen[key]["src_bytes"]:
                self.seen[key] = {"src": src2d, "base": base, "reference": reference,
                                  "width": width, "dtype": dtype, "src_bytes": size}
            before = ck.LAUNCHES[name]
            out = self.real(name, src2d, base, reference, width, dtype, zigzag=zigzag)
            if ck.LAUNCHES[name] != before:
                form = (operand_form(base, "base"), operand_form(
                    reference if name in ("unfor_pack", "for_pack") else None, "reference"))
                self.launched.append((name, kname, dtype, width, src2d.shape[0], form))
            return out

        def reset():  # the counts restart: so does the list
            self.launched.clear()
            self.real_reset()

        self.real_reset = ck.reset_launches
        ck._launch, ck.reset_launches = spy, reset
        return self.seen

    def __exit__(self, *exc):
        ck._launch, ck.reset_launches = self.real, self.real_reset
        return False


def hold_path_shapes(path: str, seen: dict) -> dict:
    """Every (kernel, dtype) launch recorded on a driven path (the largest
    of each pair, `largest_launches(per_dtype=True)`): the wrapper against
    its plain version on those very tensors, bit for bit, or the run fails.
    Called after the path's launch counts were read, so these launches are
    not counted. Returns kernel -> the shapes held, and empties `seen`."""
    shapes = {}
    for (key, dtype), rec in sorted(seen.items(), key=lambda kv: kv[0]):
        zigzag = key.endswith("_zigzag")
        name = key[:-len("_zigzag")] if zigzag else key
        if name in ("unfor_pack", "for_pack"):
            param = rec["reference"]
        elif name == "delta_pack_orig":
            param = zigzag
        else:
            param = rec["base"]
        got = call_kernel(name, rec["src"], param, rec["width"], dtype)
        want = call_kernel(name, rec["src"], param, rec["width"], dtype, plain=True)
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        shape = {"dtype": dtype, "width": rec["width"], "blocks": rec["src"].shape[0],
                 "base": None if rec["base"] is None else list(rec["base"].shape),
                 "reference": "per block" if isinstance(rec["reference"], torch.Tensor)
                 else None, "max_abs_err": err}
        if zigzag:
            shape["zigzag"] = True
        if err != 0.0:
            raise AssertionError(f"kernel {name} disagrees with its plain version at a "
                                 f"shape of the {path} path: {shape}")
        shapes.setdefault(name, []).append(shape)
        del got, want
    seen.clear()
    return shapes


# ---------------------------------------------------------------------------
# the encode path


#: column -> the entry the encode phase drives it through: the codec class
#: (width from the device max probe), `get_codec`, or `auto_encode`
ENCODE_COLUMNS = {
    "headline_u32_w3": "BitPackedCodec", "ffor_u32": "auto_encode",
    "delta_u32": "auto_encode", "zdelta_u32": "auto_encode", "rle_u32": "auto_encode",
    "dict_u32": "auto_encode", "timestamps_u64": "auto_encode",
    "small_u16": "get_codec", "small_u8": "get_codec",
}

_DTYPE_OF = {v: k for k, v in eng.UNSIGNED.items()}


def encoder_of(how: str, dtype: str):
    if how == "auto_encode":
        return lambda values: codecs.auto_encode(values, dtype, device=values.device)
    codec = (codecs.BitPackedCodec(dtype) if how == "BitPackedCodec"
             else codecs.get_codec("bitpack", dtype))
    return lambda values: codec.encode(values, device=values.device)


def oracle_check(name: str, enc, blocks: np.ndarray, lo: int) -> None:
    """The payload and params of blocks [lo, lo + len(blocks)) of `enc`
    against the NumPy oracle run on the host over those blocks."""
    dt, w = enc.dtype, enc.width
    hi = lo + blocks.shape[0]
    payload = enc.payload[lo:hi].cpu().numpy()

    def host(key, a=None, b=None):
        return enc.params[key][a:b].cpu().numpy()

    if enc.codec == "bitpack":
        want = npref.pack(blocks, w, dt)
    elif enc.codec == "ffor":
        want = npref.for_pack(blocks, enc.params["reference"], w, dt)
    elif enc.codec in ("delta", "zdelta"):
        _, base, deltas = fio._delta_parts(blocks, dt, native.available())
        if enc.codec == "zdelta":
            deltas = fio._zigzag_deltas(deltas)
        want = npref.pack(deltas, w, dt)
        if not np.array_equal(host("base", lo, hi), base):
            raise AssertionError(f"{name}: base of blocks [{lo}, {hi}) differs from the oracle")
    elif enc.codec == "rle":
        counts, run_values, idx = fio._rle_parts(blocks)
        _, base, deltas = fio._delta_parts(idx, "u16", native.available())
        want = npref.pack(deltas, 1, "u16")
        all_counts = host("counts")
        start = int(all_counts[:lo].sum())
        ok = (np.array_equal(all_counts[lo:hi], counts)
              and np.array_equal(host("base", lo, hi), base)
              and np.array_equal(host("run_values", start, start + run_values.size),
                                 run_values))
        if not ok:
            raise AssertionError(f"{name}: rle params of blocks [{lo}, {hi}) differ")
    elif enc.codec == "dict":
        dictionary = host("dictionary")
        found = np.searchsorted(dictionary, blocks)
        if not (np.all(np.diff(dictionary.astype(np.float64)) > 0)
                and np.array_equal(dictionary[np.minimum(found, dictionary.size - 1)], blocks)):
            raise AssertionError(f"{name}: dictionary is not the sorted distinct values")
        want = npref.pack(found.astype(np.uint16), w, "u16")
    else:
        raise AssertionError(f"{name}: unexpected codec {enc.codec}")
    if payload.dtype != want.dtype or not np.array_equal(payload, want):
        raise AssertionError(f"{name}: payload of blocks [{lo}, {hi}) differs from the oracle")


def phase_encode(columns: dict, device=None) -> dict:
    """The encode path: each column, moved to the card once, through its
    codec class; launch counts reset just before and read just after. Every
    Encoded is decoded by its codec and compared bit for bit with the input."""
    device = eng.resolve_device(device)
    on_card = device.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    dev, report = {}, {}
    for name in ENCODE_COLUMNS:
        values = columns[name][0]
        dev[name] = torch.from_numpy(values.reshape(-1, layout.BLOCK)).to(device)
    sync()

    ck.reset_launches()
    encoded = {}
    t0 = time.perf_counter()
    with largest_launches() as seen, count_gathers() as gathers:
        for name, how in ENCODE_COLUMNS.items():
            values = dev[name]
            dtype = _DTYPE_OF[values.dtype]
            before = dict(ck.LAUNCHES)
            t1 = time.perf_counter()
            enc = encoder_of(how, dtype)(values)
            sync()
            seconds = time.perf_counter() - t1
            encoded[name] = enc
            report[name] = {
                "dtype": dtype, "blocks": enc.n_blocks, "codec": enc.codec,
                "width": enc.width, "packed_bytes": enc.packed_bytes,
                "ratio": enc.compression_ratio, "encode_seconds": seconds,
                "launches": {k: v - before[k] for k, v in ck.LAUNCHES.items()
                             if v != before[k]}}
    launches, by_dtype = launch_counts()
    encode_seconds = time.perf_counter() - t0
    if on_card and (gathers[0] or launches["delta_pack"]):
        raise AssertionError(f"the encodes made {gathers[0]} transpose gather passes "
                             f"and launched {launches}")
    for name in ("delta_u32", "zdelta_u32", "rle_u32", "timestamps_u64"):
        if on_card and report[name]["launches"].get("delta_pack_orig", 0) != 1:
            raise AssertionError(f"{name}: {report[name]['launches']}")

    for name, how in ENCODE_COLUMNS.items():
        values, enc = dev[name], encoded[name]
        _, _, expect = columns[name]
        if enc.payload.device != values.device:
            raise AssertionError(f"{name}: payload lies on {enc.payload.device}")
        if how == "auto_encode":
            if expect is not None and {enc.codec} != expect:
                raise AssertionError(f"{name}: auto_encode chose {enc.codec}, meant {expect}")
            cost = codecs.auto_costs(values, enc.dtype, device=values.device)[enc.codec]
            if enc.packed_bytes != cost:
                raise AssertionError(f"{name}: packed_bytes {enc.packed_bytes} != "
                                     f"auto_costs' {cost}")
        elif enc.codec != "bitpack":
            raise AssertionError(f"{name}: {enc.codec}")
        back = codecs.get_codec(enc.codec, enc.dtype).decode(enc)
        sync()
        if not same(back, values):
            raise AssertionError(f"{name}: decode(encode(values)) differs from the values")
        del back
        n = min(ORACLE_BLOCKS, enc.n_blocks)
        host = columns[name][0].reshape(-1, layout.BLOCK)
        oracle_check(name, enc, host[:n], 0)
        oracle_check(name, enc, host[enc.n_blocks - n:], enc.n_blocks - n)
    want_w = int(columns["headline_u32_w3"][0].max()).bit_length()
    if encoded["headline_u32_w3"].width != want_w:
        raise AssertionError(f"headline width {encoded['headline_u32_w3'].width}, "
                             f"meant {want_w}")
    # random access into the headline payload, on the device
    idx = np.array([0, 1, 517, 1023])
    got = codecs.BitPackedCodec("u32").decode_single(encoded["headline_u32_w3"], idx)
    # (indexed on the signed view: the unsigned dtypes have no index kernel)
    want = eng.from_vec(eng.take_cols(eng.to_vec(dev["headline_u32_w3"], "u32"),
                                      torch.from_numpy(idx).to(device), "u32"), "u32")
    if not same(got, want):
        raise AssertionError("decode_single differs from the values")
    emit({"phase": "encode", "tolerance": 0, "columns": report, "launches": launches,
          "gather_passes": gathers[0],
          "oracle_blocks_each_end": ORACLE_BLOCKS, "encode_seconds": encode_seconds})
    return {"device_columns": dev, "launches": launches, "by_dtype": by_dtype, "seen": seen,
            "encoded": encoded}


def phase_transposed(encode_state: dict) -> dict:
    """The transposed-order delta entries, which no codec class calls any
    more: a caller that keeps its blocks in transposed order reaches them by
    their public names. On the encoded delta and zdelta columns they must
    give the transpose of the values, and `delta_pack` the payload again."""
    encoded, dev = encode_state["encoded"], encode_state["device_columns"]
    ck.reset_launches()
    with largest_launches() as seen:
        for name, decode in (("delta_u32", fastlanes_tpu_torch.undelta_pack),
                             ("zdelta_u32", kernels.unzdelta_pack),
                             ("timestamps_u64", fastlanes_tpu_torch.undelta_pack)):
            enc = encoded[name]
            if enc.codec != ("zdelta" if name == "zdelta_u32" else "delta"):
                raise AssertionError(f"{name}: {enc.codec}")
            got = decode(enc.payload, enc.params["base"], enc.width, enc.dtype)
            # (the transpose is a plain gather: it counts as no launch)
            want = fastlanes_tpu_torch.transpose(dev[name], enc.dtype)
            if not same(got, want):
                raise AssertionError(f"{name}: transposed-order decode differs from "
                                     "the transpose of the values")
            if enc.codec == "delta":
                again = fastlanes_tpu_torch.delta_pack(want, enc.params["base"], enc.width,
                                                       enc.dtype)
                if not same(again, enc.payload):
                    raise AssertionError(f"{name}: delta_pack differs from the payload")
            del got, want
    launches, by_dtype = launch_counts()
    emit({"phase": "transposed", "tolerance": 0, "launches": launches})
    return {"launches": launches, "by_dtype": by_dtype, "seen": seen}


# ---------------------------------------------------------------------------
# float columns, tables, many files, scans (tolerance 0 throughout)


def operand_form(operand, role: str):
    """How a launch took its base or reference (`role`): None, "scalar" (a
    Python int reference), "shared" (one (LANES,) base for every block) or
    "per block" (a (B, LANES) base, a (B,) reference)."""
    if operand is None:
        return None
    if not isinstance(operand, torch.Tensor):
        return "scalar"
    return "shared" if role == "base" and operand.ndim == 1 else "per block"


def sync_if_cuda(device) -> None:
    if eng.resolve_device(device).type == "cuda":
        torch.cuda.synchronize()


def launches_since(before: dict) -> dict:
    return {k: v - before[k] for k, v in ck.LAUNCHES.items() if v != before[k]}


def launch_counts():
    """The launch counts since the last reset: per kernel, and per kernel the
    launches by dtype ({kernel: {dtype: n}}), read at one moment."""
    by_dtype = {}
    for (name, dtype), n in sorted(ck.LAUNCHES_BY_DTYPE.items()):
        by_dtype.setdefault(name, {})[dtype] = n
    return dict(ck.LAUNCHES), by_dtype


def float_bits(arr: np.ndarray) -> np.ndarray:
    """A float array as its unsigned bit pattern (NaN payloads, signed zero)."""
    return np.ascontiguousarray(arr).view(f"uint{arr.dtype.itemsize * 8}")


def same_host(got, host) -> bool:
    """A device result (tensor, StringColumn or NullableColumn) against the
    host reader's array: same mask, and the same bytes wherever the mask does
    not hide them. Logical dtypes (dates, bools) compare on their storage."""
    if isinstance(host, np.ma.MaskedArray):
        if not isinstance(got, fio_device.NullableColumn):
            return False
        mask = np.ma.getmaskarray(host)
        if not np.array_equal(got.valid.cpu().numpy(), ~mask):
            return False
        got, host = got.values, np.ma.getdata(host)
    else:
        mask = None
    if isinstance(got, fio_table.StringColumn):
        arr = got.materialize()
    else:
        arr = got.cpu().numpy()
    if arr.shape != host.shape:
        return False
    if host.dtype.kind in "mM":
        host = host.view(np.int64)
    elif host.dtype.kind == "b":
        arr = arr.astype(bool)
    if arr.dtype != host.dtype:
        return False
    if host.dtype.kind == "f":
        arr, host = float_bits(arr), float_bits(host)
    if mask is not None:
        return bool(np.array_equal(arr[~mask], host[~mask]))
    return bool(np.array_equal(arr, host))


def division_inputs(rng, d: int, np_float) -> np.ndarray:
    """The integers of the division proof for exponent d. f32: EVERY integer
    of the encoder's range (|i| < 2^24). f64: 2^20 random integers over all
    magnitudes up to 2^52, plus the adversarial ones: 0, +-1, the bounds,
    powers of two +-1, multiples of 5^d +-1 and near-halfway quotients."""
    if np_float is np.float32:
        bound = (1 << 24) - 1
        return np.arange(-bound, bound + 1, dtype=np.int64)
    bound, n = 1 << 52, 1 << 20
    mag = rng.integers(0, 53, n)
    i = np.clip(rng.integers(0, 1 << 62, n, dtype=np.int64) >> (62 - mag), 0, bound)
    i *= rng.integers(0, 2, n, dtype=np.int64) * 2 - 1
    five = 5 ** d
    hard = [0, 1, -1, bound, -bound, bound - 1, 1 - bound]
    for k in range(1, 53):
        hard += [(1 << k) - 1, (1 << k) + 1, -(1 << k) - 1, 1 - (1 << k)]
    mult = rng.integers(1, max(2, bound // five), 4096)
    for m in mult.tolist():
        hard += [m * five - 1, m * five, m * five + 1, -m * five + 1]
    k = five.bit_length()
    for m in rng.integers(1 << 52, 1 << 53, 4096, dtype=np.int64).tolist():
        cand = (m * five) >> (k + 1)  # i / 5^d close to a rounding boundary
        hard += [cand - 1, cand, cand + 1, -cand]
    hard = np.array([h for h in hard if abs(h) <= bound], np.int64)
    return np.concatenate([i, hard])


def float_columns(rng, scale: int) -> dict:
    """name -> (values, expected chunk codecs) of the float files."""
    n25, n24 = (1 << 25) // scale, (1 << 24) // scale
    price = np.round(rng.uniform(0, 100_000, n25), 2)
    price[[7, n25 // 3, n25 // 2, n25 - 5]] = [np.nan, np.inf, -np.inf, -0.0]
    ratio = np.round(rng.uniform(-100, 100, n25), 1).astype(np.float32)
    ratio[[11, n25 // 2 + 1]] = [np.nan, -0.0]
    return {"price_f64": (price, {"alp"}), "ratio_f32": (ratio, {"alp"}),
            "noise_f64": (rng.standard_normal(n24) * 1e3, {"alprd"})}


def phase_alp(tmp: str, scale: int, device=None) -> dict:
    """(a) The division proof: decode_device is `ints.to(dtype) / 10^d`, one
    IEEE division on the card; for every exponent d its bits must equal the
    host spec's (decode_np) on every integer tried. (b) Float files written
    by the host writer, read on the card, equal to the host reader bit for
    bit; ALPCodec round trip on the card."""
    device = eng.resolve_device(device)
    rng = np.random.default_rng(SEED + 3)
    proof = {}
    for np_float, max_d in ((np.float32, 10), (np.float64, 18)):
        tried = 0
        for d in range(max_d + 1):
            ints = division_inputs(rng, d, np_float)
            if scale > 1:
                ints = ints[::scale]
            reference = int(ints.min())
            shifted = (ints - reference).astype(
                np.uint32 if np_float is np.float32 else np.uint64)
            got = alp.decode_device(torch.from_numpy(shifted).to(device), d, 0, reference,
                                    np_float)
            want = alp.decode_np(shifted, d, 0, reference, np_float)
            bad = float_bits(got.cpu().numpy()) != float_bits(want)
            if bad.any():
                at = int(np.flatnonzero(bad)[0])
                raise AssertionError(
                    f"ALP division proof failed: {np.dtype(np_float).name} d={d}: "
                    f"{int(bad.sum())} of {ints.size} differ, first i={int(ints[at])} "
                    f"card={got.reshape(-1)[at].item()!r} host={want[at]!r}")
            tried += ints.size
        proof[np.dtype(np_float).name] = {"exponents": max_d + 1, "integers": tried}

    columns = float_columns(rng, scale)
    report, paths = {}, {}
    ck.reset_launches()
    for name, (values, expect) in columns.items():
        path = os.path.join(tmp, name + ".flt")
        t0 = time.perf_counter()
        header = fio.write_file(path, values)
        write_seconds = time.perf_counter() - t0
        found = {c["codec"] for c in header["chunks"]}
        if found != expect:
            raise AssertionError(f"{name}: writer chose {found}, meant {expect}")
        host = fio.read_file(path)
        if not np.array_equal(float_bits(host), float_bits(values)):
            raise AssertionError(f"{name}: host read differs from the values written")
        before = dict(ck.LAUNCHES)
        t0 = time.perf_counter()
        got = fio_device.read_file_device(path, device=device)
        sync_if_cuda(device)
        read_seconds = time.perf_counter() - t0
        if not same_host(got, host):
            raise AssertionError(f"{name}: device read differs from the host read")
        n = header["n_blocks"]
        start, stop = n // 3 - 5, n // 3 + header["chunk_blocks"] + 9
        part = fio_device.read_blocks_device(path, start, stop, device=device)
        if not same_host(part, fio.read_blocks(path, start, stop)):
            raise AssertionError(f"{name}: block range differs from the host read")
        paths[name] = path
        report[name] = {"values": int(values.size), "dtype": str(values.dtype),
                        "codecs": sorted(found), "chunks": len(header["chunks"]),
                        "file_bytes": os.path.getsize(path),
                        "write_seconds": write_seconds, "read_seconds": read_seconds,
                        "launches": launches_since(before)}
        del got, part, host
    # the codec class, both ways on the card
    for vtype, column in (("f64", "price_f64"), ("f32", "ratio_f32")):
        values = columns[column][0][:min(1 << 22, columns[column][0].size)]
        values = values.reshape(-1, layout.BLOCK)
        codec = codecs.get_codec("alp", vtype)
        before = dict(ck.LAUNCHES)
        enc = codec.encode(values, device=device)
        back = codec.decode(enc)
        sync_if_cuda(device)
        if back.device != enc.payload.device or not np.array_equal(
                float_bits(back.cpu().numpy()), float_bits(values)):
            raise AssertionError(f"ALPCodec({vtype}): decode(encode(values)) differs")
        report["codec_" + vtype] = {"blocks": enc.n_blocks, "width": enc.width,
                                    "exceptions": int(len(enc.params["exc_pos"])),
                                    "ratio": enc.compression_ratio,
                                    "launches": launches_since(before)}
    launches, by_dtype = launch_counts()
    emit({"phase": "alp", "tolerance": 0, "division": "one IEEE division per value "
          "(torch `/` on the card), bits equal to the host spec for every integer tried",
          "division_proof": proof, "columns": report, "launches": launches})
    return {"paths": paths, "launches": launches, "by_dtype": by_dtype, "columns": columns}


TABLE_WORDS = np.array(sorted(
    "AUD BRL CAD CHF CNY CZK DKK EUR GBP HKD HUF ILS INR JPY KRW MXN NOK NZD PLN "
    "SEK SGD THB USD ZAR".split()))


def table_columns(rng, scale: int) -> dict:
    """The table of the `table` and `scan` phases: 2^24 + 777 rows (ragged),
    columns that take every codec between them."""
    n = (1 << 24) // scale + 777
    steps = rng.integers(1, 1000, n).astype(np.uint64)
    visits = np.cumsum(rng.integers(0, 9, n)).astype(np.uint32)
    return {
        "key": np.uint64(1_700_000_000_000_000) + np.cumsum(steps),    # sorted: delta
        "day": (np.datetime64("2015-01-01") + rng.integers(0, 3650, n)).astype("datetime64[D]"),
        "change": rng.integers(-50, 50, n).astype(np.int32),          # zigzag transform
        "qty": rng.integers(0, 1000, n).astype(np.uint32) + np.uint32(1_000_000_000),  # ffor
        "cur": TABLE_WORDS[rng.integers(0, TABLE_WORDS.size, n)],      # strings: dict codes
        "price": np.round(rng.uniform(0, 100_000, n), 2),              # f64: alp
        "ratio": np.round(rng.uniform(-100, 100, n), 1).astype(np.float32),  # f32: alp
        # nullable AND sorted: delta chunks under a validity bitmap
        "visits": np.ma.MaskedArray(visits, mask=rng.random(n) < 0.1),
    }


def phase_table(tmp: str, scale: int, device=None) -> dict:
    """One table file, every column through read_column_device: whole, and
    over a block range that crosses chunk boundaries; each equal to the host
    read_column."""
    device = eng.resolve_device(device)
    columns = table_columns(np.random.default_rng(SEED + 4), scale)
    path = os.path.join(tmp, "table.flt")
    t0 = time.perf_counter()
    header = fio_table.write_table(path, columns)
    write_seconds = time.perf_counter() - t0
    found = {c["codec"] for col in header["columns"].values() for c in col["chunks"]}
    if not {"delta", "ffor", "alp"} <= found:
        raise AssertionError(f"table codecs {found}")
    if header["columns"]["change"].get("transform") != "zigzag" \
            or header["columns"]["cur"]["str_dict"]["n_dict"] < 16 \
            or {c["codec"] for c in header["columns"]["visits"]["chunks"]} != {"delta"}:
        raise AssertionError("table columns are not what the phase means to drive")
    report = {}
    ck.reset_launches()
    for name in columns:
        col = header["columns"][name]
        host = fio_table.read_column(path, name)
        before = dict(ck.LAUNCHES)
        t0 = time.perf_counter()
        got = fio_device.read_column_device(path, name, device=device)
        sync_if_cuda(device)
        seconds = time.perf_counter() - t0
        if not same_host(got, host):
            raise AssertionError(f"table column {name}: device read differs from read_column")
        present = ~np.ma.getmaskarray(columns[name])
        if not np.array_equal(np.ma.getdata(host)[present], np.ma.getdata(columns[name])[present]):
            raise AssertionError(f"table column {name}: host read differs from the values")
        whole = launches_since(before)
        cb, n = col["chunk_blocks"], col["n_blocks"]
        start, stop = max(0, min(cb, n // 2) - 24), min(n, 2 * cb + 28)
        part = fio_device.read_column_device(path, name, start, stop, device=device)
        if not same_host(part, fio_table.read_column(path, name, start, stop)):
            raise AssertionError(f"table column {name}: range [{start}, {stop}) differs")
        report[name] = {"codecs": sorted({c["codec"] for c in col["chunks"]}),
                        "chunks": len(col["chunks"]), "dtype": col["dtype"],
                        "vtype": col.get("vtype"), "transform": col.get("transform"),
                        "read_seconds": seconds, "launches": whole, "range": [start, stop]}
        del got, part, host
    launches, by_dtype = launch_counts()
    emit({"phase": "table", "tolerance": 0, "rows": len(columns["key"]),
          "file_bytes": os.path.getsize(path), "write_seconds": write_seconds,
          "columns": report, "launches": launches})
    return {"path": path, "columns": columns, "launches": launches, "by_dtype": by_dtype}


def phase_files(tmp: str, scale: int, device=None) -> dict:
    """16 shard files of one codec and 4 of another through read_files_device
    (ONE launch per (dtype, signature) group, whichever file a chunk came
    from) and through iter_files_device; each equal to the host read_file."""
    device = eng.resolve_device(device)
    rng = np.random.default_rng(SEED + 5)
    n = (1 << 22) // scale
    shards, others, hosts = [], [], {}
    for i in range(16):
        path = os.path.join(tmp, f"shard{i:02d}.flt")
        fio.write_file(path, rng.integers(0, 1 << 11, n, dtype=np.uint32), codec="bitpack")
        shards.append(path)
    for i in range(4):
        path = os.path.join(tmp, f"other{i}.flt")
        values = rng.integers(0, 1000, n, dtype=np.uint32)
        values[::1 << 12] = 0  # every chunk spans the whole range: one width,
        values[1::1 << 12] = 999  # so the four files form ONE signature group
        fio.write_file(path, values + np.uint32(1_000_000 * (i + 1)), codec="ffor")
        others.append(path)
    paths = shards + others
    groups = set()
    for path in paths:
        header = fio.read_header(path)
        groups |= {(header["dtype"], fio_device._group_sig(c)) for c in header["chunks"]}
        hosts[path] = fio.read_file(path)
    if len(groups) != 2:
        raise AssertionError(f"the shard files form {len(groups)} signature groups: {groups}")
    ck.reset_launches()
    t0 = time.perf_counter()
    got = fio_device.read_files_device(paths, device=device)
    sync_if_cuda(device)
    batch_seconds = time.perf_counter() - t0
    batch_launches = launches_since({k: 0 for k in ck.LAUNCHES})
    if eng.resolve_device(device).type == "cuda" and \
            batch_launches != {"unpack": 1, "unfor_pack": 1}:
        raise AssertionError(f"read_files_device of 2 signature groups launched {batch_launches}")
    if list(got) != paths or not all(same_host(got[p], hosts[p]) for p in paths):
        raise AssertionError("read_files_device differs from the host reads")
    del got
    before = dict(ck.LAUNCHES)
    t0 = time.perf_counter()
    seen = []
    for path, tensor in fio_device.iter_files_device(paths, device=device):
        if not same_host(tensor, hosts[path]):
            raise AssertionError(f"iter_files_device: {path} differs from the host read")
        seen.append(path)
    sync_if_cuda(device)
    iter_seconds = time.perf_counter() - t0
    if seen != paths:
        raise AssertionError("iter_files_device lost the order of its paths")
    launches, by_dtype = launch_counts()
    emit({"phase": "files", "tolerance": 0, "files": len(paths), "values_each": n,
          "signature_groups": len(groups), "read_files_device": {
              "seconds": batch_seconds, "launches": batch_launches},
          "iter_files_device": {"seconds_with_compare": iter_seconds,
                                "launches": launches_since(before)},
          "launches": launches})
    return {"shards": shards, "others": others, "launches": launches, "by_dtype": by_dtype,
            "shard_values": [hosts[p] for p in shards]}


# -- the scans' NumPy oracle ------------------------------------------------


def exact_int_sum(arr: np.ndarray) -> int:
    """Exact sum as a Python int; 64-bit columns in int64 semantics (the
    scans' convention). Two 32-bit halves, each summed in int64."""
    a = arr.view(np.int64) if arr.dtype.itemsize == 8 else arr.astype(np.int64)
    return (int((a >> 32).sum(dtype=np.int64)) << 32) + int((a & 0xFFFFFFFF).sum(dtype=np.int64))


def oracle_stats(values, dictionary_size=None) -> dict:
    """sum/min/max/count of a column as the scans define them."""
    mask = np.ma.getmaskarray(values)
    vals = np.ma.getdata(values)[~mask].reshape(-1)
    if vals.dtype.kind in "mM":
        vals = vals.view(np.int64)
    if vals.dtype.kind == "U":
        words = vals.tolist()  # numpy has no min/max for strings
        out = {"sum": None, "min": min(words) if words else None,
               "max": max(words) if words else None, "count": len(words),
               "n_dict": dictionary_size}
    elif vals.dtype.kind == "f":
        if np.isnan(vals).any():
            total = mn = mx = float("nan")
        else:
            with np.errstate(invalid="ignore"):
                inf_sum = float(vals[np.isinf(vals)].sum()) if np.isinf(vals).any() else None
            total = inf_sum if inf_sum is not None else math.fsum(vals.tolist())
            mn, mx = float(vals.min()), float(vals.max())
        out = {"sum": total, "min": mn, "max": mx, "count": int(vals.size)} if vals.size \
            else {"sum": 0.0, "min": None, "max": None, "count": 0}
    else:
        if vals.dtype.itemsize == 8:
            vals = vals.view(np.int64)
        out = {"sum": exact_int_sum(vals), "min": int(vals.min()), "max": int(vals.max()),
               "count": int(vals.size)} if vals.size \
            else {"sum": 0, "min": None, "max": None, "count": 0}
    if isinstance(values, np.ma.MaskedArray):
        out["n_null"] = int(mask.sum())
    return out


def same_stats(got, want) -> bool:
    """`==` on two result dicts, with NaN equal to NaN and types held equal."""
    if isinstance(want, dict):
        return isinstance(got, dict) and got.keys() == want.keys() and \
            all(same_stats(got[k], want[k]) for k in want)
    if type(got) is not type(want):
        return False
    if isinstance(want, float) and math.isnan(want):
        return math.isnan(got)
    return got == want


def oracle_mask(values, op: str, probe):
    """NumPy comparison semantics; nulls match nothing."""
    vals = np.ma.getdata(values)
    if vals.dtype.kind == "U":
        fn = {"lt": np.char.less, "le": np.char.less_equal, "gt": np.char.greater,
              "ge": np.char.greater_equal, "eq": np.char.equal, "ne": np.char.not_equal}
        hit = (np.isin(vals, probe) if op in ("in", "notin") else fn[op](vals, probe))
    else:
        if vals.dtype.kind in "mM":
            cast = lambda v: np.array(v, dtype=vals.dtype)
            probe = [cast(v) for v in probe] if op in ("in", "notin") else cast(probe)
        with np.errstate(invalid="ignore"):
            hit = {"lt": lambda: vals < probe, "le": lambda: vals <= probe,
                   "gt": lambda: vals > probe, "ge": lambda: vals >= probe,
                   "eq": lambda: vals == probe, "ne": lambda: vals != probe,
                   "in": lambda: np.isin(vals, probe),
                   "notin": lambda: np.isin(vals, probe)}[op]()
    if op == "notin":
        hit = ~hit
    return hit & ~np.ma.getmaskarray(values)


ALL_OPS = ("lt", "le", "gt", "ge", "eq", "ne", "in", "notin")
ORIG_LAUNCHES = ("unpack_orig", "undelta_pack_orig", "unzdelta_pack_orig")


def counted(fn):
    """fn() with the launches, gather passes and host fetches it made."""
    before = dict(ck.LAUNCHES)
    fetches = analytics.HOST_FETCHES
    with count_gathers() as gathers:
        out = fn()
        n_gathers = gathers[0]
    return out, {"launches": launches_since(before), "gather_passes": n_gathers,
                 "host_fetches": analytics.HOST_FETCHES - fetches}


def phase_scan(read_paths: dict, read_columns: dict, table: dict, files: dict,
               device=None) -> dict:
    """The scans, each answer equal to a NumPy oracle, with the launches
    counted: natural-order kernels on the sorted columns, original-order
    kernels only where a bitmap or a padded tail demands them, and none at
    all for a probe the zone maps resolve."""
    device = eng.resolve_device(device)
    on_card = device.type == "cuda"
    report = {}
    ck.reset_launches()

    def expect(label, got, want):
        if not same_stats(got, want):
            raise AssertionError(f"scan {label}: {got!r} != oracle {want!r}")

    def orig_count(counts):
        return sum(counts["launches"].get(k, 0) for k in ORIG_LAUNCHES)

    # scan_table over the whole table
    tpath, tcols = table["path"], table["columns"]
    got, counts = counted(lambda: analytics.scan_table(tpath, device=device))
    for name, values in tcols.items():
        expect(f"scan_table[{name}]", got[name], oracle_stats(
            values, TABLE_WORDS.size if name == "cur" else None))
    report["scan_table"] = counts
    # ... column by column, for the launch accounting
    per_column = {}
    for name in tcols:
        got, c = counted(lambda: analytics.scan_column(tpath, name, device=device))
        expect(f"scan_column[{name}]", got, oracle_stats(
            tcols[name], TABLE_WORDS.size if name == "cur" else None))
        per_column[name] = c
    report["scan_column_of_table"] = per_column
    if on_card:
        key, visits = per_column["key"], per_column["visits"]
        # the sorted key: natural order for the bulk, the padded tail chunk alone
        # in original order; the nullable sorted column: original order throughout
        if not (key["launches"].get("undelta_pack", 0) >= 1 and orig_count(key) == 1
                and key["gather_passes"] == 0):
            raise AssertionError(f"key column scan: {key}")
        if not (orig_count(visits) >= 1 and visits["gather_passes"] == 0
                and not visits["launches"].get("undelta_pack")):
            raise AssertionError(f"nullable sorted column scan: {visits}")

    # sorted files of whole blocks: natural-order kernels ONLY
    for name, kernel in (("delta_u32", "undelta_pack"), ("zdelta_u32", "unzdelta_pack"),
                         ("timestamps_u64", "undelta_pack")):
        got, c = counted(lambda: analytics.scan_column(read_paths[name], device=device))
        expect(name, got, oracle_stats(read_columns[name][0]))
        if on_card and not (c["launches"].get(kernel, 0) >= 1 and set(c["launches"]) == {kernel}
                            and c["gather_passes"] == 0):
            raise AssertionError(f"{name}: a sorted column of whole blocks must scan with "
                                 f"{kernel} alone: {c}")
        report["scan_column_" + name] = c
    for name in ("headline_u32_w3", "nullable_u32", "signed_i32", "small_u8"):
        got, c = counted(lambda: analytics.scan_column(read_paths[name], device=device))
        expect(name, got, oracle_stats(read_columns[name][0]))
        report["scan_column_" + name] = c
    # the 16 shards as one dataset
    shard_values = np.concatenate(files["shard_values"])
    got, c = counted(lambda: analytics.scan_column(files["shards"], device=device))
    expect("shards", got, oracle_stats(shard_values))
    report["scan_column_shards"] = c

    # count_where: all eight operators on an integer, a float, a date and a
    # string column
    probes = {"qty": (1_000_000_500, [1_000_000_001, 1_000_000_999, 5]),
              "price": (50_000.25, [float(tcols["price"][3]), 0.0, -1.0]),
              "day": (np.datetime64("2020-02-29"), [np.datetime64("2016-01-01"), "2024-12-30"]),
              "cur": ("JPY", ["EUR", "USD", "XXX"]),
              "key": (int(tcols["key"][len(tcols["key"]) // 2]), [int(tcols["key"][5])]),
              "visits": (int(np.ma.getdata(tcols["visits"])[1 << 10]), [0, 3])}
    counts_report = {}
    for name, (probe, members) in probes.items():
        for op in ALL_OPS:
            value = members if op in ("in", "notin") else probe
            got, c = counted(lambda: analytics.count_where(tpath, op, value, column=name,
                                                           device=device))
            want = int(oracle_mask(tcols[name], op, value).sum())
            if got != want:
                raise AssertionError(f"count_where({name} {op} {value!r}) = {got}, "
                                     f"oracle {want}")
            counts_report[f"{name}_{op}"] = dict(c, count=got)
    report["count_where"] = counts_report
    if on_card:
        c = counts_report["key_lt"]  # a sorted column: natural order, no relayout
        if not (c["launches"].get("undelta_pack", 0) >= 1 and c["gather_passes"] == 0):
            raise AssertionError(f"count_where on the sorted key: {c}")
    # a probe the zone maps resolve from the header alone: nothing is decoded
    for name, op, probe, want in (("qty", "lt", 2_000_000_000, len(tcols["qty"])),
                                  ("key", "lt", 5, 0),
                                  ("visits", "ge", 0, int((~np.ma.getmaskarray(
                                      tcols["visits"])).sum()))):
        got, c = counted(lambda: analytics.count_where(tpath, op, probe, column=name,
                                                       device=device))
        if got != want or c["launches"] or c["host_fetches"]:
            raise AssertionError(f"zone-map probe {name} {op} {probe}: {got} (meant {want}), "
                                 f"decoded with {c}")
        report[f"zone_resolved_{name}_{op}"] = dict(c, count=got)
    got, c = counted(lambda: analytics.count_where(
        read_paths["headline_u32_w3"], "ge", 4, device=device))
    if got != int((read_columns["headline_u32_w3"][0] >= 4).sum()):
        raise AssertionError("count_where on the headline column differs from numpy")
    report["count_where_headline"] = dict(c, count=got)

    # scan_where: same column, and cross-column in lockstep
    where_cases = [("price", None, "gt", 75_000.5), ("key", None, "lt", probes["key"][0]),
                   ("qty", None, "in", [1_000_000_001, 1_000_000_002]),
                   ("price", "cur", "eq", "EUR"), ("key", "qty", "ge", 1_000_000_900),
                   ("qty", "price", "lt", 10.0), ("price", "visits", "ne", 3),
                   ("visits", "day", "ge", np.datetime64("2024-01-01")),
                   ("cur", "change", "lt", -45)]
    where_report = {}
    for column, where, op, value in where_cases:
        got, c = counted(lambda: analytics.scan_where(tpath, op, value, column=column,
                                                      where=where, device=device))
        hit = oracle_mask(tcols[where or column], op, value) \
            & ~np.ma.getmaskarray(tcols[column])
        want = oracle_stats(np.ma.getdata(tcols[column])[hit],
                            TABLE_WORDS.size if column == "cur" else None)
        expect(f"scan_where({column} where {where} {op} {value!r})", got, want)
        where_report[f"{column}_where_{where or column}_{op}"] = c
    report["scan_where"] = where_report
    if on_card:
        c = where_report["key_where_key_lt"]
        if not (c["launches"].get("undelta_pack", 0) >= 1 and c["gather_passes"] == 0):
            raise AssertionError(f"scan_where on the sorted key: {c}")
        c = where_report["key_where_qty_ge"]  # a lockstep walk is positional
        if not (c["launches"].get("undelta_pack_orig", 0) >= 1
                and not c["launches"].get("undelta_pack") and c["gather_passes"] == 0):
            raise AssertionError(f"lockstep scan_where on the sorted key: {c}")
    launches, by_dtype = launch_counts()
    emit({"phase": "scan", "tolerance": 0, "oracle": "numpy in this script: Python-int "
          "sums, math.fsum, numpy comparisons", **report, "launches": launches})
    return {"launches": launches, "by_dtype": by_dtype}


# -- the aggregations: a second table, and their NumPy oracle ---------------


def group_table_columns(rng, scale: int) -> dict:
    """The group table of the `aggregate` phase: 2^24 + 333 rows (ragged), a
    store key with 1000 groups, a Zipf-skewed sku key with 65536, a nullable
    region key with 8, and the values a GROUP BY has to keep exact."""
    n = (1 << 24) // scale + 333
    store = rng.integers(0, 1000, n).astype(np.uint16)
    sku = ((rng.zipf(1.2, n) - 1) % 65536).astype(np.uint32)  # Zipf, folded
    sku[0] = 65535  # the key range is [0, 65536): 65536 groups
    price = np.round(rng.uniform(0, 100_000, n), 2)
    # about 100 special values in a handful of stores
    at = {s: np.flatnonzero(store == s) for s in (3, 5, 8, 11)}
    price[at[3][:10]] = np.nan
    price[at[5][:10]] = np.inf
    price[at[5][10:20]] = -np.inf
    price[at[8][:30]] = -np.inf
    price[at[11][:50]] = -0.0
    return {
        "store": store,
        "sku": sku,
        # in [-2^50, 2^50) and mostly positive: the big skus' totals pass 2^63
        "amount": rng.integers(-(1 << 48), 1 << 50, n, dtype=np.int64),
        "price": price,
        "units": rng.integers(0, 200, n).astype(np.uint8),
        "region": np.ma.MaskedArray(rng.integers(0, 8, n).astype(np.uint16),
                                    mask=rng.random(n) < 0.05),
    }


def float_group_stats(vals: np.ndarray) -> dict:
    """A float group as group_stats defines it: the exactly rounded sum
    (math.fsum; +0.0 when it is zero), NaN where the group holds a NaN or
    both infinities, extremes in IEEE total order (-0.0 below +0.0)."""
    bits = np.ascontiguousarray(vals).view(np.int64 if vals.dtype == np.float64 else np.int32)
    top = np.iinfo(bits.dtype).max
    key = bits ^ ((bits >> (bits.dtype.itemsize * 8 - 1)) & top)
    if np.isnan(vals).any():
        return {"sum": float("nan"), "min": float("nan"), "max": float("nan"),
                "count": int(vals.size)}
    pos, neg = np.isposinf(vals).any(), np.isneginf(vals).any()
    total = float("nan") if pos and neg else float("inf") if pos else \
        float("-inf") if neg else math.fsum(vals.tolist()) + 0.0
    return {"sum": total, "min": float(vals[np.argmin(key)]),
            "max": float(vals[np.argmax(key)]), "count": int(vals.size)}


class GroupOracle:
    """group_stats from numpy over the rows `ok` keeps whose key and value
    are not null, ascending by group; one sort of the key per instance."""

    def __init__(self, keys, ok=None, labels=None):
        keep = ~np.ma.getmaskarray(keys)
        if ok is not None:
            keep &= ok
        self.keys = np.ma.getdata(keys).astype(np.int64)
        rows = np.flatnonzero(keep)
        self.rows = rows[np.argsort(self.keys[rows], kind="stable")]
        self.labels = labels

    def stats(self, values, words=None) -> dict:
        """`words`: the sorted dictionary of a string value column."""
        rows = self.rows[~np.ma.getmaskarray(values)[self.rows]]
        keys, vals = self.keys[rows], np.ma.getdata(values)[rows]
        groups, starts = np.unique(keys, return_index=True)
        spans = zip(groups.tolist(), starts.tolist(), np.append(starts[1:], keys.size).tolist())
        out = {}
        if vals.dtype.kind == "f":
            out = {g: float_group_stats(vals[a:b]) for g, a, b in spans}
        elif vals.dtype.kind == "U":  # lexicographic order is the sorted words' order
            codes = np.searchsorted(words, vals)
            ends = zip(np.minimum.reduceat(codes, starts).tolist(),
                       np.maximum.reduceat(codes, starts).tolist())
            out = {g: {"sum": None, "min": str(words[mn]), "max": str(words[mx]),
                       "count": b - a, "n_dict": words.size}
                   for (g, a, b), (mn, mx) in zip(spans, ends)}
        else:
            v = vals.view(np.int64) if vals.dtype.itemsize == 8 else vals.astype(np.int64)
            sums = zip(np.add.reduceat(v & 0xFFFFFFFF, starts).tolist(),
                       np.add.reduceat(v >> 32, starts).tolist(),
                       np.minimum.reduceat(v, starts).tolist(),
                       np.maximum.reduceat(v, starts).tolist())
            out = {g: {"sum": (hi << 32) + lo, "min": mn, "max": mx, "count": b - a}
                   for (g, a, b), (lo, hi, mn, mx) in zip(spans, sums)}
        if self.labels is not None:
            out = {str(self.labels[g]): st for g, st in out.items()}
        return out


def lower_quantile(values, q):
    vals = np.ma.getdata(values)[~np.ma.getmaskarray(values)]
    if vals.dtype.itemsize == 8 and vals.dtype.kind in "iu":
        vals = vals.view(np.int64)
    return np.partition(vals, int(np.floor(q * (vals.size - 1))))[
        int(np.floor(q * (vals.size - 1)))].item()


def phase_aggregate(table: dict, tmp: str, scale: int, device=None) -> dict:
    """The aggregations on the `table` phase's table and on a second one of
    2^24 + 333 rows: scan_where_multi, group_stats (few, 1000 and 65536
    groups; float, 64-bit and string values; null keys; WHERE; a two-file
    dataset), value_counts, top_k, distinct, quantile and median, each
    answer equal to a NumPy oracle with the launches and host fetches of
    every call counted."""
    device = eng.resolve_device(device)
    tpath, tcols = table["path"], table["columns"]
    gcols = group_table_columns(np.random.default_rng(SEED + 7), scale)
    gpath = os.path.join(tmp, "groups.flt")
    t0 = time.perf_counter()
    fio_table.write_table(gpath, gcols)
    half = len(gcols["store"]) // 2
    halves = [os.path.join(tmp, f"groups_{i}.flt") for i in range(2)]
    for path, rows in zip(halves, (slice(0, half), slice(half, None))):
        fio_table.write_table(path, {"store": gcols["store"][rows], "price": gcols["price"][rows]})
    write_seconds = time.perf_counter() - t0
    ck.reset_launches()
    calls = {}

    def check(label, fn, want, same=same_stats):
        got, counts = counted(fn)
        if not same(got, want) or (isinstance(want, dict) and list(got) != list(want)):
            raise AssertionError(f"{label}: {got!r} differs from the oracle {want!r}"[:2000])
        calls[label] = counts
        return got

    # WHERE a AND b AND c, and a WHERE the zone maps prune to one window
    preds = [("cur", "eq", "EUR"), ("qty", "ge", 1_000_000_500),
             ("day", "ge", np.datetime64("2020-01-01"))]
    ok = np.logical_and.reduce([oracle_mask(tcols[c], op, v) for c, op, v in preds])
    check("scan_where_multi[3 preds]", lambda: analytics.scan_where_multi(
        tpath, preds, column="price", device=device), oracle_stats(tcols["price"][ok]))
    late = int(tcols["key"][-(1 << 20) // scale])
    pruned = [("key", "ge", late), ("qty", "lt", 1_000_000_100)]
    ok = (tcols["key"] >= late) & (tcols["qty"] < 1_000_000_100)
    check("scan_where_multi[pruned]", lambda: analytics.scan_where_multi(
        tpath, pruned, column="ratio", device=device), oracle_stats(tcols["ratio"][ok]))

    # GROUP BY a string key, with and without WHERE
    codes = np.searchsorted(TABLE_WORDS, tcols["cur"])
    by_cur = GroupOracle(codes, labels=TABLE_WORDS)
    gpreds = [("qty", "ge", 1_000_000_500), ("day", "ge", np.datetime64("2020-01-01"))]
    gok = np.logical_and.reduce([oracle_mask(tcols[c], op, v) for c, op, v in gpreds])
    by_cur_where = GroupOracle(codes, ok=gok, labels=TABLE_WORDS)
    for value in ("price", "qty", "ratio", "visits", "cur"):
        check(f"group_stats[cur->{value}]", lambda: analytics.group_stats(
            tpath, "cur", value, device=device), by_cur.stats(tcols[value], TABLE_WORDS))
        check(f"group_stats[cur->{value} where]", lambda: analytics.group_stats(
            tpath, "cur", value, device=device, preds=gpreds),
            by_cur_where.stats(tcols[value], TABLE_WORDS))
    # 1000 float groups, 65536 integer groups of 64-bit values, null keys,
    # and the group table as a two-file dataset
    by_store = GroupOracle(gcols["store"])
    want = by_store.stats(gcols["price"])
    check("group_stats[store->price]", lambda: analytics.group_stats(
        gpath, "store", "price", device=device), want)
    check("group_stats[store->price, 2 files]", lambda: analytics.group_stats(
        halves, "store", "price", device=device), want)
    got = check("group_stats[sku->amount]", lambda: analytics.group_stats(
        gpath, "sku", "amount", device=device), GroupOracle(gcols["sku"]).stats(gcols["amount"]))
    if scale == 1 and max(s["sum"] for s in got.values()) < 1 << 63:
        raise AssertionError("no sku total passes 2^63: the int64 case is not driven")
    check("group_stats[region->units]", lambda: analytics.group_stats(
        gpath, "region", "units", device=device),
        GroupOracle(gcols["region"]).stats(gcols["units"]))

    # value_counts, top_k, distinct
    for path, cols, name in ((tpath, tcols, "cur"), (gpath, gcols, "units"),
                             (tpath, tcols, "change")):
        u, c = np.unique(cols[name], return_counts=True)
        check(f"value_counts[{name}]", lambda: analytics.value_counts(
            path, name, device=device), dict(zip(u.tolist(), c.tolist())))
    for name, k in (("price", 100), ("key", 100), ("ratio", 100)):
        ordered = np.sort(tcols[name])
        for largest in (True, False):
            want = (ordered[::-1] if largest else ordered)[:k]
            check(f"top_k[{name}{'' if largest else ', smallest'}]", lambda: analytics.top_k(
                tpath, name, k=k, largest=largest, device=device),
                [float(v) if want.dtype.kind == "f" else int(v) for v in want])
    for name in ("cur", "change", "day"):
        want = np.unique(tcols[name])
        check(f"distinct[{name}]", lambda: analytics.distinct(tpath, name), want,
              same=lambda a, b: a.dtype.kind == b.dtype.kind and np.array_equal(a, b))

    # exact quantiles: the counting pass, the f64 search, the 64-bit search
    qs = [0.01, 0.5, 0.99]
    check("quantile[qty]", lambda: analytics.quantile(tpath, "qty", qs, device=device),
          [lower_quantile(tcols["qty"], q) for q in qs])
    check("median[price]", lambda: analytics.median(tpath, "price", device=device),
          lower_quantile(tcols["price"], 0.5))
    check("quantile[amount 0.9]", lambda: analytics.quantile(
        gpath, "amount", 0.9, device=device), lower_quantile(gcols["amount"], 0.9))

    launches, by_dtype = launch_counts()
    emit({"phase": "aggregate", "tolerance": 0, "oracle": "numpy in this script: Python-int "
          "sums, math.fsum per group, IEEE total order for float extremes, numpy's "
          "method='lower' for quantiles", "rows": {"table": len(tcols["key"]),
                                                  "groups": len(gcols["store"])},
          "group_file_bytes": os.path.getsize(gpath), "write_seconds": write_seconds,
          "calls": calls, "launches": launches, "launches_by_dtype": by_dtype})
    return {"path": gpath, "halves": halves, "columns": gcols, "launches": launches,
            "by_dtype": by_dtype}


# -- row materialisation: select and join, against NumPy oracles -----------


def same_rows(got, want) -> bool:
    """select / join results equal: the same column order, masked or not,
    the same dtypes (unicode columns: any width), shapes and masks, and the
    same values wherever no mask hides them (floats bit for bit)."""
    if not isinstance(got, dict) or list(got) != list(want):
        return False
    for name, w in want.items():
        g = got[name]
        if type(g) is not type(w) or g.shape != w.shape or not (
                g.dtype == w.dtype or g.dtype.kind == w.dtype.kind == "U"):
            return False
        present = ~np.ma.getmaskarray(w)
        if not np.array_equal(np.ma.getmaskarray(g), ~present):
            return False
        gd, wd = np.ma.getdata(g)[present], np.ma.getdata(w)[present]
        if wd.dtype.kind == "f":
            gd, wd = float_bits(gd), float_bits(wd)
        if not np.array_equal(gd, wd):
            return False
    return True


def order_key(values) -> np.ndarray:
    """An order column as int64 keys in the order ORDER BY ... LIMIT ranks
    it: integers by value (64-bit ones in int64 semantics), floats in IEEE
    total order, strings by their sorted label."""
    vals = np.ma.getdata(values)
    if vals.dtype.kind == "U":
        return np.searchsorted(np.unique(vals), vals).astype(np.int64)
    if vals.dtype == np.float32:
        bits = vals.view(np.int32).astype(np.int64)
        return bits ^ ((bits >> 31) & 0x7FFFFFFF)
    if vals.dtype == np.float64:
        bits = vals.view(np.int64)
        return bits ^ ((bits >> 63) & 0x7FFFFFFFFFFFFFFF)
    if vals.dtype.kind in "mM" or vals.dtype.itemsize == 8:
        return vals.view(np.int64)
    return vals.astype(np.int64)


def oracle_top(values, ok, k: int, desc: bool, window_rows: int) -> np.ndarray:
    """The rows ORDER BY ... LIMIT k returns from one file: the rows `ok`
    keeps (nulls never rank), best key first; equal keys by lockstep window
    (`window_rows` rows each), then by row, lowest first for keys of up to 32
    bits and highest first for 64-bit keys."""
    ok = ok & ~np.ma.getmaskarray(values)
    rows = np.flatnonzero(ok)
    key = order_key(values)[rows]
    dt = np.ma.getdata(values).dtype
    high_first = dt.kind != "U" and dt.itemsize == 8
    order = np.lexsort((-rows if high_first else rows, rows // window_rows,
                        ~key if desc else key))
    return rows[order][:k]


def numpy_order(keys, desc: bool) -> np.ndarray:
    """ORDER BY over merged host rows: a stable numpy sort (u64 as int64,
    nulls last), reversed for DESC."""
    null = np.ma.getmaskarray(keys)
    kd = np.asarray(np.ma.getdata(keys))
    if kd.dtype == np.uint64:
        kd = kd.view(np.int64)
    pos = np.arange(len(kd))
    vi = pos[~null][np.argsort(kd[~null], kind="stable")]
    return np.concatenate([vi[::-1] if desc else vi, pos[null]])


def window_rows_of(path: str, column: str) -> int:
    """Rows of one lockstep window of a table column."""
    col = fio_table.read_table_header(path)["columns"][column]
    return col["chunk_blocks"] * layout.BLOCK * analytics._LOCKSTEP_WINDOW


def dimension_tables(rng, tmp: str) -> dict:
    """The right sides of the joins: `skus`, 65536 u32 skus of which about 5 %
    are left out (a left join has misses), with a brand of 40 labels, an f64
    weight and an i64 pack size with ties; `currencies`, 20 of the 24 `cur`
    labels with an f64 rate and a u8 zone. Rows shuffled: the join sorts."""
    sku = rng.permutation(np.flatnonzero(rng.random(65536) >= 0.05)).astype(np.uint32)
    brands = np.array([f"brand{i:02d}" for i in range(40)])
    skus = {"sku": sku, "brand": brands[rng.integers(0, 40, sku.size)],
            "weight": np.round(rng.uniform(0.1, 50.0, sku.size), 3),
            "pack": np.array([1, 6, 12, 24, 1 << 40], np.int64)[rng.integers(0, 5, sku.size)]}
    cur = rng.choice(TABLE_WORDS, 20, replace=False)
    currencies = {"cur": cur, "rate": np.round(rng.uniform(0.01, 10.0, 20), 4),
                  "zone": rng.integers(0, 5, 20).astype(np.uint8)}
    out = {}
    for name, cols in (("skus", skus), ("currencies", currencies)):
        path = os.path.join(tmp, f"{name}.flt")
        t0 = time.perf_counter()
        fio_table.write_table(path, cols)
        out[name] = {"path": path, "columns": cols, "write_seconds": time.perf_counter() - t0}
    return out


def lookup(dim_keys, keys):
    """(row of each key in the dimension, matched?)."""
    order = np.argsort(dim_keys, kind="stable")
    pos = np.clip(np.searchsorted(dim_keys[order], keys), 0, len(dim_keys) - 1)
    hit = dim_keys[order][pos] == keys
    return order[pos], hit


def query_calls(tpath: str, gpath: str, halves: list, dims: dict) -> dict:
    """label -> call(device, mesh=None) of every query the `query` phase
    drives and times (the `mesh` phase drives them again on a mesh)."""
    def select(*args, **kwargs):
        return lambda device, mesh=None: analytics.select(*args, device=device, mesh=mesh,
                                                          **kwargs)

    def join(*args, **kwargs):
        return lambda device, mesh=None: analytics.join(*args, device=device, mesh=mesh,
                                                        **kwargs)

    date_range = [("day", "ge", np.datetime64("2020-01-01")),
                  ("day", "le", np.datetime64("2020-12-31"))]
    return {
        "select[2 preds]": select(
            tpath, ["key", "price", "cur", "visits"],
            [("cur", "in", ["EUR", "GBP"]), ("qty", "lt", 1_000_000_500)]),
        "select[8 columns, date range]": select(tpath, None, date_range),
        "select[ORDER BY price DESC LIMIT 100]": select(
            tpath, ["key", "price", "cur"], order_by="price", desc=True, limit=100),
        "select[ORDER BY cur LIMIT 300]": select(tpath, ["cur", "key"], order_by="cur",
                                                 limit=300),
        "select[ORDER BY day DESC LIMIT 500]": select(
            tpath, ["day", "key"], order_by="day", desc=True, limit=500),
        "select[ORDER BY store DESC LIMIT 1000]": select(
            gpath, ["store", "amount"], order_by="store", desc=True, limit=1000),
        "select[ORDER BY units DESC LIMIT 1000 WHERE store eq 3]": select(
            gpath, ["units", "amount"], [("store", "eq", 3)], order_by="units", desc=True,
            limit=1000),
        "select[ORDER BY units DESC LIMIT 1000 WHERE store eq 3 AND units lt 2]": select(
            gpath, ["units", "amount"], [("store", "eq", 3), ("units", "lt", 2)],
            order_by="units", desc=True, limit=1000),
        "select[LIMIT 100000 WHERE cur eq JPY]": select(
            tpath, ["key", "cur"], [("cur", "eq", "JPY")], limit=100_000),
        "select[2 files, ORDER BY price LIMIT 50]": select(
            halves, ["store"], order_by="price", desc=True, limit=50),
        "join[groups x skus, inner, store lt 100]": join(
            gpath, dims["skus"]["path"], "sku", columns=["store", "amount"],
            preds=[("store", "lt", 100)]),
        "join[table x currencies, left, qty lt]": join(
            tpath, dims["currencies"]["path"], "cur", columns=["key", "cur"],
            preds=[("qty", "lt", 1_000_000_250)], how="left"),
    }


def query_oracles(tpath, tcols, gpath, gcols, halves, dims) -> dict:
    """label -> the answer of each query of query_calls, from numpy."""
    tw, gw = window_rows_of(tpath, "key"), window_rows_of(gpath, "store")
    every_t = np.ones(len(tcols["key"]), bool)
    every_g = np.ones(len(gcols["store"]), bool)

    def rows_of(cols, names, rows):
        return {n: cols[n][rows] for n in names}

    out = {}
    two = np.isin(tcols["cur"], ["EUR", "GBP"]) & (tcols["qty"] < 1_000_000_500)
    out["select[2 preds]"] = rows_of(tcols, ["key", "price", "cur", "visits"],
                                     np.flatnonzero(two))
    day = tcols["day"]
    in_2020 = (day >= np.datetime64("2020-01-01")) & (day <= np.datetime64("2020-12-31"))
    out["select[8 columns, date range]"] = rows_of(tcols, list(tcols), np.flatnonzero(in_2020))
    out["select[ORDER BY price DESC LIMIT 100]"] = rows_of(
        tcols, ["key", "price", "cur"], oracle_top(tcols["price"], every_t, 100, True, tw))
    out["select[ORDER BY cur LIMIT 300]"] = rows_of(
        tcols, ["cur", "key"], oracle_top(tcols["cur"], every_t, 300, False, tw))
    out["select[ORDER BY day DESC LIMIT 500]"] = rows_of(
        tcols, ["day", "key"], oracle_top(tcols["day"], every_t, 500, True, tw))
    out["select[ORDER BY store DESC LIMIT 1000]"] = rows_of(
        gcols, ["store", "amount"], oracle_top(gcols["store"], every_g, 1000, True, gw))
    store3 = gcols["store"] == 3
    out["select[ORDER BY units DESC LIMIT 1000 WHERE store eq 3]"] = rows_of(
        gcols, ["units", "amount"], oracle_top(gcols["units"], store3, 1000, True, gw))
    out["select[ORDER BY units DESC LIMIT 1000 WHERE store eq 3 AND units lt 2]"] = rows_of(
        gcols, ["units", "amount"],
        oracle_top(gcols["units"], store3 & (gcols["units"] < 2), 1000, True, gw))
    out["select[LIMIT 100000 WHERE cur eq JPY]"] = rows_of(
        tcols, ["key", "cur"], np.flatnonzero(tcols["cur"] == "JPY")[:100_000])
    # a dataset: each file's top 50 (its own windows), merged by a host sort
    half = len(gcols["store"]) // 2
    cands = []
    for start, stop, path in ((0, half, halves[0]), (half, len(gcols["store"]), halves[1])):
        price = gcols["price"][start:stop]
        cands.append(start + oracle_top(price, np.ones(stop - start, bool), 50, True,
                                        window_rows_of(path, "price")))
    cands = np.concatenate(cands)
    merged = cands[numpy_order(gcols["price"][cands], True)][:50]
    out["select[2 files, ORDER BY price LIMIT 50]"] = rows_of(gcols, ["store"], merged)
    # the joins: the dimension rows looked up by key
    skus = dims["skus"]["columns"]
    pos, hit = lookup(skus["sku"], gcols["sku"])
    rows = np.flatnonzero((gcols["store"] < 100) & hit)
    want = rows_of(gcols, ["store", "amount"], rows)
    want.update({c: skus[c][pos[rows]] for c in ("brand", "weight", "pack")})
    out["join[groups x skus, inner, store lt 100]"] = want
    cur = dims["currencies"]["columns"]
    rows = np.flatnonzero(tcols["qty"] < 1_000_000_250)
    pos, hit = lookup(cur["cur"], tcols["cur"][rows])
    want = rows_of(tcols, ["key", "cur"], rows)
    want.update({c: np.ma.MaskedArray(cur[c][pos], mask=~hit) for c in ("rate", "zone")})
    out["join[table x currencies, left, qty lt]"] = want
    return out


def phase_query(table: dict, groups: dict, tmp: str, device=None) -> dict:
    """select and join on the two smoke tables and two dimension tables, each
    answer equal to a NumPy oracle at tolerance 0 (the tie rule of
    ORDER BY ... LIMIT included), with the launches and host fetches of every
    call counted; and the writers' walls with the native host codec and
    without it, in one call."""
    device = eng.resolve_device(device)
    tpath, tcols = table["path"], table["columns"]
    gpath, gcols, halves = groups["path"], groups["columns"], groups["halves"]
    dims = dimension_tables(np.random.default_rng(SEED + 8), tmp)
    oracles = query_oracles(tpath, tcols, gpath, gcols, halves, dims)
    queries = query_calls(tpath, gpath, halves, dims)
    ck.reset_launches()
    calls, rows_out = {}, {}
    for label, call in queries.items():
        got, counts = counted(lambda: call(device))
        want = oracles[label]
        if not same_rows(got, want):
            raise AssertionError(f"{label}: the rows differ from the oracle's")
        rows_out[label] = len(next(iter(want.values())))
        calls[label] = dict(counts, rows=rows_out[label])
        del got, want
    if device.type == "cuda":
        c = calls["select[LIMIT 100000 WHERE cur eq JPY]"]
        if c["host_fetches"] > 4:
            raise AssertionError(f"LIMIT without ORDER BY did not stop the walk early: {c}")
    launches, by_dtype = launch_counts()
    writers = {}
    for name, cols in (("table", tcols), ("groups", gcols)):
        walls = {}
        for how in ("native", "numpy"):
            path = os.path.join(tmp, f"rewrite_{name}.flt")
            real = fio.native.available
            if how == "numpy":
                fio.native.available = lambda: False
            try:
                t0 = time.perf_counter()
                fio_table.write_table(path, cols)
                walls[how + "_seconds"] = time.perf_counter() - t0
            finally:
                fio.native.available = real
            with open(path, "rb") as f, open(tpath if name == "table" else gpath, "rb") as g:
                if f.read() != g.read():
                    raise AssertionError(f"the {how} writer's {name} differs from the first")
            os.remove(path)
        writers[name] = walls
    emit({"phase": "query", "tolerance": 0, "oracle": "numpy in this script: the rows each "
          "query keeps, ORDER BY in IEEE total order with ties by window and then row "
          "(lowest first for keys of up to 32 bits, highest for 64-bit keys), joins by a "
          "sorted lookup", "dimensions": {
              n: {"rows": len(d["columns"]["sku" if n == "skus" else "cur"]),
                  "write_seconds": d["write_seconds"]} for n, d in dims.items()},
          "calls": calls, "writer_walls": writers, "launches": launches,
          "launches_by_dtype": by_dtype})
    # the oracles stay for the `mesh` phase, which drives these calls again
    return {"launches": launches, "by_dtype": by_dtype, "rows_out": rows_out,
            "calls": queries, "dims": {n: d["path"] for n, d in dims.items()},
            "oracles": oracles}


def phase_native(rng) -> dict:
    """The C++ host codec: built (it must be, on the card's host), each of
    pack / unpack / transpose / delta against the NumPy host codec on 2^24
    values of every dtype, outputs equal and times side by side."""
    if not native.available():
        raise AssertionError("the native host codec did not build")
    times = {}
    for dtype in layout.DTYPES:
        t = layout.bit_width(dtype)
        width = t // 4 + 2
        n_blocks = (1 << 24) // layout.BLOCK
        np_dt = layout.np_dtype(dtype)
        values = rng.integers(0, 1 << width, size=(n_blocks, layout.BLOCK),
                              dtype=np.uint64).astype(np_dt)
        base = values[:, :layout.lanes(dtype)].copy()
        packed = npref.pack(values, width, dtype)
        row = {"width": width, "values": n_blocks * layout.BLOCK}
        for op, args in (("pack", (values, width, dtype)), ("unpack", (packed, width, dtype)),
                         ("transpose", (values, dtype)), ("delta", (values, base, dtype))):
            ours, theirs = getattr(native, op), getattr(npref, op)
            if not np.array_equal(ours(*args), theirs(*args)):
                raise AssertionError(f"native {op} {dtype} differs from numpy_ref")
            walls = {}
            for label, fn, reps in (("native_ms", ours, 5), ("numpy_ms", theirs, 1)):
                samples = []
                for _ in range(reps):
                    t0 = time.perf_counter()
                    fn(*args)
                    samples.append((time.perf_counter() - t0) * 1e3)
                walls[label] = statistics.median(samples)
            walls["speedup"] = walls["numpy_ms"] / walls["native_ms"]
            row[op] = walls
        times[dtype] = row
    emit({"phase": "native", "available": True,
          "library": os.path.relpath(native.build()), "parts": native.PARTS,
          "flags": " ".join(native.CXX_FLAGS), "build_seconds": native.last_build_seconds,
          "times": times})
    return times


# ---------------------------------------------------------------------------
# the sharded codecs and the command line


#: the two-rank run's child: a gloo group through a file:// store, both ranks
#: on cuda:0 (NCCL refuses two ranks on one device), each passing the whole
#: headline column of 131 072 + 5 blocks; rank r holds blocks [r*s, (r+1)*s)
SHARD_CHILD = r"""
import hashlib, json, statistics, sys, time
import numpy as np
import torch
import torch.distributed as dist
rank, store, data, root, device = (int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4],
                                   sys.argv[5])
sys.path.insert(0, root)
from fastlanes_tpu_torch import parallel
from fastlanes_tpu_torch.kernels import cuda_codecs as ck

dist.init_process_group("gloo", init_method="file://" + store, rank=rank, world_size=2)
mesh = parallel.make_mesh(device=device)
values = torch.from_numpy(np.load(data)).to(device)
walls = {}


def sync():
    if values.is_cuda:
        torch.cuda.synchronize()


def timed(name, fn):
    samples = []
    for _ in range(3):
        dist.barrier()
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        samples.append((time.perf_counter() - t0) * 1e3)
    walls[name] = statistics.median(samples)
    return out


ck.reset_launches()
bits = int(timed("global_max_bits", lambda: parallel.global_max_bits(mesh, values, "u32")))
local = timed("sharded_pack", lambda: parallel.sharded_pack(mesh, values, bits, "u32"))
whole = timed("all_gather_packed", lambda: parallel.all_gather_packed(mesh, local, "u32"))
decoded = timed("sharded_unpack", lambda: parallel.sharded_unpack(mesh, whole, bits, "u32"))
bad = int(timed("sharded_roundtrip_check",
                lambda: parallel.sharded_roundtrip_check(mesh, values, bits, "u32")))
s = -(-values.shape[0] // 2)
mine = values[rank * s:(rank + 1) * s]
print(json.dumps({
    "rank": rank, "backend": dist.get_backend(), "blocks": local.shape[0], "bits": bits,
    "roundtrip_mismatches": bad, "gathered_blocks": whole.shape[0],
    "decoded_equal": bool(torch.equal(decoded.view(torch.int32), mine.view(torch.int32))),
    "sha256": hashlib.sha256(whole.cpu().numpy().tobytes()).hexdigest(),
    "launches": {k: v for k, v in ck.LAUNCHES.items() if v},
    "launches_by_dtype": {f"{k}[{d}]": v for (k, d), v in ck.LAUNCHES_BY_DTYPE.items()},
    "walls_ms": walls}), flush=True)
dist.destroy_process_group()
"""


def median_wall_ms(fn, device, reps: int = 3) -> float:
    """Median wall ms of `reps` calls, each ending in a synchronise, after
    one warm-up."""
    fn()
    samples = []
    for _ in range(reps):
        sync_if_cuda(device)
        t0 = time.perf_counter()
        fn()
        sync_if_cuda(device)
        samples.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(samples)


def two_rank_run(tmp: str, head: np.ndarray, device) -> dict:
    """The headline column at HEADLINE_BLOCKS + 5 blocks through two child
    processes on the one card; their gathered payload against the single
    process `pack` of the same data. A child that fails, prints no line or
    runs past its time fails the smoke."""
    extra = np.random.default_rng(SEED + 10).integers(0, 8, size=(5, layout.BLOCK),
                                                      dtype=np.uint32)
    data = np.concatenate([head, extra])
    data_path = os.path.join(tmp, "two_rank.npy")
    np.save(data_path, data)
    store = os.path.join(tmp, "two_rank.store")
    root = os.path.dirname(os.path.abspath(__file__))
    child_device = "cuda:0" if device.type == "cuda" else "cpu"
    procs = [subprocess.Popen([sys.executable, "-c", SHARD_CHILD, str(rank), store,
                               data_path, root, child_device], cwd=root, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for rank in range(2)]
    t0 = time.perf_counter()
    try:
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    seconds = time.perf_counter() - t0
    lines = []
    for rank, (p, (out, err)) in enumerate(zip(procs, outs)):
        found = [line for line in out.splitlines() if line.startswith("{")]
        if p.returncode != 0 or len(found) != 1:
            raise AssertionError(f"two-rank child {rank} failed (rc {p.returncode}):\n"
                                 f"{out[-2000:]}\n{err[-4000:]}")
        lines.append(json.loads(found[0]))
    bits = int(data.max()).bit_length()
    single = ck.pack(torch.from_numpy(data).to(device), bits, "u32")
    want = hashlib.sha256(single.cpu().numpy().tobytes()).hexdigest()
    del single
    s = -(-data.shape[0] // 2)
    for line in lines:
        ok = (line["bits"] == bits and line["roundtrip_mismatches"] == 0
              and line["decoded_equal"] and line["sha256"] == want
              and line["gathered_blocks"] == data.shape[0]
              and line["blocks"] == min(s, data.shape[0] - line["rank"] * s))
        if not ok:
            raise AssertionError(f"two-rank run: rank {line['rank']} disagrees with the "
                                 f"single-process pack ({want}): {line}")
    os.remove(data_path)
    return {"blocks": data.shape[0], "ranks": lines, "single_process_sha256": want,
            "seconds": seconds}


def phase_shard(columns: dict, dev: dict, encoded: dict, tmp: str, device=None,
                card: str = "cpu") -> dict:
    """The sharded codecs on the card. One rank over NCCL in this process,
    at full size: every sharded op against the port's single-process entry
    on the same tensors (bit for bit) and, on its first and last
    ORACLE_BLOCKS, against numpy_ref; `global_max_bits` against numpy, the
    round-trip check at 0. Then two ranks over gloo on the one card, the
    headline column only, with unequal shards."""
    from fastlanes_tpu_torch import parallel
    import torch.distributed as dist

    device = eng.resolve_device(device)
    if dist.is_initialized():
        raise AssertionError("a process group is already initialized")
    mesh = parallel.make_mesh(device=device)
    backend = dist.get_backend()
    k = ORACLE_BLOCKS
    ffor, delta, zdelta = (encoded[n] for n in ("ffor_u32", "delta_u32", "zdelta_u32"))
    host = {name: columns[name][0].reshape(-1, layout.BLOCK)
            for name in ("headline_u32_w3", "ffor_u32", "delta_u32", "zdelta_u32",
                         "small_u8", "small_u16", "timestamps_u64")}

    def ends(arr):
        return [arr[:k], arr[-k:]]

    ops = {}  # label -> (sharded call, single-process call, oracle of host blocks)
    for name in ("headline_u32_w3", "small_u8", "small_u16", "timestamps_u64"):
        vals, hv = dev[name], host[name]
        dt = _DTYPE_OF[vals.dtype]
        w = int(hv.max()).bit_length()
        packed = ck.pack(vals, w, dt)
        ops[f"sharded_pack[{name}]"] = (
            lambda v=vals, w=w, dt=dt: parallel.sharded_pack(mesh, v, w, dt),
            lambda v=vals, w=w, dt=dt: ck.pack(v, w, dt),
            lambda b, w=w, dt=dt: npref.pack(b, w, dt), hv)
        ops[f"sharded_unpack[{name}]"] = (
            lambda p=packed, w=w, dt=dt: parallel.sharded_unpack(mesh, p, w, dt),
            lambda p=packed, w=w, dt=dt: ck.unpack(p, w, dt), lambda b: b, hv)
        ops[f"sharded_unpack(orig)[{name}]"] = (
            lambda p=packed, w=w, dt=dt: parallel.sharded_unpack(mesh, p, w, dt, orig=True),
            lambda p=packed, w=w, dt=dt: ck.unpack_orig(p, w, dt),
            lambda b, dt=dt: npref.untranspose(b, dt), hv)
    ref, fw = ffor.params["reference"], ffor.width
    ops["sharded_for_pack[ffor_u32]"] = (
        lambda: parallel.sharded_for_pack(mesh, dev["ffor_u32"], ref, fw, "u32"),
        lambda: ck.for_pack(dev["ffor_u32"], ref, fw, "u32"),
        lambda b: npref.for_pack(b, ref, fw, "u32"), host["ffor_u32"])
    ops["sharded_unfor_pack[ffor_u32]"] = (
        lambda: parallel.sharded_unfor_pack(mesh, ffor.payload, ref, fw, "u32"),
        lambda: ck.unfor_pack(ffor.payload, ref, fw, "u32"), lambda b: b, host["ffor_u32"])
    for name, enc, sharded, single, orig_single in (
            ("delta_u32", delta, parallel.sharded_undelta_pack, ck.undelta_pack,
             ck.undelta_pack_orig),
            ("zdelta_u32", zdelta, parallel.sharded_unzdelta_pack, ck.unzdelta_pack,
             ck.unzdelta_pack_orig)):
        base, w = enc.params["base"], enc.width
        ops[f"{sharded.__name__}[{name}]"] = (
            lambda f=sharded, e=enc, b=base, w=w: f(mesh, e.payload, b, w, "u32"),
            lambda f=single, e=enc, b=base, w=w: f(e.payload, b, w, "u32"),
            lambda b: npref.transpose(b, "u32"), host[name])
        ops[f"{sharded.__name__}(orig)[{name}]"] = (
            lambda f=sharded, e=enc, b=base, w=w: f(mesh, e.payload, b, w, "u32", orig=True),
            lambda f=orig_single, e=enc, b=base, w=w: f(e.payload, b, w, "u32"),
            lambda b: b, host[name])
    head = dev["headline_u32_w3"]
    sync_if_cuda(device)

    ck.reset_launches()
    results = {label: call[0]() for label, call in ops.items()}
    bits = int(parallel.global_max_bits(mesh, head, "u32"))
    bad = int(parallel.sharded_roundtrip_check(mesh, head, bits, "u32"))
    gathered = parallel.all_gather_packed(mesh, results["sharded_pack[headline_u32_w3]"],
                                          "u32")
    sync_if_cuda(device)
    launches, by_dtype = launch_counts()

    report = {}
    for label, (_, single, oracle, hv) in ops.items():
        got = results.pop(label)
        if not same(got, single()):
            raise AssertionError(f"{label}: differs from the single-process entry")
        for part, blocks in zip(ends(got), ends(hv)):
            if not np.array_equal(part.cpu().numpy(), oracle(blocks)):
                raise AssertionError(f"{label}: differs from numpy_ref at the ends")
        report[label] = {"blocks": got.shape[0], "dtype": _DTYPE_OF[got.dtype]}
        del got
    if bits != int(host["headline_u32_w3"].max()).bit_length():
        raise AssertionError(f"global_max_bits {bits}")
    if bad:
        raise AssertionError(f"sharded_roundtrip_check: {bad} mismatches")
    if not same(gathered, ck.pack(head, bits, "u32")):
        raise AssertionError("all_gather_packed at one rank differs from pack")
    del gathered

    # walls at one rank (median of 3), the headline ops beside the two-rank run
    headline_ops = {
        "global_max_bits": lambda: parallel.global_max_bits(mesh, head, "u32"),
        "sharded_pack": ops["sharded_pack[headline_u32_w3]"][0],
        "all_gather_packed": lambda p=parallel.sharded_pack(mesh, head, bits, "u32"):
            parallel.all_gather_packed(mesh, p, "u32"),
        "sharded_unpack": ops["sharded_unpack[headline_u32_w3]"][0],
        "sharded_roundtrip_check":
            lambda: parallel.sharded_roundtrip_check(mesh, head, bits, "u32"),
    }
    for label in report:
        report[label].update(world_1_ms=median_wall_ms(ops[label][0], device),
                             world_1_backend=backend)
    world_1 = {name: median_wall_ms(fn, device) for name, fn in headline_ops.items()}
    single_pack_ms = median_wall_ms(ops["sharded_pack[headline_u32_w3]"][1], device)
    dist.destroy_process_group()
    del mesh

    two = two_rank_run(tmp, host["headline_u32_w3"], device)
    headline = {name: {"blocks": [head.shape[0], two["blocks"]], "world_1_ms": ms,
                       "world_1_backend": backend,
                       "world_2_ms_by_rank": [r["walls_ms"][name] for r in two["ranks"]],
                       "world_2_backend": two["ranks"][0]["backend"]}
                for name, ms in world_1.items()}
    emit({"phase": "shard", "tolerance": 0, "device": str(device), "card": card,
          "world_1": {"backend": backend, "ops": report},
          "headline": headline, "pack_ms_single_process": single_pack_ms,
          "two_rank": {k: v for k, v in two.items() if k != "ranks"},
          "two_rank_ranks": [{k: v for k, v in r.items() if k != "walls_ms"}
                             for r in two["ranks"]],
          "gloo_collectives": "gloo takes the CUDA tensors of every collective used "
                              "(all_gather, all-reduce MAX and SUM, barrier) and moves them "
                              "through host memory itself; the port stages nothing",
          "multi_gpu_scaling": "not measured: one card",
          "launches": launches})
    return {"launches": launches, "by_dtype": by_dtype}


# -- mesh=: the reads and the aggregations split over the ranks of a mesh ---

#: the mesh path must launch: the headline (unpack), the ffor file and the
#: table's qty (unfor_pack), the sorted table key in natural order under
#: scan_table and in original order under a lockstep window (undelta_pack,
#: undelta_pack_orig), the zdelta file (unzdelta_pack_orig)
MESH_KERNELS = ("unpack", "unfor_pack", "undelta_pack", "undelta_pack_orig",
                "unzdelta_pack_orig")
MESH_READS = ("read_blocks_device", "read_file_device", "read_files_device",
              "iter_files_device", "read_column_device")
#: the row queries of the `mesh` path: the `query` phase's calls
MESH_ROWS = ("select", "join")


def mesh_files(read_paths: dict, table: dict, groups: dict, queries: dict) -> dict:
    return {"headline": read_paths["headline_u32_w3"], "table": table["path"],
            "groups": groups["path"], "few": [read_paths[n] for n in
                                              ("ffor_u32", "delta_u32", "zdelta_u32")],
            "halves": groups["halves"],
            "dims": {n: {"path": p} for n, p in queries["dims"].items()}}


def mesh_calls(files: dict) -> dict:
    """label -> call(device, mesh): every entry that takes `mesh=`, on the read
    phase's headline file (and three other read files), the table phase's
    table and the aggregate phase's group table; and every select and join
    of the `query` phase (the table, the group table, its two halves and the
    dimension tables)."""
    h, t, g, few = files["headline"], files["table"], files["groups"], files["few"]
    hb = fio.read_header(h)["n_blocks"]
    names = list(fio_table.read_table_header(t)["columns"])
    preds = [("cur", "eq", "EUR"), ("qty", "ge", 1_000_000_500),
             ("day", "ge", np.datetime64("2020-01-01"))]
    return {
        "read_blocks_device[headline 5:-3]": lambda d, m: fio_device.read_blocks_device(
            h, 5, hb - 3, device=d, mesh=m),
        "read_file_device[headline]": lambda d, m: fio_device.read_file_device(
            h, device=d, mesh=m),
        "read_files_device[ffor, delta, zdelta]": lambda d, m: fio_device.read_files_device(
            few, device=d, mesh=m),
        "iter_files_device[ffor, delta, zdelta]": lambda d, m: list(
            fio_device.iter_files_device(few, device=d, mesh=m)),
        "read_column_device[table, every column]": lambda d, m: {
            n: fio_device.read_column_device(t, n, device=d, mesh=m) for n in names},
        "scan_column[headline]": lambda d, m: analytics.scan_column(h, device=d, mesh=m),
        "scan_table[table]": lambda d, m: analytics.scan_table(t, device=d, mesh=m),
        "count_where[headline ge 4]": lambda d, m: analytics.count_where(
            h, "ge", 4, device=d, mesh=m),
        "count_where[cur eq JPY]": lambda d, m: analytics.count_where(
            t, "eq", "JPY", column="cur", device=d, mesh=m),
        "scan_where[key where qty ge]": lambda d, m: analytics.scan_where(
            t, "ge", 1_000_000_900, column="key", where="qty", device=d, mesh=m),
        "scan_where_multi[3 preds]": lambda d, m: analytics.scan_where_multi(
            t, preds, column="price", device=d, mesh=m),
        "group_stats[store->price]": lambda d, m: analytics.group_stats(
            g, "store", "price", device=d, mesh=m),
        "group_stats[sku->amount]": lambda d, m: analytics.group_stats(
            g, "sku", "amount", device=d, mesh=m),
        "group_stats[cur->price]": lambda d, m: analytics.group_stats(
            t, "cur", "price", device=d, mesh=m),
        "value_counts[cur]": lambda d, m: analytics.value_counts(t, "cur", device=d, mesh=m),
        "value_counts[units]": lambda d, m: analytics.value_counts(g, "units", device=d, mesh=m),
        "top_k[price]": lambda d, m: analytics.top_k(t, "price", k=100, device=d, mesh=m),
        "quantile[qty]": lambda d, m: analytics.quantile(
            t, "qty", [0.01, 0.5, 0.99], device=d, mesh=m),
        "median[change]": lambda d, m: analytics.median(t, "change", device=d, mesh=m),
        **query_calls(t, g, files["halves"], files["dims"]),
    }


def mesh_oracles(read_columns: dict, tcols: dict, gcols: dict) -> dict:
    """label -> the NumPy oracle of each aggregation of `mesh_calls`."""
    head = read_columns["headline_u32_w3"][0]
    qty_hit = oracle_mask(tcols["qty"], "ge", 1_000_000_900)
    preds = [("cur", "eq", "EUR"), ("qty", "ge", 1_000_000_500),
             ("day", "ge", np.datetime64("2020-01-01"))]
    ok = np.logical_and.reduce([oracle_mask(tcols[c], op, v) for c, op, v in preds])
    # the currencies by code (sorted words: code order is word order), which
    # numpy counts and orders far faster than 2^24 strings
    codes = np.searchsorted(TABLE_WORDS, tcols["cur"])
    by_cur = GroupOracle(codes, labels=TABLE_WORDS)
    top = np.sort(tcols["price"])[::-1][:100]
    table_stats = {name: oracle_stats(v) for name, v in tcols.items() if name != "cur"}
    table_stats["cur"] = {"sum": None, "min": str(TABLE_WORDS[codes.min()]),
                          "max": str(TABLE_WORDS[codes.max()]), "count": int(codes.size),
                          "n_dict": int(TABLE_WORDS.size)}
    counts = np.bincount(codes, minlength=TABLE_WORDS.size)
    out = {
        "scan_column[headline]": oracle_stats(head),
        "scan_table[table]": {name: table_stats[name] for name in tcols},
        "value_counts[cur]": {str(w): int(c) for w, c in zip(TABLE_WORDS, counts) if c},
        "count_where[headline ge 4]": int((head >= 4).sum()),
        "count_where[cur eq JPY]": int(oracle_mask(tcols["cur"], "eq", "JPY").sum()),
        "scan_where[key where qty ge]": oracle_stats(tcols["key"][qty_hit]),
        "scan_where_multi[3 preds]": oracle_stats(tcols["price"][ok]),
        "group_stats[store->price]": GroupOracle(gcols["store"]).stats(gcols["price"]),
        "group_stats[sku->amount]": GroupOracle(gcols["sku"]).stats(gcols["amount"]),
        "group_stats[cur->price]": by_cur.stats(tcols["price"]),
        "top_k[price]": [float(v) for v in top],
        "quantile[qty]": [lower_quantile(tcols["qty"], q) for q in (0.01, 0.5, 0.99)],
        "median[change]": lower_quantile(tcols["change"], 0.5),
    }
    u, c = np.unique(gcols["units"], return_counts=True)
    out["value_counts[units]"] = dict(zip(u.tolist(), c.tolist()))
    return out


def _host_part(path: str, column, start: int, stop, part, flat: bool):
    """The host reader's rows of the chunks a rank of `part` reads for blocks
    [start, stop) of a file or a table column; `flat`: a whole read, flat
    and cut at the column's length."""
    from fastlanes_tpu_torch.parallel import shard  # noqa: F401  (the rank's share)

    if column is None:
        meta = fio.read_header(path)
    else:
        meta = fio_table._col_meta(fio_table.read_table_header(path), column)
    stop = meta["n_blocks"] if stop is None else stop
    _idxs, first, end = fio_device._covering(meta["chunks"], meta["chunk_blocks"], start,
                                             stop, part)
    host = (fio.read_blocks(path, first, end) if column is None
            else fio_table.read_column(path, column, first, end))
    if flat and meta.get("n_values") is not None:
        host = host.reshape(-1)[:max(0, meta["n_values"] - first * layout.BLOCK)]
    return host


def mesh_read_want(label: str, files: dict, part):
    """The host reader's answer to the read `label` of `mesh_calls` for the
    rank of `part` (None: the whole read): its rows of its chunks."""
    h, t, few = files["headline"], files["table"], files["few"]
    if label.startswith("read_blocks_device"):
        return _host_part(h, None, 5, fio.read_header(h)["n_blocks"] - 3, part, False)
    if label.startswith("read_file_device"):
        return _host_part(h, None, 0, None, part, True)
    if label.startswith(("read_files_device", "iter_files_device")):
        parts = [(p, _host_part(p, None, 0, None, part, True)) for p in few]
        return dict(parts) if label.startswith("read_files") else parts
    return {n: _host_part(t, n, 0, None, part, True)
            for n in fio_table.read_table_header(t)["columns"]}


def same_read(got, want) -> bool:
    """A read's answer against the host reader's (dicts and (path, value)
    lists through, same_host at the leaves)."""
    if isinstance(want, dict):
        return isinstance(got, dict) and list(got) == list(want) and all(
            same_read(got[k], want[k]) for k in want)
    if isinstance(want, list):
        return isinstance(got, list) and len(got) == len(want) and all(
            g[0] == w[0] and same_read(g[1], w[1]) for g, w in zip(got, want))
    if want.size == 0:  # a rank without chunks (the host reader types an empty range its own way)
        while not isinstance(got, torch.Tensor):
            got = got.values if isinstance(got, fio_device.NullableColumn) else got.codes
        return got.numel() == 0
    return same_host(got, want)


def same_device(a, b) -> bool:
    """Two reads on the device, bit for bit, through their wrappers."""
    if isinstance(b, dict):
        return isinstance(a, dict) and list(a) == list(b) and all(
            same_device(a[k], b[k]) for k in b)
    if isinstance(b, list):
        return isinstance(a, list) and len(a) == len(b) and all(
            x[0] == y[0] and same_device(x[1], y[1]) for x, y in zip(a, b))
    if isinstance(b, fio_device.NullableColumn):
        return isinstance(a, fio_device.NullableColumn) and same(a.valid, b.valid) \
            and same_device(a.values, b.values)
    if isinstance(b, fio_table.StringColumn):
        return isinstance(a, fio_table.StringColumn) and same(a.codes, b.codes) \
            and np.array_equal(a.dictionary, b.dictionary)
    return same(a, b)


@contextlib.contextmanager
def mesh_meter():
    """While active, counts the chunks decoded on the device and their
    payload bytes (every decode goes through fio_device's
    `_decode_chunk_device` or `_decode_run_batched`) and the collectives
    (`torch.distributed.all_gather_object`, the combine of parallel/shard.py)."""
    import torch.distributed as dist

    counts = {"chunks": 0, "bytes": 0, "collectives": 0}
    real_chunk, real_run = fio_device._decode_chunk_device, fio_device._decode_run_batched
    real_gather = dist.all_gather_object

    def chunk(meta, raw, *args, **kwargs):
        counts["chunks"] += 1
        counts["bytes"] += len(raw)
        return real_chunk(meta, raw, *args, **kwargs)

    def run(sig, members, *args, **kwargs):
        counts["chunks"] += len(members)
        counts["bytes"] += sum(len(raw) for _, raw in members)
        return real_run(sig, members, *args, **kwargs)

    def gather(*args, **kwargs):
        counts["collectives"] += 1
        return real_gather(*args, **kwargs)

    fio_device._decode_chunk_device, fio_device._decode_run_batched = chunk, run
    dist.all_gather_object = gather
    try:
        yield counts
    finally:
        fio_device._decode_chunk_device, fio_device._decode_run_batched = real_chunk, real_run
        dist.all_gather_object = real_gather


def metered_call(call, mesh, device) -> tuple:
    """(answer, {chunks, bytes, collectives, launches by kernel[dtype]}) of
    one call on `mesh`, synchronised."""
    before = dict(ck.LAUNCHES_BY_DTYPE)
    with mesh_meter() as counts:
        got = call(None, mesh)
        sync_if_cuda(device)
    counts["launches"] = {f"{k}[{d}]": n - before.get((k, d), 0)
                          for (k, d), n in sorted(ck.LAUNCHES_BY_DTYPE.items())
                          if n != before.get((k, d), 0)}
    return got, counts


def walls_of_3(fn, device, barrier=None) -> float:
    """Median wall ms of 3 calls, each synchronised (after a barrier of the
    ranks where one is given)."""
    samples = []
    for _ in range(3):
        if barrier is not None:
            barrier()
        sync_if_cuda(device)
        t0 = time.perf_counter()
        fn()
        sync_if_cuda(device)
        samples.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(samples)


MESH_CHILD = r"""
import json, pickle, sys
rank, store, root, device, files_path, out_path = (int(sys.argv[1]), sys.argv[2], sys.argv[3],
                                                   sys.argv[4], sys.argv[5], sys.argv[6])
sys.path.insert(0, root)
import torch.distributed as dist
import chip_smoke as cs
from fastlanes_tpu_torch import parallel
from fastlanes_tpu_torch.parallel import shard

dist.init_process_group("gloo", init_method="file://" + store, rank=rank, world_size=2)
mesh = parallel.make_mesh(device=device)
dev = cs.eng.resolve_device(device)
with open(files_path) as f:
    files = cs.json.load(f)
part = shard._Part(None, 2, rank)
cs.ck.reset_launches()
report, answers = {}, {}
for label, call in cs.mesh_calls(files).items():
    dist.barrier()
    got, counts = cs.metered_call(call, mesh, dev)
    if label.startswith(cs.MESH_READS):  # this rank's rows, checked here
        counts["equal_to_the_host_reader"] = cs.same_read(got, cs.mesh_read_want(label, files,
                                                                                 part))
    else:
        answers[label] = got
    del got
    report[label] = counts
for label, call in cs.mesh_calls(files).items():
    report[label]["ms"] = cs.walls_of_3(lambda: call(None, mesh), dev, dist.barrier)
with open(out_path, "wb") as f:
    pickle.dump(answers, f)
print(json.dumps({"rank": rank, "backend": dist.get_backend(), "device": str(dev),
                  "calls": report}), flush=True)
dist.destroy_process_group()
"""


def two_rank_mesh_run(files: dict, tmp: str, device) -> tuple:
    """Every call of `mesh_calls` in two child processes on the one card, over
    gloo: -> (each rank's JSON line, each rank's answers but the reads). A
    child that fails, prints no line or runs past its time fails the smoke."""
    import pickle

    root = os.path.dirname(os.path.abspath(__file__))
    files_path = os.path.join(tmp, "mesh_files.json")
    with open(files_path, "w") as f:
        json.dump(files, f)
    store = os.path.join(tmp, "mesh.store")
    child_device = "cuda:0" if device.type == "cuda" else "cpu"
    outs = [os.path.join(tmp, f"mesh_rank{rank}.pkl") for rank in range(2)]
    procs = [subprocess.Popen([sys.executable, "-c", MESH_CHILD, str(rank), store, root,
                               child_device, files_path, outs[rank]], cwd=root,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for rank in range(2)]
    try:
        got = [p.communicate(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    lines, answers = [], []
    for rank, (p, (out, err)) in enumerate(zip(procs, got)):
        found = [line for line in out.splitlines() if line.startswith("{")]
        if p.returncode != 0 or len(found) != 1:
            raise AssertionError(f"mesh child {rank} failed (rc {p.returncode}):\n"
                                 f"{out[-2000:]}\n{err[-4000:]}")
        lines.append(json.loads(found[0]))
        with open(outs[rank], "rb") as f:
            answers.append(pickle.load(f))
    return lines, answers


def same_answer(label: str, got, want) -> bool:
    """Two answers of the mesh call `label` equal: rows by same_rows with
    equal dtypes (unicode widths included), stats by same_stats with the
    same keys in the same order."""
    if label.startswith(MESH_ROWS):
        return same_rows(got, want) and all(got[n].dtype == w.dtype for n, w in want.items())
    return same_stats(got, want) and (not isinstance(want, dict) or list(got) == list(want))


def phase_mesh(read_paths: dict, read_columns: dict, table: dict, groups: dict,
               queries: dict, tmp: str, device=None, card: str = "cpu") -> dict:
    """`mesh=` on the five reads, ten aggregations and two row queries. One
    rank in this process (NCCL on the card): every answer equal to the host
    reader (a read), the NumPy oracle (an aggregation, or the `query` phase's
    oracle of a select or join) and to the call without a mesh, with its wall
    beside the unsharded wall. Then two ranks over gloo on the one card in
    two child processes: each checks its local reads against the host
    reader's rows of its chunks; here each rank's other answers are held to
    the oracles and to each other."""
    from fastlanes_tpu_torch import parallel
    import torch.distributed as dist

    device = eng.resolve_device(device)
    t0 = time.perf_counter()
    files = mesh_files(read_paths, table, groups, queries)
    calls = mesh_calls(files)
    oracles = mesh_oracles(read_columns, table["columns"], groups["columns"])
    oracles.update(queries["oracles"])
    oracle_seconds = time.perf_counter() - t0
    if dist.is_initialized():
        raise AssertionError("a process group is already initialized")
    mesh = parallel.make_mesh(device=device)
    backend = dist.get_backend()

    def check(label, got, rank):
        want = oracles[label]
        if label.startswith(MESH_ROWS):
            if not same_rows(got, want):
                raise AssertionError(f"mesh {label} at {rank}: the rows differ from the "
                                     "oracle's")
        elif not same_answer(label, got, want):
            raise AssertionError(f"mesh {label} at {rank}: {got!r} differs from the "
                                 f"oracle {want!r}"[:2000])

    ck.reset_launches()
    report, answers = {}, {}
    for label, call in calls.items():
        got, report[label] = metered_call(call, mesh, device)
        if label.startswith(MESH_READS):
            if not same_read(got, mesh_read_want(label, files, None)):
                raise AssertionError(f"mesh {label} at one rank differs from the host reader")
        else:
            check(label, got, "one rank")
            answers[label] = got
        del got
    launches, by_dtype = launch_counts()
    for label, call in calls.items():  # the calls without a mesh, the same answers
        plain = call(device, None)
        if label.startswith(MESH_READS):
            if not same_device(call(None, mesh), plain):
                raise AssertionError(f"mesh {label} at one rank differs from the call "
                                     "without a mesh")
        elif not same_answer(label, answers[label], plain):
            raise AssertionError(f"mesh {label}: {answers[label]!r} differs from the call "
                                 f"without a mesh {plain!r}"[:2000])
        del plain
        report[label]["ms"] = walls_of_3(lambda: call(None, mesh), device)
        report[label]["unsharded_ms"] = walls_of_3(lambda: call(device, None), device)
    dist.destroy_process_group()
    del mesh
    world_1_seconds = time.perf_counter() - t0 - oracle_seconds

    t1 = time.perf_counter()
    lines, rank_answers = two_rank_mesh_run(files, tmp, device)
    for line, got in zip(lines, rank_answers):
        bad = [label for label, c in line["calls"].items()
               if c.get("equal_to_the_host_reader") is False]
        if bad:
            raise AssertionError(f"mesh rank {line['rank']}: local reads differ from the "
                                 f"host reader's rows of its chunks: {bad}")
        for label, answer in got.items():
            check(label, answer, f"rank {line['rank']} of 2")
        if device.type == "cuda" and not any(c["launches"] for c in line["calls"].values()):
            raise AssertionError(f"mesh rank {line['rank']} launched no kernel")
    differ = [k for k in rank_answers[0] if not same_answer(k, rank_answers[1][k],
                                                            rank_answers[0][k])]
    if differ:
        raise AssertionError(f"the two ranks' answers differ: {differ}")
    del answers, rank_answers
    emit({"phase": "mesh", "tolerance": 0, "card": card, "device": str(device),
          "split": "rank r of n takes the chunks [r*s, min((r+1)*s, C)), s = ceil(C / n), "
                   "of the C chunks a call covers in each file",
          "oracle": "reads: the host reader's rows of the rank's chunks; aggregations: "
                    "numpy in this script; select and join: the query phase's numpy "
                    "oracles (ties by window, then row); and the call without a mesh",
          "oracle_seconds": oracle_seconds,
          "world_1": {"backend": backend, "seconds": world_1_seconds, "calls": report},
          "world_2": {"backend": lines[0]["backend"], "device": lines[0]["device"],
                      "seconds": time.perf_counter() - t1,
                      "ranks": [line["calls"] for line in lines]},
          "launches": launches})
    return {"launches": launches, "by_dtype": by_dtype}


def same_rows_npz(path: str, rows: dict) -> bool:
    """The .npz a CLI select / join wrote == the library's rows (masked
    columns as X + X__valid, floats bit for bit)."""
    with np.load(path) as data:
        want = {}
        for key, val in rows.items():
            if isinstance(val, np.ma.MaskedArray):
                want[key] = np.asarray(np.ma.getdata(val))
                want[f"{key}__valid"] = ~np.ma.getmaskarray(val)
            else:
                want[key] = val
        if sorted(data.files) != sorted(want):
            return False
        for key, val in want.items():
            got = data[key]
            if got.dtype != val.dtype or got.shape != val.shape:
                return False
            if val.dtype.kind == "f":
                got, val = got.view(np.uint8), val.view(np.uint8)
            if not np.array_equal(got, val):
                return False
    return True


def phase_cli(read_paths: dict, table: dict, query_state: dict, tmp: str,
              device=None, card: str = "cpu") -> dict:
    """`fastlanes_tpu_torch.cli.main` in this process, on the card (no `--on`):
    decompress --device of the headline file, a scan with --where and one with
    --group-by on the table, a select with ORDER BY ... LIMIT and a join. The
    launch counts are read after the CLI calls, before the library calls that
    give each answer to compare with."""
    from fastlanes_tpu_torch import cli

    device = eng.resolve_device(device)
    on = [] if device.type == "cuda" else ["--on", "cpu"]
    tpath, dim = table["path"], query_state["dims"]["currencies"]
    head = read_paths["headline_u32_w3"]
    out_npy, out_sel, out_join = (os.path.join(tmp, n) for n in
                                  ("cli_head.npy", "cli_select.npz", "cli_join.npz"))
    where, cut = 1_000_000_500, 1_000_000_250
    calls = {
        "decompress --device": ["decompress", head, out_npy, "--device"],
        "scan --where": ["scan", tpath, "--column", "qty", "--where", f"gt:{where}"],
        "scan --group-by": ["scan", tpath, "--column", "price", "--group-by", "cur"],
        "select --order-by --limit": ["select", tpath, out_sel, "--columns", "key,price,cur",
                                      "--order-by", "price", "--desc", "--limit", "100"],
        "join": ["join", tpath, dim, out_join, "--on", "cur", "--columns", "key,cur",
                 "--where", f"qty:lt:{cut}", "--how", "left"],
    }
    ck.reset_launches()
    printed, walls = {}, {}
    for label, argv in calls.items():
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            code = cli.main(on + argv)
        walls[label] = (time.perf_counter() - t0) * 1e3
        if code != 0:
            raise AssertionError(f"cli {label}: exit code {code}")
        printed[label] = buf.getvalue().strip()
    launches, by_dtype = launch_counts()

    want = fio_device.read_file_device(head, device=device).cpu().numpy()
    got = np.load(out_npy)
    if got.dtype != want.dtype or not np.array_equal(got, want):
        raise AssertionError("cli decompress --device differs from read_file_device")
    del got, want
    os.remove(out_npy)
    stats = analytics.scan_column(tpath, column="qty", device=device)
    filtered = analytics.scan_where(tpath, "gt", where, column="qty", device=device)
    stats[f"count_gt_{where}"] = filtered["count"]
    stats["where"] = dict(op="gt", value=where, column="qty", **filtered)
    groups = analytics.group_stats(tpath, "cur", "price", preds=[], device=device)
    answers = {
        "scan --where": printed["scan --where"] == json.dumps(stats),
        "scan --group-by": printed["scan --group-by"] == json.dumps(
            {str(g): s for g, s in groups.items()}),
        "select --order-by --limit": same_rows_npz(out_sel, analytics.select(
            tpath, ["key", "price", "cur"], order_by="price", desc=True, limit=100,
            device=device)),
        "join": same_rows_npz(out_join, analytics.join(
            tpath, dim, "cur", columns=["key", "cur"], preds=[("qty", "lt", cut)],
            how="left", device=device)),
    }
    if not all(answers.values()):
        raise AssertionError(f"cli answers differ from the library's: {answers}")
    emit({"phase": "cli", "tolerance": 0, "device": str(device), "card": card,
          "calls": {label: {"argv": " ".join(os.path.basename(a) for a in argv),
                            "wall_ms": walls[label]} for label, argv in calls.items()},
          "import_export": "not driven here: pyarrow is not installed on the card's "
                           "machine (tested on the CPU, tests/test_torch_cli.py)",
          "launches": launches})
    return {"launches": launches, "by_dtype": by_dtype}


# ---------------------------------------------------------------------------
# the example scripts


def load_example(name: str):
    """examples/torch_<name>.py as a module (the scripts are not a package)."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "examples",
                        f"torch_{name}.py")
    spec = importlib.util.spec_from_file_location(f"torch_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def numpy_stats(values: np.ndarray) -> dict:
    return {"sum": int(values.sum(dtype=np.uint64)), "min": int(values.min()),
            "max": int(values.max()), "count": int(values.size)}


# oracle_<name>(got): the answers examples/torch_<name>.py must return, drawn
# again here from the script's seeds at the size it reports in `got`


def oracle_float_columns(got: dict) -> dict:
    rng = np.random.default_rng(7)
    prices = rng.integers(1000, 500_000, 100_000) / 100.0
    temps = (rng.integers(-400, 400, 50_000) / 10.0).astype(np.float32)
    # two decimals: exponent 2, factor 0, every value exact (no exception);
    # the integers are the cents, packed as u64 against their minimum
    cents = np.rint(prices[:96 * 1024] * 100).astype(np.int64)
    width = int(cents.max() - cents.min()).bit_length()
    return {"alp": {"e": 2, "f": 0, "width": width, "exceptions": 0, "ratio": 64 / width},
            "raw_bytes": prices.nbytes, "read_single": float(prices[5 * 1024 + 123]),
            "device_decode": {"dtype": "torch.float32", "values": temps.size,
                              "bits_sum": int(temps.view(np.int32).sum(dtype=np.int64))},
            "table_columns": ["price", "qty", "temp"]}


def oracle_end_to_end(got: dict) -> dict:
    vals = np.random.default_rng(0).integers(0, 1 << 11, (128, 1024),
                                             np.int64).astype(np.uint32)
    sorted_vals = np.sort(vals, axis=1)
    rng = np.random.default_rng(7)
    rng.integers(-50, 50, 3000, np.int64)  # the table's signed column
    col = np.sort(rng.integers(0, 1 << 20, 4000, np.int64).astype(np.uint32))
    tr = npref.transpose(sorted_vals, "u32")
    wd = int(npref.delta(tr, np.ascontiguousarray(tr[:, :32]), "u32").max()).bit_length()
    # sorted rows: delta (W=wd plus a 32-lane base a block) beats bit-packing
    raw, delta_bytes = sorted_vals.nbytes, 128 * (1024 * wd // 8 + 32 * 4)
    return {"unpack_single": 14 % 8, "read_single": int(sorted_vals[3, 777]),
            "auto_encode": {"codec": "delta", "width": wd, "ratio": raw / delta_bytes},
            "mesh_size": 1, "global_width": int(vals.max()).bit_length(),
            "delta_width": wd, "orig_width": wd,
            "table_dtypes": {"id": "uint32", "delta_t": "int16"},
            "scan_column": numpy_stats(col), "count_gt": int((col > (1 << 19)).sum()),
            "u64": {"dtype": "torch.uint64", "shape": [3000]}}


def oracle_compressed_scan(got: dict) -> dict:
    values = np.random.default_rng(0).integers(0, 1 << 7, (got["n_blocks"], layout.BLOCK),
                                               np.int64).astype(np.uint32)
    return {"sum_mod_2_32": int(values.sum(dtype=np.uint64)) % (1 << 32),
            "max": int(values.max()), "count_gt_100": int((values > 100).sum())}


def oracle_table_analytics(got: dict) -> dict:
    n = got["rows"]
    rng = np.random.default_rng(0)
    customer = rng.integers(0, 10_000, n, np.int64).astype(np.uint32)
    qty = rng.integers(1, 30, n, np.int64).astype(np.uint32)
    mask = customer == 4242
    cats = np.array(["EUR", "GBP", "JPY", "USD"])
    return {"raw_mib": 8 * n / 2**20, "hits": int(mask.sum()),
            "total_qty": int(qty[mask].sum()), "scan_where": numpy_stats(qty[mask]),
            "group_tier": {g: int(qty[customer % 5 == g].sum()) for g in range(5)},
            "eur": numpy_stats(qty[customer % 4 == 0]),
            "group_currency": {str(c): int(qty[customer % 4 == i].sum())
                               for i, c in enumerate(cats)}}


def oracle_query_tour(got: dict) -> dict:
    n = got["rows_per_shard"]
    rng = np.random.default_rng(0)
    cats = np.array(["EUR", "GBP", "JPY", "USD"])
    qty, cur, price, null = [], [], [], []
    for _ in range(3):  # the script's draws, shard by shard
        qty.append(rng.integers(0, 1000, n).astype(np.uint32))
        cur.append(cats[rng.integers(0, 4, n)])
        price.append(np.round(rng.normal(100.0, 15.0, n), 2))
        null.append(rng.random(n) < 0.05)
        rng.integers(0, 86_400_000, n)  # the timestamps
    qty, cur, price, null = (np.concatenate(a) for a in (qty, cur, price, null))
    hot = (cur != "JPY") & (qty > 900)
    gbp = np.flatnonzero((cur == "GBP") & ~null)
    top5 = gbp[np.argsort(-price[gbp], kind="stable")[:5]]
    return {"qty_sum": int(qty.sum()), "price_nulls": int(null.sum()),
            "eur": numpy_stats(qty[cur == "EUR"]), "hot_count": int(hot.sum()),
            "group_sums": {str(c): int(qty[cur == c].sum()) for c in cats},
            "group_counts_qty_gt_900": {str(c): int(((cur == c) & (qty > 900)).sum())
                                        for c in cats},
            "distinct": [str(c) for c in cats],
            "value_counts": {str(c): int((cur == c).sum()) for c in cats},
            "top3": sorted(price[~null].tolist(), reverse=True)[:3],
            "select": [(int(qty[i]), str(cur[i]), float(price[i])) for i in top5]}


def phase_examples(device=None, sizes=None, card: str = "cpu") -> dict:
    """Each example script's `main` in this process, on the card (`--on
    cuda`) at its default size (`sizes`: name -> size argument, for a
    rehearsal), every answer held to a NumPy oracle computed here from the
    same seed and size. A script's own checks raise inside it; a wrong
    answer raises here."""
    device = eng.resolve_device(device)
    sizes = sizes or {}
    ck.reset_launches()
    report = {}
    for name in EXAMPLES:
        module = load_example(name)
        before = dict(ck.LAUNCHES_BY_DTYPE)
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            answers = module.main(["--on", device.type, *sizes.get(name, [])])
        wall = time.perf_counter() - t0
        launched = {}
        for (kernel, dtype), n in sorted(ck.LAUNCHES_BY_DTYPE.items()):
            if n != before.get((kernel, dtype), 0):
                launched.setdefault(kernel, {})[dtype] = n - before.get((kernel, dtype), 0)
        want = globals()[f"oracle_{name}"](answers)
        wrong = {k: {"want": v, "got": answers.get(k)} for k, v in want.items()
                 if answers.get(k) != v}
        if wrong:
            raise AssertionError(f"example {name}: answers differ from the oracle: {wrong}")
        report[name] = {"wall_s": wall, "answers": answers, "held_to_oracle": sorted(want),
                        "launches": launched, "printed": buf.getvalue().splitlines()}
    launches, by_dtype = launch_counts()
    emit({"phase": "examples", "tolerance": 0, "device": str(device), "card": card,
          "examples": report, "launches": launches})
    return {"launches": launches, "by_dtype": by_dtype}


# ---------------------------------------------------------------------------
# timing


def time_cuda(fn, reps: int, inner: int = 1) -> float:
    """Median milliseconds of one call of `fn` on the card, after warm-up:
    CUDA events around `inner` calls enqueued back to back, over `inner`.
    With one call between the events the card idles while the host prepares
    the launch, and that wait (tens of microseconds in a Python wrapper)
    would be read as kernel time; behind a queue of launches it hides."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def device_busy_ms(fn):
    """Device time of one call of `fn` from the profiler: (total ms, ms by
    kernel or copy name, largest first), or (None, {}) when the profiler saw
    no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    # device events only: the host-side operator events carry the device time
    # of the kernels they launched, which would count it twice
    by_name = {e.key: e.self_device_time_total / 1e3 for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0}
    if not by_name:
        return None, {}
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
    return sum(by_name.values()), {k[:60]: v for k, v in top}


def wall_and_busy(fn, reps: int) -> dict:
    """End-to-end time of `fn` (which ends in a synchronise): median wall ms
    of `reps` calls after one warm-up, the profiler's device-busy ms of one
    more, and the share of the wall time the device sat idle."""
    fn()
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall_ms = statistics.median(walls)
    busy, by_name = device_busy_ms(fn)
    return {"wall_ms": wall_ms, "device_busy_ms": busy, "device_ms_by_name": by_name,
            "host_share": None if busy is None else max(0.0, 1.0 - busy / wall_ms)}


def kernel_row(name, rec, launches, worst, smi, zigzag_rec=None) -> dict:
    """Time kernel `name` at the launch `rec` (the largest its path made),
    beside its plain version, a device copy of the same size and its bound;
    an original-order kernel also beside the compose form it replaces. The
    zigzag form of delta_pack_orig is held to its plain version and timed at
    `zigzag_rec`, the largest launch the zdelta encode made."""
    dtype, width, src = rec["dtype"], rec["width"], rec["src"]
    if name in ("unfor_pack", "for_pack"):
        param = rec["reference"]
    elif name == "delta_pack_orig":
        param = False  # the zigzag flag; the zigzag form is timed from zigzag_rec
    else:
        param = rec["base"]
    got = call_kernel(name, src, param, width, dtype)
    want = call_kernel(name, src, param, width, dtype, plain=True)
    err = max(worst[name], max_abs_err(got, want))
    if err != 0.0:
        raise AssertionError(f"kernel {name} disagrees with its plain version "
                             f"at the main path's shape: max_abs_err={err}")
    del want
    outs = got if isinstance(got, tuple) else (got,)
    # the copy yardstick: a clone of the larger side (the values)
    values_side = src if name in ENCODE_KERNELS else got
    values_bytes = values_side.numel() * values_side.element_size()
    copy_ms = time_cuda(lambda: torch.clone(values_side), 10, inner=10)
    ms = time_cuda(lambda: call_kernel(name, src, param, width, dtype), 10, inner=10)
    plain_ms = time_cuda(
        lambda: call_kernel(name, src, param, width, dtype, plain=True), 3)
    n_blocks = src.shape[0]
    per_block_ref = isinstance(param, torch.Tensor) and name in ("unfor_pack", "for_pack")
    # the kernel's time with its launch cost spread thin, where the main
    # path's launches are small, and at one chunk's size, where they are not
    sized = {}
    for blocks in (ORACLE_BLOCKS, LARGE_BLOCKS):
        if blocks == n_blocks or name not in ("unfor_pack", "for_pack") \
                and blocks < n_blocks:
            continue
        reps = -(-blocks // n_blocks)
        big = src.repeat(reps, 1)[:blocks]
        big_param = param
        if getattr(param, "ndim", 0) == 2:
            big_param = param.repeat(reps, 1)[:blocks]
        elif per_block_ref:
            big_param = param.repeat(reps)[:blocks]
        sized["ms_at_%d_blocks" % blocks] = time_cuda(
            lambda: call_kernel(name, big, big_param, width, dtype), 10, inner=10)
        del big, big_param
    extra = {}
    if name in ORIG_DECODE_KERNELS or name == "delta_pack_orig":
        extra["compose_ms"] = time_cuda(
            lambda: compose_form(name, src, param, width, dtype), 10, inner=10)
    if zigzag_rec is not None:
        z = zigzag_rec
        zdt = z["dtype"]
        z_err = max_abs_err(call_kernel(name, z["src"], True, z["width"], zdt),
                            call_kernel(name, z["src"], True, z["width"], zdt, plain=True))
        if z_err != 0.0:
            raise AssertionError(f"kernel {name} (zigzag) disagrees with its plain version "
                                 f"at the main path's shape: max_abs_err={z_err}")
        extra["zigzag"] = {
            "dtype": zdt, "width": z["width"], "blocks": z["src"].shape[0],
            "max_abs_err": z_err,
            "ms": time_cuda(lambda: call_kernel(name, z["src"], True, z["width"], zdt),
                            10, inner=10),
            "compose_ms": time_cuda(
                lambda: compose_form(name, z["src"], True, z["width"], zdt), 10, inner=10)}
    moved = rec["src_bytes"] + sum(o.numel() * o.element_size() for o in outs)
    for side in (rec["base"], param if per_block_ref else None):
        if side is not None:
            moved += side.numel() * side.element_size()
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    ops_ms = n_blocks * layout.BLOCK * OPS_PER_VALUE[name] / INT_OPS_PER_S * 1e3
    copy_rate = 2 * values_bytes / (copy_ms * 1e-3)
    return {
        "name": name, "route": "cuda", "source": SOURCE, "replaces": KERNELS[name],
        "launches": launches[name], "max_abs_err": err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,
        "shape": {"dtype": dtype, "width": width, "blocks": n_blocks,
                  "base": None if rec["base"] is None else list(rec["base"].shape),
                  "reference": "per block" if per_block_ref else None},
        "bytes_moved": moved, "operations_bound_ms": ops_ms,
        "achieved_GBps": moved / (ms * 1e-3) / 1e9,
        "copy_ms": copy_ms, "copy_GBps": copy_rate / 1e9,
        "bound_at_copy_rate_ms": moved / copy_rate * 1e3,
        **sized, **extra, "card": smi,
    }


def dtype_rows(rng) -> list:
    """The original-order kernels and their compose forms at LARGE_BLOCKS blocks of every dtype, W = T/4 + 2: the shapes the
    main path gives them are u32 and, smaller, u64 and u16."""
    rows = []
    for dtype in layout.DTYPES:
        t, nl, np_dt = layout.bit_width(dtype), layout.lanes(dtype), layout.np_dtype(dtype)
        width = t // 4 + 2
        plen = layout.packed_len(dtype, width)
        packed = torch.from_numpy(rng.integers(
            0, 1 << min(t, 63), size=(LARGE_BLOCKS, plen), dtype=np.uint64).astype(np_dt)).cuda()
        base = torch.from_numpy(rng.integers(
            0, 1 << min(t, 63), size=(LARGE_BLOCKS, nl), dtype=np.uint64).astype(np_dt)).cuda()
        values = ck.undelta_pack_orig(packed, base, width, dtype)
        row = {"dtype": dtype, "width": width, "blocks": LARGE_BLOCKS,
               "bytes_moved": sum(x.numel() * x.element_size()
                                  for x in (packed, base, values)),
               "copy_ms": time_cuda(lambda: torch.clone(values), 10, inner=10)}
        row["bound_ms"] = row["bytes_moved"] / HBM_BYTES_PER_S * 1e3
        for name, src, param in (("undelta_pack_orig", packed, base),
                                 ("delta_pack_orig", values, False)):
            got = call_kernel(name, src, param, width, dtype)
            want = compose_form(name, src, param, width, dtype)
            if max_abs_err(got, want) != 0.0:
                raise AssertionError(f"{name} {dtype}: differs from its compose form")
            del got, want
            row[name + "_ms"] = time_cuda(
                lambda: call_kernel(name, src, param, width, dtype), 10, inner=10)
            row[name + "_compose_ms"] = time_cuda(
                lambda: compose_form(name, src, param, width, dtype), 10, inner=10)
        row["undelta_pack_ms"] = time_cuda(
            lambda: ck.undelta_pack(packed, base, width, dtype), 10, inner=10)
        rows.append(row)
        del packed, base, values
    return rows


def dtype_rows_at_bound(rng, bound_ms: float = 0.1) -> list:
    """All eleven kernels for every dtype: the seven decode kernels (rows 1-4
    and 8-10), the three transposed-order encode kernels (rows 5-7) and
    delta_pack_orig plain and zigzag (row 11), at a size whose bytes bound is
    at least `bound_ms`, so that a reading under half of its bound can be
    told from launch latency; u32 is the baseline of the same call. A clone
    of the values beside them. W = T/4 + 2, per-block base, per-block
    reference. An encode moves its values, its packed words and its base or
    references (delta_pack_orig writes its base). Each kernel's whole output
    is held bit for bit against its plain version on the same inputs before
    it is timed."""
    rows = []
    for dtype in layout.DTYPES:
        t, nl, np_dt = layout.bit_width(dtype), layout.lanes(dtype), layout.np_dtype(dtype)
        width = t // 4 + 2
        plen = layout.packed_len(dtype, width)
        block_bytes = (layout.BLOCK + plen + nl) * t // 8
        blocks = -(-int(bound_ms * 1e-3 * HBM_BYTES_PER_S / block_bytes) // 1024) * 1024
        words = rng.integers(0, 1 << min(t, 63), size=(1024, plen), dtype=np.uint64)
        packed = torch.from_numpy(words.astype(np_dt)).cuda().repeat(blocks // 1024, 1)
        base = torch.from_numpy(rng.integers(
            0, 1 << min(t, 63), size=(1024, nl), dtype=np.uint64).astype(np_dt)
        ).cuda().repeat(blocks // 1024, 1)
        refs = torch.from_numpy(rng.integers(
            0, 1 << min(t, 63), size=1024, dtype=np.uint64).astype(np_dt)
        ).cuda().repeat(blocks // 1024)
        values = ck.undelta_pack_orig(packed, base, width, dtype)
        sizes = {"packed": packed.numel() * t // 8, "base": base.numel() * t // 8,
                 "refs": refs.numel() * t // 8, "values": values.numel() * t // 8}
        row = {"dtype": dtype, "width": width, "blocks": blocks,
               "clone_ms": time_cuda(lambda: torch.clone(values), 10, inner=10),
               "clone_bound_ms": 2 * sizes["values"] / HBM_BYTES_PER_S * 1e3}
        row["clone_share_of_bound"] = row["clone_bound_ms"] / row["clone_ms"]
        cases = [(name, packed, None, sizes["packed"] + sizes["values"])
                 for name in ("unpack", "unpack_orig")]
        cases += [("unfor_pack", packed, refs, sizes["packed"] + sizes["refs"] + sizes["values"])]
        cases += [(name, packed, base, sizes["packed"] + sizes["base"] + sizes["values"])
                  for name in ("undelta_pack", "unzdelta_pack", "undelta_pack_orig",
                               "unzdelta_pack_orig")]
        cases += [("pack", values, None, sizes["values"] + sizes["packed"]),
                  ("delta_pack", values, base,
                   sizes["values"] + sizes["base"] + sizes["packed"]),
                  ("for_pack", values, refs, sizes["values"] + sizes["refs"] + sizes["packed"])]
        cases += [("delta_pack_orig", values, zigzag,
                   sizes["packed"] + sizes["base"] + sizes["values"]) for zigzag in (False, True)]
        for name, src, param, moved in cases:
            got = call_kernel(name, src, param, width, dtype)
            want = call_kernel(name, src, param, width, dtype, plain=True)
            torch.cuda.synchronize()
            err = max_abs_err(got, want)
            if err != 0.0:
                raise AssertionError(f"{name} {dtype} at {blocks} blocks differs from its "
                                     f"plain version: max_abs_err={err}")
            del got, want
            ms = time_cuda(lambda: call_kernel(name, src, param, width, dtype), 10, inner=10)
            bound = moved / HBM_BYTES_PER_S * 1e3
            row[name + ("_zigzag" if param is True else "")] = {
                "ms": ms, "bound_ms": bound, "share_of_bound": bound / ms,
                "bytes_moved": moved, "max_abs_err": err}
        rows.append(row)
        del packed, base, refs, values
    return rows


#: at most this many (kernel, dtype, width) triples are timed; past it each
#: (kernel, dtype) keeps its widths of the most launches, in turns
MAX_WIDTH_TRIPLES = 60


#: the kernels that take a base: (B, LANES) per block or (LANES,) shared
DELTA_KERNELS = ("undelta_pack", "unzdelta_pack", "undelta_pack_orig", "unzdelta_pack_orig",
                 "delta_pack")


def width_bytes(name, dtype, width, blocks, forms) -> int:
    """The bytes kernel `name` must move at `blocks` blocks: its source and
    its output once each, its base or per-block references once (a shared
    base once in all), delta_pack_orig's base written."""
    kernel = name[:-len("_zigzag")] if name.endswith("_zigzag") else name
    t, nl = layout.bit_width(dtype), layout.lanes(dtype)
    moved = (layout.BLOCK + layout.packed_len(dtype, width)) * t // 8 * blocks
    if kernel in ("unfor_pack", "for_pack"):
        moved += blocks * t // 8 if forms[1] == "per block" else 0
    elif kernel == "delta_pack_orig":
        moved += blocks * nl * t // 8
    elif kernel in DELTA_KERNELS:
        moved += (nl if forms[0] == "shared" else blocks * nl) * t // 8
    return moved


def width_inputs(rng, name, dtype, width, blocks, forms):
    """Seeded inputs of kernel `name` on the card at `blocks` blocks: (src,
    param). A 1024-block pattern repeated (the host makes little); base and
    reference in the form `forms` ((base form, reference form), as
    `operand_form` names them); the zigzag form of delta_pack_orig under the
    name `delta_pack_orig_zigzag`."""
    zigzag = name.endswith("_zigzag")
    kernel = name[:-len("_zigzag")] if zigzag else name
    t, nl, np_dt = layout.bit_width(dtype), layout.lanes(dtype), layout.np_dtype(dtype)
    reps = -(-blocks // 1024)

    def seeded(*shape):
        raw = rng.integers(0, 1 << min(t, 63), size=shape, dtype=np.uint64)
        return torch.from_numpy(raw.astype(np_dt)).cuda()

    cols = layout.BLOCK if kernel in ENCODE_KERNELS else layout.packed_len(dtype, width)
    src = seeded(1024, cols).repeat(reps, 1)[:blocks]
    param = None
    if kernel in ("unfor_pack", "for_pack"):
        param = seeded(1024).repeat(reps)[:blocks] if forms[1] == "per block" \
            else int(rng.integers(0, 1 << min(t, 63)))
    elif kernel == "delta_pack_orig":
        param = zigzag
    elif kernel in DELTA_KERNELS:
        param = seeded(nl) if forms[0] == "shared" else seeded(1024, nl).repeat(reps, 1)[:blocks]
    return src, param


def launched_widths(by_path: dict):
    """Every (kernel, dtype, width) the driven paths launched: {triple:
    {"launches", "blocks" (every launch's), "forms"}} over all paths, and
    the triples to time: all of them, or past MAX_WIDTH_TRIPLES the widths
    of the most launches of each (kernel, dtype), taken in turns."""
    merged = {}
    for recs in by_path.values():
        for key, rec in recs.items():
            m = merged.setdefault(key, {"blocks": [], "forms": {}})
            m["blocks"] += rec["blocks"]
            for form, n in rec["forms"].items():
                m["forms"][form] = m["forms"].get(form, 0) + n
    for m in merged.values():
        m["launches"] = len(m["blocks"])
    if len(merged) <= MAX_WIDTH_TRIPLES:
        return merged, sorted(merged)
    queues = {}
    for key in sorted(merged, key=lambda k: -merged[k]["launches"]):
        queues.setdefault(key[:2], []).append(key)
    chosen = []
    while len(chosen) < MAX_WIDTH_TRIPLES:
        for queue in queues.values():
            if queue and len(chosen) < MAX_WIDTH_TRIPLES:
                chosen.append(queue.pop(0))
    return merged, sorted(chosen)


def kernels_by_width(by_path: dict, smi: str, rng, bound_ms: float = 0.1) -> dict:
    """Every (kernel, dtype, width) the driven paths launched, timed at the
    width the paths gave it: at a block count whose bytes bound is at least
    `bound_ms` (the share of the bound beside a clone of the values in the
    same call; the whole output first held bit for bit against the plain
    version), and at the median block count the paths launched it with,
    where `launches x (ms - bound)` is the time the paths could have saved
    (ms by CUDA events around back-to-back launches: at a small block count
    the host's launch cost; the profiler's device time beside it). Per
    (kernel, dtype): the lowest share over its widths and the summed gap,
    ranked by the gap."""
    t0 = time.perf_counter()
    merged, chosen = launched_widths(by_path)
    rows = []
    for key in chosen:
        name, dtype, width = key
        rec = merged[key]
        forms = max(rec["forms"], key=rec["forms"].get)
        kernel = name[:-len("_zigzag")] if name.endswith("_zigzag") else name
        block_bytes = width_bytes(name, dtype, width, 1, forms)
        big = -(-int(bound_ms * 1e-3 * HBM_BYTES_PER_S / block_bytes) // 1024) * 1024
        src, param = width_inputs(rng, name, dtype, width, big, forms)
        got = call_kernel(kernel, src, param, width, dtype)
        want = call_kernel(kernel, src, param, width, dtype, plain=True)
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        if err != 0.0:
            raise AssertionError(f"{name} {dtype} W={width} at {big} blocks differs from "
                                 f"its plain version: max_abs_err={err}")
        values = src if kernel in ENCODE_KERNELS else got
        del want
        ms = time_cuda(lambda: call_kernel(kernel, src, param, width, dtype), 10, inner=10)
        clone_ms = time_cuda(lambda: torch.clone(values), 10, inner=10)
        moved = width_bytes(name, dtype, width, big, forms)
        bound = moved / HBM_BYTES_PER_S * 1e3
        clone_rate = 2 * values.numel() * values.element_size() / (clone_ms * 1e-3)
        del got, values
        median_blocks = int(statistics.median_low(rec["blocks"]))
        if median_blocks <= big:
            m_src = src[:median_blocks]
            m_param = param[:median_blocks] if isinstance(param, torch.Tensor) and \
                param.shape[0] == big else param
        else:
            m_src, m_param = width_inputs(rng, name, dtype, width, median_blocks, forms)
        m_ms = time_cuda(lambda: call_kernel(kernel, m_src, m_param, width, dtype), 10,
                         inner=10)
        # the device's own time for those launches, from the profiler: where
        # it is far below m_ms, the host's launch cost sets the pace
        busy, _ = device_busy_ms(
            lambda: [call_kernel(kernel, m_src, m_param, width, dtype) for _ in range(10)])
        m_bound = width_bytes(name, dtype, width, median_blocks, forms) / HBM_BYTES_PER_S * 1e3
        rows.append({
            "kernel": name, "dtype": dtype, "width": width, "launches": rec["launches"],
            "forms": {"base": forms[0], "reference": forms[1]},
            "blocks": big, "max_abs_err": err, "ms": ms, "bound_ms": bound,
            "share_of_bound": bound / ms, "clone_ms": clone_ms,
            "share_of_clone": moved / clone_rate * 1e3 / ms,
            "median_blocks": median_blocks, "max_blocks": max(rec["blocks"]),
            "ms_at_median": m_ms, "bound_ms_at_median": m_bound,
            "device_ms_at_median": None if busy is None else busy / 10,
            "launches_x_gap_ms": rec["launches"] * (m_ms - m_bound)})
        del src, param, m_src, m_param
    pairs = {}
    for row in rows:
        p = pairs.setdefault(f"{row['kernel']}[{row['dtype']}]", {
            "lowest_share_of_bound": math.inf, "at_width": None, "launches": 0,
            "launches_x_gap_ms": 0.0})
        if row["share_of_bound"] < p["lowest_share_of_bound"]:
            p["lowest_share_of_bound"], p["at_width"] = row["share_of_bound"], row["width"]
        p["launches"] += row["launches"]
        p["launches_x_gap_ms"] += row["launches_x_gap_ms"]
    ranked = dict(sorted(pairs.items(), key=lambda kv: -kv[1]["launches_x_gap_ms"]))
    dropped = [k for k in merged if k not in chosen]
    return {"phase": "kernels_by_width", "card": smi, "bound_rate_Bps": HBM_BYTES_PER_S,
            "bound_at_least_ms": bound_ms, "triples_launched": len(merged),
            "triples_timed": len(rows),
            "collapsed": None if not dropped else {
                "rule": f"over {MAX_WIDTH_TRIPLES} triples: the widths of the most "
                        "launches of each (kernel, dtype), in turns",
                "triples_left_out": len(dropped),
                "launches_left_out": sum(merged[k]["launches"] for k in dropped)},
            "under_half_of_bound": [f"{r['kernel']}[{r['dtype']}] W={r['width']}"
                                    for r in rows if r["share_of_bound"] < 0.5],
            "by_kernel_dtype": ranked, "rows": rows,
            "seconds": time.perf_counter() - t0}


def timed_entry(fn, reps: int = 3) -> dict:
    """wall_and_busy of `fn` (which ends in a synchronise) plus the launches,
    gather passes and host fetches of one call."""
    _, counts = counted(fn)
    return dict(wall_and_busy(fn, reps), **counts)


def host_encode_costs(dev: dict) -> dict:
    """What the codecs' host round trips cost: one scalar pull of a width
    probe (beside the device time of its reduction), and for rle / dict the
    copy back to the host and the numpy run / distinct-value detection."""
    def wall_ms(fn, reps=3):
        fn()
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    head = dev["headline_u32_w3"]
    vec = eng.to_vec(head, "u32")
    out = {"max_probe_2^27_u32": {
        "wall_ms": wall_ms(lambda: codecs._device_max(head, "u32"), 5),
        "device_ms": time_cuda(lambda: (vec ^ -(1 << 31)).max(), 5, inner=5)}}
    for name, parts in (("rle_u32", fio._rle_parts), ("dict_u32", fio._dict_parts)):
        values = dev[name]
        host = values.cpu().numpy()
        out[name] = {"copy_back_ms": wall_ms(lambda: values.cpu().numpy(), 2),
                     "host_numpy_ms": wall_ms(lambda: parts(host), 1)}
    return out


Q1_ROWS = 6_001_215  # TPC-H LINEITEM at SF1


def q1_group_columns(seed: int) -> dict:
    """Device columns of TPC-H Q1's GROUP BY shape: a u8 key of 3 groups
    (l_returnflag's codes), f64 decimals (l_extendedprice) and u8 values
    (l_quantity), and a WHERE mask keeping about half the rows."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    n = Q1_ROWS
    cents = torch.randint(90_000, 10_500_000, (n,), device="cuda", generator=gen)
    return {"key": torch.randint(0, 3, (n,), device="cuda", generator=gen).to(torch.uint8),
            "f64": cents.to(torch.float64) / torch.tensor(100.0, device="cuda",
                                                           dtype=torch.float64),
            "u8": torch.randint(1, 51, (n,), device="cuda", generator=gen).to(torch.uint8),
            "mask": torch.rand(n, device="cuda", generator=gen) < 0.5}


def group_accumulator_rows(table_path: str, group_path: str) -> list:
    """The group accumulator's kernel (kernels/cuda_group.py) against its
    plain version (_GroupAcc.feed_plain, the copies spread as it chooses) on
    the card: at TPC-H Q1's shape (6 M rows, 3 groups, f64 and u8 values, a
    mask) and on the group table's 1000 and 65536 groups. Each row holds the
    fetched state of both equal, then times one feed of each (CUDA events)
    beside the kernel's bytes bound (key, value and mask read once) and one
    scatter_reduce_ amin of the plain version's extremes (`library_ms`)."""
    rows = []
    device = torch.device("cuda")
    q1 = q1_group_columns(SEED + 12)
    inputs = [(f"q1 returnflag->{v}", q1["key"], q1[v], q1["mask"], 3) for v in ("f64", "u8")]
    for path, key, value in ((table_path, "cur", "price"), (group_path, "store", "price"),
                             (group_path, "sku", "amount")):
        (kb, kdt, kvt, valid, _), = analytics._decoded_chunks(path, key, device, window=1 << 20)
        (vb, vdt, vvt, _, _), = analytics._decoded_chunks(path, value, device, window=1 << 20)
        kb, vb = kb.reshape(-1)[:valid], vb.reshape(-1)[:valid]
        fk = analytics._flatten_logical(kb, kdt, kvt)
        inputs.append((f"{key}->{value}", kb, vb, None,
                       int((fk.key.to(torch.int64) + fk.offset).max()) + 1))
    for label, keys, values, mask, k in inputs:
        flat_k = analytics._flatten_logical(keys, None, None)
        flat_v = analytics._flatten_logical(values, None, None)
        valid = len(flat_v)
        accs = {mode: analytics._GroupAcc(k, flat_v, device, plain=mode == "plain")
                for mode in ("kernel", "plain")}
        for acc in accs.values():
            acc.feed(flat_k, flat_v, valid, mask)
        got, want = (accs[m].host_state()[2][0] for m in ("kernel", "plain"))
        if not all(np.array_equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"group accumulator {label}: the kernel's state differs "
                                 "from the plain version's")
        ms = {m: time_cuda(lambda: acc.feed(flat_k, flat_v, valid, mask), 5)
              for m, acc in accs.items()}
        plain = accs["plain"]
        group = (flat_k.key.to(torch.int64) + flat_k.offset).clamp(0, k)
        slot = torch.arange(valid, device=device) % plain.spread * (k + 1) + group
        ext = flat_v.key.to(torch.int64)
        read_bytes = valid * (flat_k.key.element_size() + flat_v.key.element_size()
                              + (0 if mask is None else 1))
        rows.append({"path": label, "groups": k, "rows": valid, "kind": plain.kind,
                     "mode": accs["kernel"].mode, "kernel_spread": accs["kernel"].spread,
                     "plain_spread": plain.spread, "equal": True,
                     "kernel_ms": ms["kernel"], "plain_ms": ms["plain"],
                     "bound_ms": read_bytes / HBM_BYTES_PER_S * 1e3, "bound_bytes": read_bytes,
                     "library_ms": time_cuda(
                         lambda: plain.mn.scatter_reduce_(0, slot, ext, "amin"), 5)})
        del accs, plain, group, slot, ext
    return rows


def phase_timing(paths: dict, read_launches: dict, encode_state: dict,
                 transposed_state: dict, worst: dict, smi: str, entries: dict,
                 accumulator: list, rows_out: dict) -> list:
    entries = {label: timed_entry(fn, 1 if label.startswith("median") else 3)
               for label, fn in entries.items()}
    for label, rows in rows_out.items():  # the queries: rows out and rows/s
        entries[label].update(rows_out=rows,
                              rows_per_s=rows / (entries[label]["wall_ms"] * 1e-3))
    timed_columns = ["headline_u32_w3", "ffor_u32", "delta_u32", "zdelta_u32"]
    with largest_launches() as seen:
        for column in timed_columns:
            fio_device.read_file_device(paths[column])
        unpack_orig_of_headline(paths["headline_u32_w3"], torch.device("cuda"))
    torch.cuda.synchronize()
    rows = [dict(kernel_row(name, seen[name], read_launches, worst, smi),
                 timed_on_path="read") for name in READ_KERNELS]
    seen.clear()
    seen = encode_state["seen"]
    rows += [dict(kernel_row(name, seen[name], encode_state["launches"], worst, smi,
                             zigzag_rec=seen.get(name + "_zigzag")),
                  timed_on_path="encode") for name in ENCODE_PATH_KERNELS]
    seen.clear()
    seen = transposed_state["seen"]
    rows += [dict(kernel_row(name, seen[name], transposed_state["launches"], worst, smi),
                  timed_on_path="transposed") for name in TRANSPOSED_KERNELS]
    seen.clear()
    rows.sort(key=lambda row: list(KERNELS).index(row["name"]))

    reads = {}
    for column in timed_columns:
        path = paths[column]

        def read():
            fio_device.read_file_device(path)
            torch.cuda.synchronize()

        reads[column] = wall_and_busy(read, 3)
        reads[column].update(values=fio.read_header(path)["n_values"],
                             file_bytes=os.path.getsize(path))

    dev = encode_state["device_columns"]
    encodes = {}
    for column, how in ENCODE_COLUMNS.items():
        values = dev[column]
        encoder = encoder_of(how, _DTYPE_OF[values.dtype])

        def encode():
            encoder(values)
            torch.cuda.synchronize()

        # rle and dict encode spend seconds in host numpy: one timed run
        encodes[column] = wall_and_busy(encode, 1 if column in ("rle_u32", "dict_u32") else 3)
        encodes[column].update(values=values.numel(), how=how)
    emit({"phase": "timing", "card": smi, "reads": reads, "encodes": encodes,
          "entries": entries,
          "group_accumulator": accumulator,
          "host_round_trips": host_encode_costs(dev),
          "orig_kernels_by_dtype": dtype_rows(np.random.default_rng(SEED + 2)),
          "kernels_by_dtype_at_0.1ms_bound": dtype_rows_at_bound(
              np.random.default_rng(SEED + 6))})
    return rows


def slice_entries(alp_state, table, files, read_paths, groups, queries) -> dict:
    """label -> callable (ending in a synchronise) of every entry of the float,
    table, multi-file, scan, aggregate and query paths that the timing phase
    measures."""
    tpath, gpath = table["path"], groups["path"]
    all_files = files["shards"] + files["others"]

    def synced(fn):
        def run():
            fn()
            torch.cuda.synchronize()
        return run

    def drain():
        for _ in fio_device.iter_files_device(all_files):
            pass

    entries = {f"read_file_device[{name}]": synced(
        lambda path=path: fio_device.read_file_device(path))
        for name, path in alp_state["paths"].items()}
    entries.update({f"read_column_device[{name}]": synced(
        lambda name=name: fio_device.read_column_device(tpath, name))
        for name in table["columns"]})
    entries.update({
        "read_files_device[20 files]": synced(lambda: fio_device.read_files_device(all_files)),
        "iter_files_device[20 files]": synced(drain),
        "scan_table": synced(lambda: analytics.scan_table(tpath)),
        "scan_column[headline_u32_w3]": synced(
            lambda: analytics.scan_column(read_paths["headline_u32_w3"])),
        "scan_column[delta_u32]": synced(lambda: analytics.scan_column(read_paths["delta_u32"])),
        "scan_column[16 shards]": synced(lambda: analytics.scan_column(files["shards"])),
        "scan_column[price]": synced(lambda: analytics.scan_column(tpath, "price")),
        "count_where[qty gt]": synced(
            lambda: analytics.count_where(tpath, "gt", 1_000_000_500, column="qty")),
        "count_where[price le]": synced(
            lambda: analytics.count_where(tpath, "le", 50_000.25, column="price")),
        "count_where[day ge]": synced(lambda: analytics.count_where(
            tpath, "ge", np.datetime64("2020-02-29"), column="day")),
        "count_where[cur eq]": synced(
            lambda: analytics.count_where(tpath, "eq", "JPY", column="cur")),
        "count_where[zone-resolved]": synced(
            lambda: analytics.count_where(tpath, "lt", 2_000_000_000, column="qty")),
        "scan_where[price gt]": synced(
            lambda: analytics.scan_where(tpath, "gt", 75_000.5, column="price")),
        "scan_where[price where cur eq]": synced(lambda: analytics.scan_where(
            tpath, "eq", "EUR", column="price", where="cur")),
        "scan_where[key where qty ge]": synced(lambda: analytics.scan_where(
            tpath, "ge", 1_000_000_900, column="key", where="qty")),
        "group_stats[cur->price]": synced(
            lambda: analytics.group_stats(tpath, "cur", "price")),
        "group_stats[store->price]": synced(
            lambda: analytics.group_stats(gpath, "store", "price")),
        "group_stats[sku->amount]": synced(
            lambda: analytics.group_stats(gpath, "sku", "amount")),
        "scan_where_multi[3 preds]": synced(lambda: analytics.scan_where_multi(
            tpath, [("cur", "eq", "EUR"), ("qty", "ge", 1_000_000_500),
                    ("day", "ge", np.datetime64("2020-01-01"))], column="price")),
        "value_counts[cur]": synced(lambda: analytics.value_counts(tpath, "cur")),
        "value_counts[units]": synced(lambda: analytics.value_counts(gpath, "units")),
        "top_k[price]": synced(lambda: analytics.top_k(tpath, "price", k=100)),
        "median[price]": synced(lambda: analytics.median(tpath, "price")),
    })
    entries.update({label: synced(lambda call=call: call(None))
                    for label, call in queries["calls"].items()})
    return entries


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device: torch.cuda.is_available() is "
              "false, and the port's smoke run never carries on on the CPU",
              file=sys.stderr)
        return 1
    rng = np.random.default_rng(SEED)
    info = phase_device()
    phase_build()
    phase_warmup(info["nvidia_smi"])
    worst = phase_kernels(rng)
    phase_native(np.random.default_rng(SEED + 9))
    columns = make_columns(rng, 1)
    with tempfile.TemporaryDirectory(prefix="fastlanes_smoke_") as tmp:
        # every path is driven with the launch counts set to 0 just before it
        # and read just after; then every (kernel, dtype) shape the path
        # launched is held against the plain version on the same tensors
        by_path, dtypes_by_path, shapes_by_path, widths_by_path = {}, {}, {}, {}

        def drive(path_name, phase, needs):
            hook = largest_launches(per_dtype=True)
            with hook as seen:
                state = phase()
            by_path[path_name] = state["launches"]
            dtypes_by_path[path_name] = state["by_dtype"]
            widths_by_path[path_name] = hook.by_width(state["launches"])
            if any(sum(state["by_dtype"].get(k, {}).values()) != n
                   for k, n in state["launches"].items()):
                raise AssertionError(f"the {path_name} path's launches by dtype "
                                     f"{state['by_dtype']} do not add up to {state['launches']}")
            missing = [k for k in needs if state["launches"][k] == 0]
            if missing:
                raise AssertionError(f"the {path_name} path launched no {missing} kernel")
            shapes_by_path[path_name] = hold_path_shapes(path_name, seen)
            return state

        read_state = drive("read", lambda: phase_read(columns, tmp), READ_KERNELS)
        encode_state = drive("encode", lambda: phase_encode(columns), ENCODE_PATH_KERNELS)
        transposed_state = drive("transposed", lambda: phase_transposed(encode_state),
                                 TRANSPOSED_KERNELS)
        encoded = encode_state.pop("encoded")
        shard_encoded = {n: encoded[n] for n in ("ffor_u32", "delta_u32", "zdelta_u32")}
        del encoded
        alp_state = drive("alp", lambda: phase_alp(tmp, 1), ("unpack", "pack"))
        alp_state.pop("columns")
        table = drive("table", lambda: phase_table(tmp, 1),
                      ("unpack", "unfor_pack", "undelta_pack_orig"))
        files = drive("files", lambda: phase_files(tmp, 1), ("unpack", "unfor_pack"))
        drive("scan", lambda: phase_scan(read_state["paths"], columns, table, files),
              ("unpack", "unfor_pack", "undelta_pack", "unzdelta_pack",
               "undelta_pack_orig"))
        groups = drive("aggregate", lambda: phase_aggregate(table, tmp, 1),
                       ("unpack", "unfor_pack", "undelta_pack", "undelta_pack_orig"))
        queries = drive("query", lambda: phase_query(table, groups, tmp),
                        ("unpack", "unfor_pack", "undelta_pack_orig"))
        drive("mesh", lambda: phase_mesh(read_state["paths"], columns, table, groups, queries,
                                         tmp, card=info["nvidia_smi"]), MESH_KERNELS)
        queries.pop("oracles")
        drive("shard", lambda: phase_shard(columns, encode_state["device_columns"],
                                           shard_encoded, tmp, card=info["nvidia_smi"]),
              SHARD_KERNELS)
        del shard_encoded
        drive("cli", lambda: phase_cli(read_state["paths"], table, queries, tmp,
                                       card=info["nvidia_smi"]), CLI_KERNELS)
        del columns
        drive("examples", lambda: phase_examples(card=info["nvidia_smi"]), EXAMPLE_KERNELS)
        files.pop("shard_values")
        entries = slice_entries(alp_state, table, files, read_state["paths"], groups, queries)
        table.pop("columns")
        groups.pop("columns")
        accumulator = group_accumulator_rows(table["path"], groups["path"])
        rows = phase_timing(read_state["paths"], read_state["launches"], encode_state,
                            transposed_state, worst, info["nvidia_smi"], entries, accumulator,
                            queries["rows_out"])
        if [row["name"] for row in rows] != list(KERNELS):
            raise AssertionError(f"kernel rows: {[row['name'] for row in rows]}")
        emit(kernels_by_width(widths_by_path, info["nvidia_smi"],
                              np.random.default_rng(SEED + 11)))
    for row in rows:
        # the count over every driven path, by dtype, and path by path beside
        # the shapes held there; `shape`, `ms` and the bounds are those of the
        # largest launch of the path named in `timed_on_path` alone
        name = row["name"]
        row["launches_by_path"] = {
            p: {"launches": c[name], "by_dtype": dtypes_by_path[p][name],
                "shapes": shapes_by_path[p][name]}
            for p, c in by_path.items() if c[name]}
        row["launches"] = sum(v["launches"] for v in row["launches_by_path"].values())
        by_dtype = {}
        for v in row["launches_by_path"].values():
            for dtype, n in v["by_dtype"].items():
                by_dtype[dtype] = by_dtype.get(dtype, 0) + n
        row["launches_by_dtype"] = dict(sorted(by_dtype.items()))
        if row["launches"] == 0:
            raise AssertionError(f"kernel {row['name']} was launched on no driven path")
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu", "kind": info["kind"],
                                 "count": info["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
