#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (fastlanes_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from csrc/ with nvcc, holds each of the eleven against
its plain PyTorch version on the card (bit for bit), then drives the port's
main paths. The device-side column read: FLT files of every integer codec
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
then times each kernel at the largest shape its path gave it, beside its
bound, its plain version and a device copy, and each read and each encode
end to end.

Needs one CUDA device and nvcc; it never runs on the CPU. Every phase prints
one JSON line; any failed phase raises and the exit code is not 0. The last
line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

import fastlanes_tpu_torch
from fastlanes_tpu_torch import fio, fio_device, transforms
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
    t0 = time.perf_counter()
    path = build.build(force=True)
    build.load()
    log = build.last_build_log or ""
    registers = [int(n) for n in re.findall(r"Used (\d+) registers", log)]
    spills = [int(n) for n in re.findall(r"(\d+) bytes spill stores", log)]
    emit({"phase": "build", "library": os.path.relpath(path),
          "nvcc_seconds": build.last_build_seconds,
          "kernel_instantiations": len(registers),
          "max_registers": max(registers, default=None),
          "max_spill_store_bytes": max(spills, default=None),
          "seconds": time.perf_counter() - t0})


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
          "cases": cases, "max_abs_err": worst})
    return worst


def make_columns(rng, scale: int) -> dict:
    """name -> (values, codec argument, expected chunk codecs or None).
    `scale` divides every size (1 = the full run)."""
    n27, n25, n24 = HEADLINE_BLOCKS * layout.BLOCK // scale, (1 << 25) // scale, (1 << 24) // scale
    n22 = (1 << 22) // scale
    run_lengths = rng.integers(200, 3000, size=n25 // 200)
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
        "rle_u32": (np.repeat(run_values, run_lengths)[:n25], "auto", {"rle"}),
        "dict_u32": (dictionary[rng.integers(0, 200, size=n25)], "auto", {"dict"}),
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
    launches = dict(ck.LAUNCHES)
    read_seconds = time.perf_counter() - t0
    emit({"phase": "read", "tolerance": 0, "columns": report,
          "range": [start, stop], "launches": launches, "gather_passes": n_gathers,
          "unfor_pack_launches": launches["unfor_pack"],
          "write_seconds": write_seconds, "read_and_compare_seconds": read_seconds})
    return {"paths": paths, "launches": launches}


class largest_launches:
    """While active, keeps per kernel the arguments of the largest launch
    made: the shapes a path gives a kernel. `seen[name]` holds the source
    tensor, base, reference, width and dtype of that launch (the zigzag form
    of delta_pack_orig under `delta_pack_orig_zigzag`)."""

    def __init__(self):
        self.seen = {}

    def __enter__(self):
        self.real = ck._launch

        def spy(name, src2d, base, reference, width, dtype, zigzag=False):
            size = src2d.numel() * src2d.element_size()
            key = name + "_zigzag" if zigzag else name
            if key not in self.seen or size > self.seen[key]["src_bytes"]:
                self.seen[key] = {"src": src2d, "base": base, "reference": reference,
                                  "width": width, "dtype": dtype, "src_bytes": size}
            return self.real(name, src2d, base, reference, width, dtype, zigzag=zigzag)

        ck._launch = spy
        return self.seen

    def __exit__(self, *exc):
        ck._launch = self.real
        return False


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
        _, base, deltas = fio._delta_parts(blocks, dt)
        if enc.codec == "zdelta":
            deltas = fio._zigzag_deltas(deltas)
        want = npref.pack(deltas, w, dt)
        if not np.array_equal(host("base", lo, hi), base):
            raise AssertionError(f"{name}: base of blocks [{lo}, {hi}) differs from the oracle")
    elif enc.codec == "rle":
        counts, run_values, idx = fio._rle_parts(blocks)
        _, base, deltas = fio._delta_parts(idx, "u16")
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
    launches = dict(ck.LAUNCHES)
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
    return {"device_columns": dev, "launches": launches, "seen": seen, "encoded": encoded}


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
    launches = dict(ck.LAUNCHES)
    emit({"phase": "transposed", "tolerance": 0, "launches": launches})
    return {"launches": launches, "seen": seen}


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
        z_err = max_abs_err(call_kernel(name, z["src"], True, z["width"], dtype),
                            call_kernel(name, z["src"], True, z["width"], dtype, plain=True))
        if z_err != 0.0:
            raise AssertionError(f"kernel {name} (zigzag) disagrees with its plain version "
                                 f"at the main path's shape: max_abs_err={z_err}")
        extra["zigzag"] = {
            "width": z["width"], "blocks": z["src"].shape[0], "max_abs_err": z_err,
            "ms": time_cuda(lambda: call_kernel(name, z["src"], True, z["width"], dtype),
                            10, inner=10),
            "compose_ms": time_cuda(
                lambda: compose_form(name, z["src"], True, z["width"], dtype), 10, inner=10)}
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


def phase_timing(paths: dict, read_launches: dict, encode_state: dict,
                 transposed_state: dict, worst: dict, smi: str) -> list:
    timed_columns = ["headline_u32_w3", "ffor_u32", "delta_u32", "zdelta_u32"]
    with largest_launches() as seen:
        for column in timed_columns:
            fio_device.read_file_device(paths[column])
        unpack_orig_of_headline(paths["headline_u32_w3"], torch.device("cuda"))
    torch.cuda.synchronize()
    rows = [kernel_row(name, seen[name], read_launches, worst, smi)
            for name in READ_KERNELS]
    seen.clear()
    seen = encode_state["seen"]
    rows += [kernel_row(name, seen[name], encode_state["launches"], worst, smi,
                        zigzag_rec=seen.get(name + "_zigzag"))
             for name in ENCODE_PATH_KERNELS]
    seen.clear()
    seen = transposed_state["seen"]
    rows += [kernel_row(name, seen[name], transposed_state["launches"], worst, smi)
             for name in TRANSPOSED_KERNELS]
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
          "host_round_trips": host_encode_costs(dev),
          "orig_kernels_by_dtype": dtype_rows(np.random.default_rng(SEED + 2))})
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device: torch.cuda.is_available() is "
              "false, and the port's smoke run never carries on on the CPU",
              file=sys.stderr)
        return 1
    rng = np.random.default_rng(SEED)
    info = phase_device()
    phase_build()
    worst = phase_kernels(rng)
    columns = make_columns(rng, 1)
    with tempfile.TemporaryDirectory(prefix="fastlanes_smoke_") as tmp:
        read_state = phase_read(columns, tmp)
        missing = [k for k in READ_KERNELS if read_state["launches"][k] == 0]
        if missing:
            raise AssertionError(f"the reads launched no {missing} kernel")
        encode_state = phase_encode(columns)
        missing = [k for k in ENCODE_PATH_KERNELS if encode_state["launches"][k] == 0]
        if missing:
            raise AssertionError(f"the encodes launched no {missing} kernel")
        transposed_state = phase_transposed(encode_state)
        missing = [k for k in TRANSPOSED_KERNELS if transposed_state["launches"][k] == 0]
        if missing:
            raise AssertionError(f"the transposed-order entries launched no {missing} kernel")
        del columns
        encode_state.pop("encoded")
        rows = phase_timing(read_state["paths"], read_state["launches"], encode_state,
                            transposed_state, worst, info["nvidia_smi"])
        if [row["name"] for row in rows] != list(KERNELS):
            raise AssertionError(f"kernel rows: {[row['name'] for row in rows]}")
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu", "kind": info["kind"],
                                 "count": info["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
