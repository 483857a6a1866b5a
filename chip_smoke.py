#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (fastlanes_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from csrc/ with nvcc, holds each of the seven against
its plain PyTorch version on the card (bit for bit), then drives the port's
two main paths. The device-side column read: FLT files of every integer codec
are written with the port's host writer from seeded numpy data, read back
with `read_file_device` / `read_blocks_device` on the GPU and compared bit
for bit with the host reader. The device-side column encode: the same columns,
moved to the card, go through the codec classes (`BitPackedCodec.encode`,
`auto_encode`, `get_codec(...).encode`), every `Encoded` is decoded again by
its codec and compared bit for bit with the input, and its payload is held
against the NumPy oracle on the first and last 1 024 blocks. The headline
column is 131 072 blocks (2^27 u32 values, 512 MiB) at W=3 on both paths. It
then times each kernel at the largest shape its path gave it, beside its
bound, its plain version and a device copy, and each read and each encode
end to end.

Needs one CUDA device and nvcc; it never runs on the CPU. Every phase prints
one JSON line; any failed phase raises and the exit code is not 0. The last
line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

import fastlanes_tpu_torch
from fastlanes_tpu_torch import fio, fio_device
from fastlanes_tpu_torch.core import layout
from fastlanes_tpu_torch.kernels import build
from fastlanes_tpu_torch.kernels import cuda_codecs as ck
from fastlanes_tpu_torch.models import codecs
from fastlanes_tpu_torch.ops import _engine as eng
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
                 "unzdelta_pack": 9, "pack": 4, "delta_pack": 5, "for_pack": 5}

#: kernel -> the TPU kernel it replaces; the first four carry the read path,
#: the last three the encode path
KERNELS = {
    "unpack": "fastlanes_tpu/kernels/pallas_codecs.py:635",
    "unfor_pack": "fastlanes_tpu/kernels/pallas_codecs.py:721",
    "undelta_pack": "fastlanes_tpu/kernels/pallas_codecs.py:656",
    "unzdelta_pack": "fastlanes_tpu/kernels/pallas_codecs.py:674",
    "pack": "fastlanes_tpu/kernels/pallas_codecs.py:611",
    "delta_pack": "fastlanes_tpu/kernels/pallas_codecs.py:706",
    "for_pack": "fastlanes_tpu/kernels/pallas_codecs.py:898",
}
DECODE_KERNELS = ("unpack", "unfor_pack", "undelta_pack", "unzdelta_pack")
ENCODE_KERNELS = ("pack", "delta_pack", "for_pack")
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


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """0.0 for equal tensors, else the largest |a - b| of the unsigned values."""
    if same(a, b):
        return 0.0
    a64 = torch.from_numpy(a.cpu().numpy().astype(np.float64))
    b64 = torch.from_numpy(b.cpu().numpy().astype(np.float64))
    return float((a64 - b64).abs().max())


def call_kernel(name, src, param, width, dtype, plain=False):
    fn = getattr(ck, name + "_plain" if plain else name)
    if name in ("unpack", "pack"):
        return fn(src, width, dtype)
    return fn(src, param, width, dtype)


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
    emit({"phase": "build", "library": os.path.relpath(path),
          "nvcc_seconds": build.last_build_seconds,
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
            params = {
                "unpack": [None],
                "unfor_pack": [0, (1 << t) - 1],
                "undelta_pack": [per_block[0].clone(), per_block],
                "unzdelta_pack": [per_block[0].clone(), per_block],
                "pack": [None],
                "delta_pack": [per_block[0].clone(), per_block],
                "for_pack": [0, (1 << t) - 1],
            }
            for name, plist in params.items():
                src = values if name in ENCODE_KERNELS else packed
                for param in plist:
                    got = call_kernel(name, src, param, width, dtype)
                    want = call_kernel(name, src, param, width, dtype, plain=True)
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
    if shapes != [(0, 96)] * 3 or ck.LAUNCHES != before:
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


def phase_read(columns: dict, tmp: str, device=None) -> dict:
    """The read path: write every column of `make_columns`, then read each on
    the device with the launch counts reset just before and read just after."""
    paths, report = {}, {}
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
    for name, path in paths.items():
        before = dict(ck.LAUNCHES)
        report[name].update(read_and_check(path, device))
        report[name]["launches"] = {k: v - before[k] for k, v in ck.LAUNCHES.items()
                                    if v != before[k]}
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
          "range": [start, stop], "launches": launches,
          "write_seconds": write_seconds, "read_and_compare_seconds": read_seconds})
    return {"paths": paths, "launches": launches}


class largest_launches:
    """While active, keeps per kernel the arguments of the largest launch
    made: the shapes a path gives a kernel. `seen[name]` holds the source
    tensor, base, reference, width and dtype of that launch."""

    def __init__(self):
        self.seen = {}

    def __enter__(self):
        self.real = ck._launch

        def spy(name, src2d, base, reference, width, dtype):
            size = src2d.numel() * src2d.element_size()
            if name not in self.seen or size > self.seen[name]["src_bytes"]:
                self.seen[name] = {"src": src2d, "base": base, "reference": reference,
                                   "width": width, "dtype": dtype, "src_bytes": size}
            return self.real(name, src2d, base, reference, width, dtype)

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
    with largest_launches() as seen:
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
          "oracle_blocks_each_end": ORACLE_BLOCKS, "encode_seconds": encode_seconds})
    return {"device_columns": dev, "launches": launches, "seen": seen}


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


def kernel_row(name, rec, launches, worst, smi) -> dict:
    """Time kernel `name` at the launch `rec` (the largest its path made),
    beside its plain version, a device copy of the same size and its bound."""
    dtype, width, src = rec["dtype"], rec["width"], rec["src"]
    param = rec["reference"] if name in ("unfor_pack", "for_pack") else rec["base"]
    got = call_kernel(name, src, param, width, dtype)
    want = call_kernel(name, src, param, width, dtype, plain=True)
    err = max(worst[name], max_abs_err(got, want))
    if err != 0.0:
        raise AssertionError(f"kernel {name} disagrees with its plain version "
                             f"at the main path's shape: max_abs_err={err}")
    del want
    # the copy yardstick: a clone of the larger side (the values)
    values_side = src if name in ENCODE_KERNELS else got
    values_bytes = values_side.numel() * values_side.element_size()
    copy_ms = time_cuda(lambda: torch.clone(values_side), 10, inner=10)
    ms = time_cuda(lambda: call_kernel(name, src, param, width, dtype), 10, inner=10)
    plain_ms = time_cuda(
        lambda: call_kernel(name, src, param, width, dtype, plain=True), 3)
    n_blocks = src.shape[0]
    # where the main path's launches are small (ffor decodes chunk by
    # chunk), also the kernel's time with its launch cost spread thin
    large_ms = None
    if n_blocks < LARGE_BLOCKS:
        reps = LARGE_BLOCKS // n_blocks
        big = src.repeat(reps, 1)
        big_param = param.repeat(reps, 1) if getattr(param, "ndim", 0) == 2 else param
        large_ms = time_cuda(lambda: call_kernel(name, big, big_param, width, dtype), 10,
                             inner=10)
        del big, big_param
    moved = rec["src_bytes"] + got.numel() * got.element_size()
    if rec["base"] is not None:
        moved += rec["base"].numel() * rec["base"].element_size()
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
                  "base": None if rec["base"] is None else list(rec["base"].shape)},
        "bytes_moved": moved, "operations_bound_ms": ops_ms,
        "achieved_GBps": moved / (ms * 1e-3) / 1e9,
        "copy_ms": copy_ms, "copy_GBps": copy_rate / 1e9,
        "bound_at_copy_rate_ms": moved / copy_rate * 1e3,
        "ms_at_%d_blocks" % LARGE_BLOCKS: large_ms, "card": smi,
    }


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


def phase_timing(paths: dict, read_launches: dict, encode_state: dict, worst: dict,
                 smi: str) -> list:
    timed_columns = ["headline_u32_w3", "ffor_u32", "delta_u32", "zdelta_u32"]
    with largest_launches() as seen:
        for column in timed_columns:
            fio_device.read_file_device(paths[column])
    torch.cuda.synchronize()
    rows = [kernel_row(name, seen[name], read_launches, worst, smi)
            for name in DECODE_KERNELS]
    seen.clear()
    rows += [kernel_row(name, encode_state["seen"][name], encode_state["launches"],
                        worst, smi) for name in ENCODE_KERNELS]
    encode_state["seen"].clear()

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
          "host_round_trips": host_encode_costs(dev)})
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
        missing = [k for k in DECODE_KERNELS if read_state["launches"][k] == 0]
        if missing:
            raise AssertionError(f"the reads launched no {missing} kernel")
        encode_state = phase_encode(columns)
        missing = [k for k in ENCODE_KERNELS if encode_state["launches"][k] == 0]
        if missing:
            raise AssertionError(f"the encodes launched no {missing} kernel")
        del columns
        rows = phase_timing(read_state["paths"], read_state["launches"], encode_state,
                            worst, info["nvidia_smi"])
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu", "kind": info["kind"],
                                 "count": info["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
