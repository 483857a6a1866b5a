#!/usr/bin/env python
"""End-to-end tour of fastlanes_tpu_torch, the PyTorch/CUDA port — the
counterpart of examples/end_to_end.py, all ten steps.

Covers the README example of the reference crate (u16 W=3 pack/unpack/
unpack_single, reference README.md:14-47) through the kernel wrappers, the
composed codec drivers, the FLT file format with device-side decode, the
sharded codecs over a process group (one rank: NCCL on the card, gloo on the
host), the original-order fused decode and a native uint64 column read.

Run: python examples/torch_end_to_end.py [--on {cuda,cpu}]

`--on cuda` (the default) needs a CUDA device and raises RuntimeError without
one; `--on cpu` runs the plain PyTorch versions of the kernels on the host.
"""

import argparse
import os
import sys
import tempfile

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import fastlanes_tpu_torch as fl  # noqa: E402
from fastlanes_tpu_torch import (  # noqa: E402
    analytics, fio, fio_device, fio_table, kernels, parallel)
from fastlanes_tpu_torch.models.codecs import DeltaCodec, auto_encode, get_codec  # noqa: E402
from fastlanes_tpu_torch.ops import dispatch, single  # noqa: E402
from fastlanes_tpu_torch.ref import numpy_ref as npref  # noqa: E402


def device_of(on: str) -> torch.device:
    """The device `--on` names; the card only if there is one."""
    if on == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("this example runs on a CUDA device by default and "
                           "torch.cuda.is_available() is false; pass --on cpu")
    return torch.device(on)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--on", choices=["cuda", "cpu"], default="cuda")
    dev = device_of(p.parse_args(argv).on)

    def on_dev(arr):
        return torch.from_numpy(np.ascontiguousarray(arr)).to(dev)

    def host(t):
        return t.cpu().numpy()

    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "host"
    print(f"devices: [{dev.type}: {name}]")

    # 1. The reference README example: u16, W=3, values 0..7 repeating.
    values = (np.arange(1024, dtype=np.uint16) % 8).reshape(1, 1024)
    packed = fl.pack(on_dev(values), 3, "u16")
    assert packed.shape == (1, 192)  # 1024*3/16 words
    out = fl.unpack(packed, 3, "u16")
    assert np.array_equal(host(out), values)
    one = int(host(single.unpack_single(packed, 3, 14, "u16")).reshape(-1)[0])
    assert one == values[0, 14]
    print("1. u16 W=3 pack/unpack/unpack_single round-trip ok")

    # 2. Runtime-width dispatch (the unchecked_* API of the reference).
    w = 11
    vals = np.random.default_rng(0).integers(0, 1 << w, (128, 1024),
                                             np.int64).astype(np.uint32)
    vals_dev = on_dev(vals)
    p = dispatch.unchecked_pack(w, vals_dev, "u32")
    assert np.array_equal(host(dispatch.unchecked_unpack(w, p, "u32")), vals)
    print("2. runtime-width dispatch ok")

    # 3. Codec drivers with automatic selection, encoded on the device.
    sorted_vals = np.sort(vals, axis=1)
    enc = auto_encode(sorted_vals, "u32", device=dev)
    dec = get_codec(enc.codec, "u32").decode(enc)
    assert np.array_equal(host(dec), sorted_vals)
    print(f"3. auto_encode picked {enc.codec} W={enc.width} "
          f"(ratio {enc.compression_ratio:.2f}x) ok")

    # 4. FLT file: compress on host, decode on the device.
    with tempfile.NamedTemporaryFile(suffix=".flt") as f:
        fio.write_file(f.name, sorted_vals, dtype="u32", chunk_blocks=32)
        col = fio_device.read_file_device(f.name, device=dev)
        assert np.array_equal(host(col), sorted_vals)
        element = fio.read_single(f.name, block=3, index=777)
        assert element == sorted_vals[3, 777]
    print("4. FLT write -> device decode -> random access ok")

    # 5. Sharded execution over the ranks of a process group (this process
    #    alone, unless the caller started a group).
    started = not dist.is_initialized()
    mesh = parallel.make_mesh(device=dev)
    try:
        gw = int(parallel.global_max_bits(mesh, vals_dev, "u32"))
        local = parallel.sharded_pack(mesh, vals_dev, gw, "u32")
        sp = parallel.all_gather_packed(mesh, local, "u32")
        assert np.array_equal(host(dispatch.unchecked_unpack(gw, sp, "u32")), vals)
        mesh_size = mesh.size()
    finally:
        if started:
            dist.destroy_process_group()
    print(f"5. sharded pack over {mesh_size} device(s), "
          f"agreed width {gw} ok")

    # 6. Fused delta pipeline (the delta.rs:80-96 composition).
    codec = DeltaCodec("u32")
    denc = codec.encode(sorted_vals, device=dev)
    assert np.array_equal(host(codec.decode(denc)), sorted_vals)
    print(f"6. fused delta codec W={denc.width} ok")

    # 7. Multi-column table with a signed (zigzag) column, any lengths.
    rng = np.random.default_rng(7)
    table = {"id": np.arange(3000, dtype=np.uint32),
             "delta_t": rng.integers(-50, 50, 3000, np.int64).astype(np.int16)}
    with tempfile.NamedTemporaryFile(suffix=".flt") as f:
        fio_table.write_table(f.name, table)
        got = fio_table.read_table(f.name)
    assert got["delta_t"].dtype == np.int16
    for k in table:
        assert np.array_equal(got[k], table[k])
    print("7. table file (unsigned + signed zigzag columns) ok")

    # 8. Fused analytics: query a compressed file without materializing it.
    col = np.sort(rng.integers(0, 1 << 20, 4000, np.int64).astype(np.uint32))
    with tempfile.NamedTemporaryFile(suffix=".flt") as f:
        fio.write_file(f.name, col)
        stats = analytics.scan_column(f.name, device=dev)
        n_hi = analytics.count_where(f.name, "gt", 1 << 19, device=dev)
    assert stats["sum"] == int(col.sum()) and stats["count"] == 4000
    assert n_hi == int((col > (1 << 19)).sum())
    print("8. fused analytics (sum/min/max/count_where) over compressed ok")

    # 9. Original-order fused decode (one kernel: decode and untranspose)
    #    + fused-producer encode.
    tr = npref.transpose(sorted_vals, "u32")
    base = np.ascontiguousarray(tr[:, :32])
    deltas = npref.delta(tr, base, "u32")
    wd = int(deltas.max()).bit_length()
    pd = npref.pack(deltas, wd, "u32")
    orig = kernels.undelta_pack_orig(on_dev(pd), on_dev(base), wd, "u32")
    assert np.array_equal(host(orig), sorted_vals)
    # pack_map's producer gets each row slice as signed 32-bit patterns
    pm = kernels.pack_map(lambda v: v - 1, on_dev(sorted_vals + np.uint32(1)), gw, "u32")
    assert np.array_equal(host(pm), host(fl.pack(on_dev(sorted_vals), gw, "u32")))
    print(f"9. orig-order fused decode (W={wd}) + pack_map fused encode ok")

    # 10. u64 columns come back as native uint64 tensors.
    col64 = np.sort(rng.integers(0, 1 << 44, 3000, np.int64).astype(np.uint64))
    with tempfile.NamedTemporaryFile(suffix=".flt") as f:
        fio.write_file(f.name, col64)
        t64 = fio_device.read_file_device(f.name, device=dev)
    assert t64.dtype == torch.uint64
    assert np.array_equal(host(t64).reshape(-1), col64)
    print(f"10. u64 file -> {t64.dtype} tensor(shape={tuple(t64.shape)}) bit-exact ok")
    return {"device": name, "unpack_single": one,
            "auto_encode": {"codec": enc.codec, "width": enc.width,
                            "ratio": enc.compression_ratio},
            "read_single": int(element), "mesh_size": mesh_size, "global_width": gw,
            "delta_width": denc.width,
            "table_dtypes": {k: str(v.dtype) for k, v in got.items()},
            "scan_column": stats, "count_gt": n_hi, "orig_width": wd,
            "u64": {"dtype": str(t64.dtype), "shape": list(t64.shape)}}


if __name__ == "__main__":
    main()
