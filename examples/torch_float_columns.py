#!/usr/bin/env python
"""ALP float compression tour on the PyTorch/CUDA port: price-like decimal
data through the full stack — models driver, FLT file, table container,
device decode. The counterpart of examples/float_columns.py.

Run: python examples/torch_float_columns.py [--on {cuda,cpu}]

`--on cuda` (the default) needs a CUDA device and raises RuntimeError without
one; `--on cpu` runs the plain PyTorch versions of the kernels on the host.
"""

import argparse
import os
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from fastlanes_tpu_torch import fio, fio_device, fio_table  # noqa: E402
from fastlanes_tpu_torch.models import ALPCodec  # noqa: E402


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

    rng = np.random.default_rng(7)

    # 1. A float64 "price" column: 2 decimal places, ~$10-$5000
    prices = (rng.integers(1000, 500_000, 100_000) / 100.0)

    # 2. models driver: encode blocks on the device, decode them back
    blocks = prices[: 96 * 1024].reshape(96, 1024)
    codec = ALPCodec("f64")
    enc = codec.encode(blocks, device=dev)
    back = codec.decode(enc)
    assert back.dtype == torch.float64
    assert np.array_equal(back.cpu().numpy().view(np.uint64), blocks.view(np.uint64))
    ratio = blocks.nbytes / enc.packed_bytes
    alp = {"e": enc.params["e"], "f": enc.params["f"], "width": enc.width,
           "exceptions": len(enc.params["exc_pos"]), "ratio": ratio}
    print(f"1. ALPCodec: e={alp['e']} f={alp['f']} "
          f"width={alp['width']} bits, {alp['exceptions']} exceptions, "
          f"{ratio:.1f}x smaller")

    # 3. FLT file round trip (arbitrary length; bit-exact)
    with tempfile.NamedTemporaryFile(suffix=".flt", delete=False) as f:
        path = f.name
    try:
        fio.write_file(path, prices)
        out = fio.read_file(path)
        assert out.dtype == np.float64
        assert np.array_equal(out, prices)
        file_bytes = os.path.getsize(path)
        print(f"2. FLT file: {prices.nbytes} raw -> {file_bytes} "
              f"bytes on disk, bit-exact read")

        # 4. random access without decoding the file
        one = fio.read_single(path, 5, 123)
        assert one == prices[5 * 1024 + 123]
        print("3. read_single ok")

        # 5. device decode: a float32 tensor with the host reader's bits
        temps = (rng.integers(-400, 400, 50_000) / 10.0).astype(np.float32)
        fio.write_file(path, temps)
        got = fio_device.read_file_device(path, device=dev)
        assert got.dtype == torch.float32 and got.device.type == dev.type
        assert np.array_equal(got.cpu().numpy().view(np.uint32), temps.view(np.uint32))
        print(f"4. device decode on {dev.type}: bit-exact")

        # 6. mixed table: float + integer columns side by side
        fio_table.write_table(path, {
            "price": prices[:30_000],
            "qty": rng.integers(0, 500, 30_000).astype(np.uint32),
            "temp": temps[:30_000],
        })
        table = fio_table.read_table(path)
        assert np.array_equal(table["price"], prices[:30_000])
        assert table["temp"].dtype == np.float32
        print(f"5. mixed table: {sorted(table)} ok")
    finally:
        os.unlink(path)
    print("float_columns example OK")
    return {"alp": alp, "raw_bytes": prices.nbytes, "file_bytes": file_bytes,
            "read_single": float(one), "device_decode": {
                "dtype": str(got.dtype), "values": got.numel(),
                "bits_sum": int(got.view(torch.int32).sum(dtype=torch.int64))},
            "table_columns": sorted(table)}


if __name__ == "__main__":
    main()
