#!/usr/bin/env python
"""Analytics-style scan over a FastLanes-compressed column on the
PyTorch/CUDA port — the counterpart of examples/compressed_scan.py.

Builds a compressed u32 column (W=7), then computes sum / max /
predicate-count over it and reports the scan throughput in (logical,
decompressed) ints/s. The JAX script lets XLA fuse the decode into the
reductions, so decompressed values never reach device memory. Here the
`unpack` kernel materializes them first (512 MiB at the card's default of
131 072 blocks) and the three reductions read them back; a fused
decode-into-reduce kernel is not part of the port.

Run: python examples/torch_compressed_scan.py [--on {cuda,cpu}] [n_blocks]

`--on cuda` (the default) needs a CUDA device and raises RuntimeError without
one; `--on cpu` runs the plain PyTorch version of `unpack` on the host.
Default size: 131 072 blocks on the card, 2048 on the host.
"""

import argparse
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import fastlanes_tpu_torch as fl  # noqa: E402
from fastlanes_tpu_torch.core import layout  # noqa: E402
from fastlanes_tpu_torch.ref import numpy_ref as ref  # noqa: E402

W, DT, THRESHOLD = 7, "u32", 100


def device_of(on: str) -> torch.device:
    """The device `--on` names; the card only if there is one."""
    if on == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("this example runs on a CUDA device by default and "
                           "torch.cuda.is_available() is false; pass --on cpu")
    return torch.device(on)


def card_name() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--on", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("n_blocks", nargs="?", type=int)
    args = p.parse_args(argv)
    dev = device_of(args.on)
    on_card = dev.type == "cuda"
    n_blocks = args.n_blocks or (131072 if on_card else 2048)

    rng = np.random.default_rng(0)
    values = rng.integers(0, 1 << W, (n_blocks, layout.BLOCK),
                          np.int64).astype(np.uint32)
    packed_np = ref.pack(values, W, DT)
    packed = torch.from_numpy(packed_np).to(dev)
    n_ints = n_blocks * layout.BLOCK
    ratio = values.nbytes / packed_np.nbytes

    def scan(p):
        v = fl.unpack(p, W, DT).view(torch.int32)  # W < 32: the int32 view is the value
        return (torch.sum(v, dtype=torch.int64) & 0xFFFFFFFF,  # mod 2^32
                torch.max(v),
                torch.sum(v > THRESHOLD, dtype=torch.int64))

    s, m, c = (int(x) for x in scan(packed))
    assert s == int(values.sum(dtype=np.uint64)) % (1 << 32)
    assert m == int(values.max())
    assert c == int((values > THRESHOLD).sum())
    print(f"sum(mod 2^32)={s} max={m} count(>100)={c} — match numpy")

    K = 64 if on_card else 4
    scan(packed)  # warm
    if on_card:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(K):
            scan(packed)
        end.record()
        torch.cuda.synchronize()
        t = start.elapsed_time(end) / 1e3 / K
        where = f"CUDA events, {card_name()}"
    else:
        t0 = time.perf_counter()
        for _ in range(K):
            scan(packed)
        t = (time.perf_counter() - t0) / K
        where = "host clock, cpu"
    print(f"scanned {n_ints/1e6:.0f}M ints ({ratio:.1f}x compressed) in "
          f"{t*1e3:.2f} ms/pass = {n_ints/t/1e9:.1f}e9 ints/s "
          f"({n_ints*4/t/1e9:.0f} GB/s logical) [{where}]")
    return {"n_blocks": n_blocks, "sum_mod_2_32": s, "max": m, "count_gt_100": c,
            "timing": {"passes": K, "ms_per_pass": t * 1e3, "ints_per_s": n_ints / t,
                       "logical_gb_per_s": n_ints * 4 / t / 1e9, "clock": where}}


if __name__ == "__main__":
    main()
