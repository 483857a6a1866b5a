"""Two builds of csrc/codecs.cu, side by side on one card: all eleven kernels.

    python -m fastlanes_tpu_torch.kernels.ab_codecs BASELINE.cu [--bound-ms 0.1]
        [--dtypes u64] [--widths 35,51] [--kernels unpack_orig,undelta_pack_orig]

BASELINE.cu is another revision of csrc/codecs.cu with the same C interface
(`fl_decode`, `fl_encode`). Both files are built with the same nvcc flags;
what ptxas reports for every kernel instantiation of each is printed. Then
for every dtype, at a size whose bytes bound is at least `--bound-ms` and
W = T/4 + 2 or each of `--widths` up to T (per-block base and reference),
each of the seven decode kernels and the four encode kernels
(`delta_pack_orig` plain and zigzag; `--kernels` for a cut) runs through
both libraries on the same inputs: the two outputs (the packed words
and, for `delta_pack_orig`, the base it writes) must be equal byte for
byte, and each is timed with CUDA events (10 launches back to back, median
of 10) in turns baseline, checkout, checkout, baseline. Prints one JSON
line; exits 1 without a CUDA device or when the outputs differ.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

import numpy as np
import torch

from ..core import layout
from . import build
from .cuda_codecs import _KERNELS, _ZIGZAG_ENCODE_OP

HBM_BYTES_PER_S = 3.35e12  # published device-memory rate of one H100 SXM
DECODE = ("unpack", "unfor_pack", "undelta_pack", "unzdelta_pack",
          "unpack_orig", "undelta_pack_orig", "unzdelta_pack_orig")
ENCODE = ("pack", "delta_pack", "for_pack", "delta_pack_orig", "delta_pack_orig_zigzag")


def time_ms(fn, reps=10, inner=10):
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def launcher(lib, row, dtype, inputs, width):
    """(a callable that launches kernel `row` of `lib` into fresh outputs and
    returns them, the bytes the launch moves). `inputs` holds the packed
    words, the values, the per-block base and the per-block references."""
    name = row.removesuffix("_zigzag")
    entry, op, order = _KERNELS[name]
    if row != name:
        op = _ZIGZAG_ENCODE_OP
    t, nl = layout.bit_width(dtype), layout.lanes(dtype)
    encode = entry == "fl_encode"
    src = inputs["values" if encode else "packed"]
    n_blocks = src.shape[0]
    out_cols = layout.packed_len(dtype, width) if encode else layout.BLOCK
    base_ptr, base_stride = None, 0
    if "delta" in name and name != "delta_pack_orig":  # delta_pack_orig writes its base
        base_ptr, base_stride = inputs["base"].data_ptr(), nl
    ref_ptr, ref_stride = None, 0
    if name in ("unfor_pack", "for_pack"):
        ref_ptr, ref_stride = inputs["refs"].data_ptr(), 1
    stream = torch.cuda.current_stream().cuda_stream or None

    def run():
        outs = (torch.empty((n_blocks, out_cols), dtype=src.dtype, device=src.device),)
        made = base_ptr
        if name == "delta_pack_orig":
            outs += (torch.empty((n_blocks, nl), dtype=src.dtype, device=src.device),)
            made = outs[1].data_ptr()
        err = getattr(lib, entry)(op, order, t, src.data_ptr(), outs[0].data_ptr(), made,
                                  base_stride, ref_ptr, ref_stride, 0, n_blocks, width, stream)
        if err:
            raise RuntimeError(f"{row} {dtype}: {lib.fl_error_string(err).decode()}")
        return outs

    moved = src.numel() + n_blocks * out_cols
    if "delta" in name:
        moved += n_blocks * nl
    elif ref_ptr is not None:
        moved += n_blocks
    return run, moved * t // 8


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("baseline", help="another revision of csrc/codecs.cu")
    parser.add_argument("--bound-ms", type=float, default=0.1)
    parser.add_argument("--dtypes", default=",".join(layout.DTYPES))
    parser.add_argument("--widths", default=None,
                        help="comma-separated widths (default: T/4 + 2 of each dtype)")
    parser.add_argument("--kernels", default=",".join(DECODE + ENCODE))
    args = parser.parse_args(argv)
    kernels = args.kernels.split(",")
    unknown = [k for k in kernels if k not in DECODE + ENCODE]
    if unknown:
        parser.error(f"unknown kernel {unknown[0]!r}; have {DECODE + ENCODE}")
    if not torch.cuda.is_available():
        print("ab_codecs needs a CUDA device", file=sys.stderr)
        return 1
    libs, ptxas = {}, {}
    for label, source in (("baseline", os.path.abspath(args.baseline)),
                          ("checkout", build.SOURCES[0])):
        path = os.path.join(build.BUILD_DIR, "ab", f"lib_{label}.so")
        _, log = build.compile_library([source], path)
        libs[label], ptxas[label] = build.bind(path), build.ptxas_usage(log)
    rng = np.random.default_rng(20240607)
    rows, same = [], True
    cases = []
    for dtype in args.dtypes.split(","):
        t = layout.bit_width(dtype)
        widths = [t // 4 + 2] if args.widths is None else \
            [w for w in map(int, args.widths.split(",")) if w <= t]
        cases += [(dtype, w) for w in widths]
    for dtype, width in cases:
        t, nl, np_dt = layout.bit_width(dtype), layout.lanes(dtype), layout.np_dtype(dtype)
        plen = layout.packed_len(dtype, width)
        block_bytes = (layout.BLOCK + plen + nl) * t // 8
        blocks = -(-int(args.bound_ms * 1e-3 * HBM_BYTES_PER_S / block_bytes) // 1024) * 1024
        reps = blocks // 1024

        def draw(*shape):
            return torch.from_numpy(rng.integers(0, 1 << min(t, 63), size=shape,
                                                 dtype=np.uint64).astype(np_dt)).cuda()
        inputs = {"packed": draw(1024, plen).repeat(reps, 1),
                  "values": draw(1024, layout.BLOCK).repeat(reps, 1),
                  "base": draw(1024, nl).repeat(reps, 1), "refs": draw(1024).repeat(reps)}
        for name in kernels:
            if width == 0 and name in ("pack", "delta_pack", "for_pack"):
                continue  # W = 0 has no packed words to write
            runs, moved = {}, 0
            for label, lib in libs.items():
                runs[label], moved = launcher(lib, name, dtype, inputs, width)
            a, b = runs["baseline"](), runs["checkout"]()
            torch.cuda.synchronize()
            equal = all(torch.equal(x.view(torch.uint8), y.view(torch.uint8))
                        for x, y in zip(a, b))
            same &= equal
            del a, b
            ms = {label: [] for label in runs}
            for label in ("baseline", "checkout", "checkout", "baseline"):
                ms[label].append(time_ms(runs[label]))
            bound = moved / HBM_BYTES_PER_S * 1e3
            row = {"kernel": name, "dtype": dtype, "width": width, "blocks": blocks,
                   "equal": equal, "bound_ms": bound}
            for label, times in ms.items():
                row[label + "_ms"] = times
                row[label + "_share_of_bound"] = bound / statistics.mean(times)
            rows.append(row)
        del inputs
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(json.dumps({"card": smi, "ptxas": ptxas, "rows": rows, "equal": same}), flush=True)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
