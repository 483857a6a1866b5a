"""Read each control of a cell: the reference put in the program's place, in
a lower precision or with a guarantee broken (reference/<entry>.CONTROLS),
held to the exact reference by the same comparison that decides `correct`.

    python3 -m flbench.control --workload <cell> --seeds 1,2,3 --calls 120

For each seed it draws the first `--calls` calls of the cell's traffic, the
sample of them that a run of that many calls compares, and prints one JSON
line: the mismatched values of each control over the sample. Needs no card:
the controls and the reference are NumPy, at the cell's own size.
"""

from __future__ import annotations

import argparse
import itertools
import json
import sys
import time

from . import dataset, traffic
from .run import _module, load_benchmark, sample_of


def readings(bench: dict, cell_name: str, seed: int, calls: int, overrides=None) -> dict:
    cell = next(w for w in bench["workloads"] if w["name"] == cell_name)
    ds = dataset.in_memory(cell["config"], seed, overrides)
    spec = traffic.load(cell["traffic"])
    rmod = _module("reference", spec["entry"].rsplit(".", 1)[1])
    sample = sample_of(spec, seed)
    for i, call in enumerate(itertools.islice(traffic.Traffic(spec, ds, seed).calls(), calls)):
        sample.offer(i, call, None)
    out = {kind: 0 for kind in rmod.CONTROLS}
    for _i, call, _a in sample.kept:
        want = rmod.expected(ds, call.kwargs)
        for kind in rmod.CONTROLS:
            out[kind] += rmod.mismatches(rmod.control(ds, call.kwargs, kind), want)
    return {"workload": cell_name, "seed": seed, "calls": calls,
            "answers": len(sample.kept), "control_mismatched_values": out}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\\n\\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--calls", type=int, required=True)
    args = ap.parse_args(argv)
    bench = load_benchmark()
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        r = readings(bench, args.workload, seed, args.calls)
        r["seconds"] = time.perf_counter() - t0
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
