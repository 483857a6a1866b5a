"""On the card: one short run of every cell of BENCHMARK.json through the
benchmark's command, untraced and traced, correct and with every metric the
cell reports. Skips without a CUDA device. Each run writes its table first
(~35 s)."""

import json
import os
import subprocess
import sys

import pytest
from conftest import ROOT

from flbench.run import load_benchmark


def _run(cell: str, trace: int) -> dict:
    out = subprocess.run([sys.executable, "-m", "flbench.run", "--workload", cell,
                          "--seed", str(2**31 + 77), "--seconds", "3", "--trace", str(trace)],
                         cwd=ROOT, capture_output=True, text=True, timeout=900,
                         env={**os.environ, "PYTHONPATH": ROOT})
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.splitlines()[-1])


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in load_benchmark()["workloads"]])
def test_every_cell_runs_correct_on_the_card(cell, needs_cuda):
    import torch

    bench = load_benchmark()
    chips = next(w["chips"] for w in bench["workloads"] if w["name"] == cell)
    if torch.cuda.device_count() < chips:
        pytest.skip(f"{cell} needs {chips} CUDA devices")
    for trace, kind in ((0, "end_to_end"), (1, "per_layer")):
        r = _run(cell, trace)
        assert r["correct"] and r["failed"] == 0 and r["device"]["platform"] == "gpu"
        assert r["device"]["count"] == chips
        want = {m["name"] for m in bench[kind] if cell in m.get("workloads", [cell])}
        assert set(r["metrics"]) == want
        if trace:
            assert 0 < r["device"]["busy_s"] <= r["device"]["window_s"]
            for m, v in r["metrics"].items():
                if m.endswith("_roofline"):
                    assert 0 < v["value"] <= 100
