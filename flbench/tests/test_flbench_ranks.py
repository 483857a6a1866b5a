"""Cells of more than one card, on the CPU: the ranks run on gloo with
`device="cpu"` at the SMALL size, two of them (the mesh cell's `chips` cut to
2). Rank 0 runs in a process of its own, as the command starts it, so that
its process groups and its watch over the children stay out of the test's
process. A whole run is correct as the program stands, with the same calls
on every rank, and not correct with each fault that the cell can have planted
in the timed path of every rank; a rank that dies ends the run without a
hang; a cell of one card starts no process and no group."""

import json
import subprocess
import sys
import time

import pytest
from conftest import ROOT, SMALL

from flbench import ranks, run, work

CELL = "lineitem-q6-mesh4"
BENCH = run.load_benchmark()
CONFIG = {w["name"]: w["config"] for w in BENCH["workloads"]}

#: rank 0: the cell on `ranks` ranks of the CPU; its result line on stdout
RANK0 = r"""
import json, sys
from flbench import run
bench = run.load_benchmark()
cell = next(w for w in bench["workloads"] if w["name"] == {cell!r})
cell["chips"] = {ranks}
r = run.run_cell(bench, {cell!r}, {seed}, {seconds}, {trace}, device="cpu",
                 overrides={overrides!r}, data_dir={data!r},
                 child_argv=[sys.executable, "-c", {plant!r} + {child!r}])
print(json.dumps(r))
"""
CHILD = "\nimport sys\nfrom flbench import ranks\nsys.exit(ranks.child_main())\n"

#: faults, planted in the program of every rank before it starts
NUDGE = r"""
import math
from fastlanes_tpu_torch import analytics
from fastlanes_tpu_torch.parallel import shard
def _nudge(a):
    s = a["sum"]
    return dict(a, sum=math.nextafter(s, math.inf) if isinstance(s, float) else s + 1)
"""
PLANTS = {
    "none": "",
    # every call answers what the first one did
    "unchanged": NUDGE + r"""
_real, _first = analytics.scan_where_multi, []
def _stale(*a, **k):
    if not _first:
        _first.append(_real(*a, **k))
    return _first[0]
analytics.scan_where_multi = _stale
""",
    # half the windows of rows left out
    "half": NUDGE + r"""
_walk = analytics._lockstep_chunks
def _every_other(*a, **k):
    for i, rows in enumerate(_walk(*a, **k)):
        if i % 2 == 0:
            yield rows
analytics._lockstep_chunks = _every_other
""",
    # the exchange between the ranks left out: each rank answers its own chunks
    "exchange": NUDGE + r"""
shard._combine = lambda part, local: [local()]
""",
    # an answer altered where it is produced
    "altered": NUDGE + r"""
_real = analytics.scan_where_multi
analytics.scan_where_multi = lambda *a, **k: _nudge(_real(*a, **k))
""",
}
#: rank 1 dies on its fourth call of the window
DIES = r"""
import os
from fastlanes_tpu_torch import analytics
_real, _n = analytics.scan_where_multi, []
def _dies(*a, **k):
    _n.append(1)
    if len(_n) > 4:
        os._exit(9)
    return _real(*a, **k)
analytics.scan_where_multi = _dies
"""


def _rank0(tmp_path, plant="", child_plant=None, seed=2**31 + 5, seconds=1.5, trace=False,
           n=2, timeout=240):
    code = PLANTS["none"] + plant + RANK0.format(
        cell=CELL, ranks=n, seed=seed, seconds=seconds, trace=trace,
        overrides=SMALL[CONFIG[CELL]], data=str(tmp_path),
        plant=plant if child_plant is None else child_plant, child=CHILD)
    t0 = time.monotonic()
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=timeout)
    return out, time.monotonic() - t0


def _result(out) -> dict:
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.splitlines()[-1])


def test_two_ranks_are_correct_with_the_same_calls(tmp_path):
    r = _result(_rank0(tmp_path, trace=True)[0])
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 2
    assert r["device"]["count"] == 2 and len(r["device"]["memory_peak_bytes_by_rank"]) == 2
    assert r["checks"]["ranks_differing"] == {"value": 0, "max": 0}
    assert [s["calls"] for s in r["ranks"]] == [r["attempted"]] * 2
    # every per-layer metric of the cell but those of the device's trace
    want = {m["name"] for m in BENCH["per_layer"]
            if CELL in m["workloads"] and m["source"] != "device_trace"}
    assert set(r["metrics"]) == want
    assert r["metrics"]["combine_ms_per_call"]["value"] > 0
    assert r["metrics"]["rank_skew"]["value"] >= 1
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("fault", ["unchanged", "half", "exchange", "altered"])
def test_a_fault_on_every_rank_makes_it_incorrect(fault, tmp_path):
    r = _result(_rank0(tmp_path, PLANTS[fault])[0])
    assert not r["correct"]
    assert r["checks"]["mismatched_values"]["value"] > 0


def test_a_rank_that_dies_ends_the_run_without_a_hang(tmp_path):
    out, seconds = _rank0(tmp_path, child_plant=DIES, seconds=60, timeout=200)
    assert out.returncode == ranks.CHILD_FAILED and seconds < 120
    assert not out.stdout.strip()  # no result line
    assert "rank 1 exited with code 9" in out.stderr


@pytest.mark.parametrize("n_chunks,n", [(23, 4), (3, 4), (12, 2)])
def test_the_rank_share_is_the_programs_chunk_span(n_chunks, n):
    from fastlanes_tpu_torch.parallel import shard
    spans = [work.rank_chunks(n_chunks, (r, n)) for r in range(n)]
    assert spans == [shard._chunk_span(shard._Part(None, n, r), n_chunks) for r in range(n)]
    sizes = [hi - lo for lo, hi in spans]
    assert sum(sizes) == n_chunks
    if (n_chunks, n) == (23, 4):
        assert sizes == [6, 6, 6, 5]
    if (n_chunks, n) == (3, 4):
        assert sizes == [1, 1, 1, 0]


def test_the_payload_of_rank_0_is_its_chunks_bytes(tmp_path):
    import numpy as np

    from fastlanes_tpu_torch import fio_table
    from fastlanes_tpu_torch.parallel import shard
    from flbench import dataset

    rows = 23 * 1024 - 100  # 23 chunks of one block, the last one short
    v = np.random.default_rng(3).integers(0, 1 << 20, rows).astype(np.uint32)
    path = str(tmp_path / "t.flt")
    fio_table.write_table(path, {"a": v, "b": v[::-1].copy()}, codec="auto", chunk_blocks=1)
    ds = dataset.Dataset({}, 0, None, str(tmp_path), {"t": {"path": "t.flt", "rows": rows}},
                         {"t": {"a": v, "b": v[::-1].copy()}})
    chunks = ds.chunks(path, "a") + ds.chunks(path, "b")
    assert len(ds.chunks(path, "a")) == 23
    whole = work.table_payload_bytes(ds, path, ["a", "b"], [])
    assert whole == sum(m["nbytes"] for m in chunks)
    shares = []
    for r in range(4):
        lo, hi = shard._chunk_span(shard._Part(None, 4, r), 23)
        want = sum(m["nbytes"] for col in ("a", "b") for m in ds.chunks(path, col)[lo:hi])
        got = work.table_payload_bytes(ds, path, ["a", "b"], [], part=(r, 4))
        assert got == want
        shares.append(got)
    assert sum(shares) == whole


def test_a_cell_of_one_card_starts_no_process_and_no_group(tmp_path, monkeypatch):
    import multiprocessing

    import torch.distributed as dist

    def refused(*a, **k):
        raise AssertionError("a process was started")
    monkeypatch.setattr(subprocess, "Popen", refused)
    monkeypatch.setattr(multiprocessing.Process, "start", refused)
    r = run.run_cell(BENCH, "lineitem-q6", 2**31 + 5, 0.5, False, device="cpu",
                     overrides=SMALL[CONFIG["lineitem-q6"]], data_dir=str(tmp_path))
    assert r["correct"] and "ranks" not in r and r["device"]["count"] == 1
    assert not dist.is_initialized()
