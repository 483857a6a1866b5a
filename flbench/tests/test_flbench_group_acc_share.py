"""group_acc_shared_share on recorded counter pairs of the group
accumulator's kernel."""

import pytest

from flbench.run import Record, _module, load_benchmark


def record(counters) -> Record:
    return Record(setup_s=1.0, window_s=1.0, latencies_s=[0.1], values=1, calls=8,
                  counters=counters)


@pytest.mark.parametrize("counters,want", [
    ({"kernels.cuda_group.LAUNCHES": 8, "kernels.cuda_group.SHARED_LAUNCHES": 8}, 100.0),
    ({"kernels.cuda_group.LAUNCHES": 8, "kernels.cuda_group.SHARED_LAUNCHES": 2}, 25.0),
    ({"kernels.cuda_group.LAUNCHES": 8, "kernels.cuda_group.SHARED_LAUNCHES": 0}, 0.0),
    ({"kernels.cuda_group.LAUNCHES": 0, "kernels.cuda_group.SHARED_LAUNCHES": 0}, 0.0),
    ({}, None),  # a program without the kernel: nothing to read
    ({"kernels.cuda_group.LAUNCHES": 8}, None),
])
def test_the_shared_share_of_the_group_kernel(counters, want):
    got = _module("metrics", "group_acc_shared_share").read(record(counters))
    assert got == want


def test_the_metric_reads_the_q1_cell_only():
    (metric,) = [m for m in load_benchmark()["per_layer"] if m["name"] == "group_acc_shared_share"]
    assert metric["workloads"] == ["lineitem-q1"] and metric["moves"] == "values_per_s"
    assert _module("metrics", "group_acc_shared_share").COUNTERS == (
        "kernels.cuda_group.LAUNCHES", "kernels.cuda_group.SHARED_LAUNCHES")
