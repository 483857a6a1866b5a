"""Reference of `group_stats(path, key, value, preds)`: the WHERE mask of
the generated columns, then exact per-group statistics of the non-empty
groups. The controls: the same in float32, and with float64 sums that are
not exactly rounded."""

from . import common

CONTROLS = ("float32", "float64_plain")
mismatches = common.mismatches


def _answer(dataset, kwargs, precision):
    return common.group_stats(dataset, kwargs["path"], kwargs["key"], kwargs["value"],
                              kwargs.get("preds", ()), precision)


def expected(dataset, kwargs) -> dict:
    return _answer(dataset, kwargs, "exact")


def control(dataset, kwargs, kind: str) -> dict:
    return _answer(dataset, kwargs, kind)
