"""Reference of `scan_where_multi(path, preds, column)`: the ANDed mask of
the generated columns, then exact sum / min / max / count of the column.
The controls: the same in float32, and with a float64 sum that is not
exactly rounded."""

from . import common

CONTROLS = ("float32", "float64_plain")
mismatches = common.mismatches


def _answer(dataset, kwargs, precision):
    return common.column_stats(dataset, kwargs["path"], kwargs["column"], kwargs["preds"],
                               precision)


def expected(dataset, kwargs) -> dict:
    return _answer(dataset, kwargs, "exact")


def control(dataset, kwargs, kind: str) -> dict:
    return _answer(dataset, kwargs, kind)
