"""Generated columns in the domain their predicates compare in: numbers as
they are, dates as int64 days, strings as codes into their sorted labels.
Shared by the reference's masks and by the benchmark's zone-map rule."""

from __future__ import annotations

import numpy as np

from .dataset import Categorical


def ordered(column) -> np.ndarray:
    """The values of a generated column in their order domain."""
    if isinstance(column, Categorical):
        return column.codes
    arr = np.asarray(column)
    return arr.view(np.int64) if arr.dtype.kind in "mM" else arr


def probe(column, op: str, value):
    """(op, value) of a predicate on `column` in its order domain. A string
    probe becomes a code bound of the sorted labels; a set a code list."""
    if isinstance(column, Categorical):
        labels = column.labels
        if op in ("in", "notin"):
            return op, [int(np.searchsorted(labels, v)) for v in value if v in labels]
        if op in ("eq", "ne"):
            hit = np.flatnonzero(labels == value)
            if hit.size:
                return op, int(hit[0])
            return ("in", []) if op == "eq" else ("notin", [])
        left = int(np.searchsorted(labels, value, "left"))
        right = int(np.searchsorted(labels, value, "right"))
        return {"lt": ("lt", left), "le": ("lt", right),
                "gt": ("ge", right), "ge": ("ge", left)}[op]
    arr = np.asarray(column)
    if arr.dtype.kind in "mM":
        cast = lambda v: int(np.array(v, dtype=arr.dtype).view(np.int64))  # noqa: E731
        return op, ([cast(v) for v in value] if op in ("in", "notin") else cast(value))
    return op, value
