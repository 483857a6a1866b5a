"""The plain NumPy core of the reference: predicate masks, exact per-group
statistics, and the comparison that counts where an answer differs.

Exact means what the configurations state: integer sums exact, float sums
exactly rounded (the exact sum of the doubles, rounded once), min / max /
count exact. A sum is built from integer pieces that float64 `bincount`
adds without rounding (every partial sum stays under 2^53) and finished
in Python integers; a float is split into its 53-bit integer significand
and its exponent first. Python's int / int division rounds correctly.

`precision` names a control: the same answers computed in float32
("float32"), or with float64 sums in NumPy's own summation order
("float64_plain"), which is not exactly rounded.
"""

from __future__ import annotations

import math
import threading
from fractions import Fraction

import numpy as np

from flbench import domain
from flbench.dataset import Categorical

from . import oracles

#: rows a bincount adds at once, and the bits of an integer piece: a sum of
#: 2^25 pieces under 2^27 stays under 2^52, exact in float64
ROWS_AT_ONCE = 1 << 25
PIECE = 27
_MPIECE = (1 << PIECE) - 1


def mask(dataset, path: str, preds):
    """AND of the predicates over the whole table (None: no predicate)."""
    out = None
    for col, op, value in preds:
        column = dataset.column(path, col)
        pop, pv = domain.probe(column, op, value)
        hit = oracles.oracle_mask(domain.ordered(column), pop, pv)
        out = hit if out is None else out & hit
    return out


def _pieces(ints: np.ndarray) -> list:
    """(shift, float64 array) pieces of int64 values, each under 2^27 in
    magnitude, whose shifted sum is the value: the last piece keeps the sign."""
    top = max(int(ints.max()), -int(ints.min()) - 1, 0).bit_length() if ints.size else 0
    out, shift = [], 0
    while top - shift > PIECE - 1:
        out.append((shift, ((ints >> shift) & _MPIECE).astype(np.float64)))
        shift += PIECE
    out.append((shift, (ints >> shift).astype(np.float64)))
    return out


def _sums(pieces, idx: np.ndarray, n: int) -> list:
    """Exact sums of the pieced values by index in [0, n), as Python ints."""
    total = [0] * n
    for shift, piece in pieces:
        for a in range(0, idx.size, ROWS_AT_ONCE):
            s = np.bincount(idx[a:a + ROWS_AT_ONCE], weights=piece[a:a + ROWS_AT_ONCE],
                            minlength=n)
            for i in np.flatnonzero(s).tolist():
                total[i] += int(s[i]) << shift
    return total


def _flip(bits: np.ndarray) -> np.ndarray:
    """Float bits <-> IEEE total-order keys (an involution)."""
    return bits ^ ((bits >> (bits.dtype.itemsize * 8 - 1)) & np.iinfo(bits.dtype).max)


def _order_key(vals: np.ndarray) -> np.ndarray:
    return _flip(vals.view(np.int64 if vals.dtype == np.float64 else np.int32))


class Prepared:
    """A numeric column readied for exact statistics of any row subset: its
    values as exact integer pieces (a float: its 53-bit significand, with the
    exponent as a second index), and its order keys for min and max."""

    def __init__(self, values):
        if isinstance(values, Categorical):
            raise ValueError("the reference aggregates numeric columns only")
        vals = np.asarray(values)
        self.dtype, self.float = vals.dtype, vals.dtype.kind == "f"
        self.finite = bool(np.isfinite(vals).all()) if self.float else True
        self.values = vals
        if not self.finite:
            return
        if self.float:
            frac, exp = np.frexp(vals)
            self.pieces = _pieces(np.ldexp(frac, 53).astype(np.int64))
            exp = exp.astype(np.int64) - 53
            self.e0 = int(exp.min()) if exp.size else 0
            self.n_exp = int(exp.max()) - self.e0 + 1 if exp.size else 1
            self.eidx = exp - self.e0
            self.keys = _order_key(vals)
        else:
            ints = vals.view(np.int64) if vals.dtype.itemsize == 8 else vals.astype(np.int64)
            self.pieces, self.keys = _pieces(ints), ints

    def stats(self, groups: np.ndarray, k: int, rows=None) -> list:
        """sum / min / max / count in each group of [0, k) (None where empty)
        of the rows `rows` keeps (all where None); rows of group k or above
        are left out."""
        sel = None if rows is None else np.flatnonzero(rows)
        take = (lambda a: a) if sel is None else (lambda a: a[sel])  # noqa: E731
        groups = np.minimum(take(groups), k).astype(np.int64, copy=False)
        counts = np.bincount(groups, minlength=k + 1)[:k].tolist()
        if not self.finite:
            keep = groups < k
            return grouped_stats(take(self.values)[keep], groups[keep], k)
        keys = take(self.keys)
        pieces = [(shift, take(p)) for shift, p in self.pieces]
        lo = np.full(k + 1, np.iinfo(keys.dtype).max, keys.dtype)
        hi = np.full(k + 1, np.iinfo(keys.dtype).min, keys.dtype)
        np.minimum.at(lo, groups, keys)
        np.maximum.at(hi, groups, keys)
        if not self.float:
            sums = _sums(pieces, groups, k + 1)
            return [None if not counts[g] else
                    {"sum": sums[g], "min": int(lo[g]), "max": int(hi[g]), "count": counts[g]}
                    for g in range(k)]
        parts = _sums(pieces, groups * self.n_exp + take(self.eidx), (k + 1) * self.n_exp)
        out = []
        for g in range(k):
            if not counts[g]:
                out.append(None)
                continue
            num = sum(parts[g * self.n_exp + j] << j for j in range(self.n_exp))
            total = float(Fraction(num, 1 << -self.e0)) if self.e0 < 0 else float(num << self.e0)
            back = lambda key: float(_flip(np.array([key])).view(self.dtype)[0])  # noqa: E731
            out.append({"sum": total + 0.0, "min": back(lo[g]), "max": back(hi[g]),
                        "count": counts[g]})
        return out


def prepared(dataset, path: str, column: str) -> Prepared:
    """The Prepared form of a generated column, made once a run (by one of
    the threads that ask for it)."""
    key = ("prepared", path, column)
    with dataset.lock:
        lock = dataset.memo.setdefault(("lock",) + key, threading.Lock())
    with lock:
        if key not in dataset.memo:
            dataset.memo[key] = Prepared(dataset.column(path, column))
    return dataset.memo[key]


def grouped_stats(values, groups: np.ndarray, k: int, precision: str = "exact") -> list:
    """sum / min / max / count of `values` in each of `k` groups (None for an
    empty group), straight from the selected rows: the controls' path, and
    the exact path of columns that hold NaN or infinities."""
    vals = np.asarray(values)
    groups = groups.astype(np.int64)
    counts = np.bincount(groups, minlength=k).tolist()
    if vals.dtype.kind == "f" and precision == "float32":
        vals = vals.astype(np.float32)
    out = []
    for g in range(k):
        v = vals[groups == g]
        if not counts[g]:
            out.append(None)
        elif vals.dtype.kind != "f":
            out.append(oracles.oracle_stats(v))
        elif precision == "exact":
            out.append(oracles.float_group_stats(v))
        else:  # a control: NumPy's own summation, in the column's precision
            keys = _order_key(v)
            out.append({"sum": float(np.sum(v, dtype=v.dtype)) + 0.0,
                        "min": float(v[np.argmin(keys)]), "max": float(v[np.argmax(keys)]),
                        "count": counts[g]})
    return out


def _group_codes(key) -> tuple:
    if isinstance(key, Categorical):
        return key.codes, key.labels, key.labels.size
    codes = np.asarray(key).astype(np.int64)
    return codes, None, int(codes.max()) + 1 if codes.size else 0


def group_stats(dataset, path: str, key: str, value: str, preds, precision: str = "exact") -> dict:
    """{group: stats} of the non-empty groups in ascending group order, a
    string key labelled by its strings, under the WHERE `preds`."""
    rows = mask(dataset, path, preds)
    codes, labels, k = _group_codes(dataset.column(path, key))
    if precision == "exact":
        stats = prepared(dataset, path, value).stats(codes, k, rows)
    else:
        vals = np.asarray(dataset.column(path, value))
        if rows is not None:
            codes, vals = codes[rows], vals[rows]
        stats = grouped_stats(vals, codes, k, precision)
    return {(str(labels[g]) if labels is not None else g): st
            for g, st in enumerate(stats) if st is not None}


def column_stats(dataset, path: str, column: str, preds, precision: str = "exact") -> dict:
    """sum / min / max / count of one column over the rows `preds` keep."""
    rows = mask(dataset, path, preds)
    vals = np.asarray(dataset.column(path, column))
    if precision == "exact":
        (st,) = prepared(dataset, path, column).stats(np.zeros(vals.size, np.int8), 1, rows)
    else:
        (st,) = grouped_stats(vals if rows is None else vals[rows],
                              np.zeros(vals.size if rows is None else int(rows.sum()), np.int64),
                              1, precision)
    if st is None:
        return {"sum": 0.0 if vals.dtype.kind == "f" else 0, "min": None, "max": None,
                "count": 0}
    return st


_MISSING = object()


def _leaves(x) -> int:
    if isinstance(x, dict):
        return sum(_leaves(v) for v in x.values())
    if isinstance(x, np.ndarray):
        return x.size
    return 1


def _plain(x):
    return x.item() if isinstance(x, np.generic) else x


def mismatches(got, want) -> int:
    """How many values of an answer differ from the reference's: each value
    of an array (bit for bit), each field of a result, each missing or extra
    entry. Numbers compare by value and kind (int, float, None), NaN equal to
    NaN."""
    if want is _MISSING or got is _MISSING:
        return _leaves(got if want is _MISSING else want)
    if isinstance(want, dict):
        if not isinstance(got, dict):
            return _leaves(want)
        return (sum(mismatches(got.get(k, _MISSING), v) for k, v in want.items())
                + sum(_leaves(v) for k, v in got.items() if k not in want))
    if isinstance(want, np.ndarray):
        got = np.asarray(got)
        if got.shape != want.shape or got.dtype.itemsize != want.dtype.itemsize:
            return max(want.size, got.size)
        view = np.dtype("u%d" % want.dtype.itemsize)
        return int(np.count_nonzero(got.view(view) != want.view(view)))
    got, want = _plain(got), _plain(want)
    if type(got) is not type(want):
        return 1
    if isinstance(want, float) and math.isnan(want):
        return 0 if math.isnan(got) else 1
    return 0 if got == want else 1
