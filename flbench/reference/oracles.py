"""Frozen copies of the NumPy oracles of the repository's smoke test
(`chip_smoke.py`: `exact_int_sum`, `oracle_stats`, `oracle_mask`,
`float_group_stats`, `lower_quantile`), kept here so that a change to the
smoke does not move the benchmark's yardstick. The reference's fast exact
sums (common.py) are held to these in the benchmark's tests."""

import math

import numpy as np


def exact_int_sum(arr: np.ndarray) -> int:
    """Exact sum as a Python int; 64-bit columns in int64 semantics (the
    scans' convention). Two 32-bit halves, each summed in int64."""
    a = arr.view(np.int64) if arr.dtype.itemsize == 8 else arr.astype(np.int64)
    return (int((a >> 32).sum(dtype=np.int64)) << 32) + int((a & 0xFFFFFFFF).sum(dtype=np.int64))


def oracle_stats(values, dictionary_size=None) -> dict:
    """sum/min/max/count of a column as the scans define them."""
    mask = np.ma.getmaskarray(values)
    vals = np.ma.getdata(values)[~mask].reshape(-1)
    if vals.dtype.kind in "mM":
        vals = vals.view(np.int64)
    if vals.dtype.kind == "U":
        words = vals.tolist()  # numpy has no min/max for strings
        out = {"sum": None, "min": min(words) if words else None,
               "max": max(words) if words else None, "count": len(words),
               "n_dict": dictionary_size}
    elif vals.dtype.kind == "f":
        if np.isnan(vals).any():
            total = mn = mx = float("nan")
        else:
            with np.errstate(invalid="ignore"):
                inf_sum = float(vals[np.isinf(vals)].sum()) if np.isinf(vals).any() else None
            total = inf_sum if inf_sum is not None else math.fsum(vals.tolist())
            mn, mx = float(vals.min()), float(vals.max())
        out = {"sum": total, "min": mn, "max": mx, "count": int(vals.size)} if vals.size \
            else {"sum": 0.0, "min": None, "max": None, "count": 0}
    else:
        if vals.dtype.itemsize == 8:
            vals = vals.view(np.int64)
        out = {"sum": exact_int_sum(vals), "min": int(vals.min()), "max": int(vals.max()),
               "count": int(vals.size)} if vals.size \
            else {"sum": 0, "min": None, "max": None, "count": 0}
    if isinstance(values, np.ma.MaskedArray):
        out["n_null"] = int(mask.sum())
    return out


def oracle_mask(values, op: str, probe):
    """NumPy comparison semantics; nulls match nothing."""
    vals = np.ma.getdata(values)
    if vals.dtype.kind == "U":
        fn = {"lt": np.char.less, "le": np.char.less_equal, "gt": np.char.greater,
              "ge": np.char.greater_equal, "eq": np.char.equal, "ne": np.char.not_equal}
        hit = (np.isin(vals, probe) if op in ("in", "notin") else fn[op](vals, probe))
    else:
        if vals.dtype.kind in "mM":
            cast = lambda v: np.array(v, dtype=vals.dtype)
            probe = [cast(v) for v in probe] if op in ("in", "notin") else cast(probe)
        with np.errstate(invalid="ignore"):
            hit = {"lt": lambda: vals < probe, "le": lambda: vals <= probe,
                   "gt": lambda: vals > probe, "ge": lambda: vals >= probe,
                   "eq": lambda: vals == probe, "ne": lambda: vals != probe,
                   "in": lambda: np.isin(vals, probe),
                   "notin": lambda: np.isin(vals, probe)}[op]()
    if op == "notin":
        hit = ~hit
    return hit & ~np.ma.getmaskarray(values)


def float_group_stats(vals: np.ndarray) -> dict:
    """A float group as group_stats defines it: the exactly rounded sum
    (math.fsum; +0.0 when it is zero), NaN where the group holds a NaN or
    both infinities, extremes in IEEE total order (-0.0 below +0.0)."""
    bits = np.ascontiguousarray(vals).view(np.int64 if vals.dtype == np.float64 else np.int32)
    top = np.iinfo(bits.dtype).max
    key = bits ^ ((bits >> (bits.dtype.itemsize * 8 - 1)) & top)
    if np.isnan(vals).any():
        return {"sum": float("nan"), "min": float("nan"), "max": float("nan"),
                "count": int(vals.size)}
    pos, neg = np.isposinf(vals).any(), np.isneginf(vals).any()
    total = float("nan") if pos and neg else float("inf") if pos else \
        float("-inf") if neg else math.fsum(vals.tolist()) + 0.0
    return {"sum": total, "min": float(vals[np.argmin(key)]),
            "max": float(vals[np.argmax(key)]), "count": int(vals.size)}


def lower_quantile(values, q):
    vals = np.ma.getdata(values)[~np.ma.getmaskarray(values)]
    if vals.dtype.itemsize == 8 and vals.dtype.kind in "iu":
        vals = vals.view(np.int64)
    return np.partition(vals, int(np.floor(q * (vals.size - 1))))[
        int(np.floor(q * (vals.size - 1)))].item()
