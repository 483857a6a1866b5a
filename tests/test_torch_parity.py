"""One seeded differential test of the port's query surface against the JAX
package: the port on the CPU (`device="cpu"`) and the reference on the CPU
answer the same calls over the same files, and every answer is EQUAL
(tolerance 0).

Six tables, one per row count (0, 1, 1023, 1024, 1025, 3*1024+5), each
in chunks of one block, so that the chunks of the last form runs, and each
the first rows of one seeded table with every column kind: the eight
integer dtypes over their extremes, a sorted, a constant and a
small-domain column, f32 / f64 with NaN, +-inf, -0.0 and subnormals, bools,
dates, strings, and nullable int / float / string columns at 5 % and at
100 % nulls. Both writers write every table (and a plain FLT file of every
numeric column); the files must be byte-identical, and every entry then
reads the port's file.

The reference compiles a program for each (entry, column, shape) and
decodes f64 eagerly, so the calls are chosen to keep this file near a
minute and a half on a CPU: every entry meets every table; an entry with
several ways to take a column (count_where's eight operators, top_k's two
directions) takes each column one or two ways a table, in turns (TURN);
quantile's binary searches and value_counts' widest counters run on fewer
tables (see `calls`).

Equal means: Python results by `==` with types equal, floats by bit
pattern (NaN equals NaN), numpy arrays by dtype, mask and bytes, device
reads by bit pattern (the reference returns 64-bit values as uint32 limb
pairs), and an exception only the same exception type. A failing case names
the entry, the call, the table's row count and the first differing key or
index. Each (entry, table) pair is its own case, and computes each of its
reference answers once.

The mesh axis: every entry that takes `mesh=` (all but distinct, which runs
on the host) answers the same calls again on a one-rank mesh (an in-process
gloo group), held to the same reference answers, which the first pass
keeps."""

import functools
import math
import struct
import types

import numpy as np
import pytest
import torch
import torch.distributed as dist

from fastlanes_tpu import analytics as jan
from fastlanes_tpu import fio as jfio
from fastlanes_tpu import fio_device as jdev
from fastlanes_tpu import fio_table as jtab

from fastlanes_tpu_torch import analytics as tan
from fastlanes_tpu_torch import fio as tfio
from fastlanes_tpu_torch import fio_device as tdev
from fastlanes_tpu_torch import fio_table as ttab
from fastlanes_tpu_torch import parallel

ROW_COUNTS = (0, 1, 1023, 1024, 1025, 3 * 1024 + 5)
OPS = ("lt", "le", "gt", "ge", "eq", "ne", "in", "notin")
QS = [0.0, 0.25, 0.5, 0.99, 1.0]
WORDS = np.array(["EUR", "GBP", "JPY", "USD", "chf", "zł", ""])
INTS = ("u8", "u16", "u32", "u64", "i8", "i16", "i32", "i64")


def _masked(values, rng, share):
    return np.ma.MaskedArray(values, mask=rng.random(values.size) < share
                             if share < 1 else np.ones(values.size, bool))


def _floats(rng, n, dt):
    v = np.round(rng.normal(0, 1000, n), 2).astype(dt)
    tiny = np.finfo(dt).smallest_subnormal
    specials = np.array([np.nan, np.inf, -np.inf, -0.0, 0.0, tiny, -3 * tiny], dt)
    # no value near the largest double: a float sum past it raises
    # OverflowError in both packages (ROADMAP, Queue 3)
    v[:min(n, specials.size)] = specials[:n]
    return v


def table_columns(n: int) -> dict:
    """Every column kind at `n` rows: the first `n` rows of one seeded
    table, so that the tables share their codecs and widths (the JAX side
    compiles each decode once)."""
    return {name: col[:n] for name, col in _base_columns(max(ROW_COUNTS)).items()}


def _repeat_first_rows(col):
    """The one-row chunk of the 1025-row table and the five-row chunk of
    the last table repeat the first rows: their chunks then decode as the
    one-row table's and the first chunk's do."""
    col[1024] = col[0]
    col[3 * 1024:3 * 1024 + 5] = col[0:5]
    return col


def _base_columns(n: int) -> dict:
    rng = np.random.default_rng(0x9A21)
    cols = {}
    for name in INTS:
        info = np.iinfo(name.replace("u", "uint") if name[0] == "u" else
                        name.replace("i", "int"))
        v = rng.integers(info.min, info.max, n, dtype=info.dtype, endpoint=True)
        v[:min(n, 2)] = [info.min, info.max][:n]
        cols[name] = v
    cols["sorted_u32"] = (np.cumsum(rng.integers(1, 1000, n)) + 7).astype(np.uint32)
    cols["const_i16"] = np.full(n, -7, np.int16)
    cols["small_u16"] = rng.integers(0, 40, n).astype(np.uint16)
    cols["f32"] = _floats(rng, n, np.float32)
    cols["f64"] = _floats(rng, n, np.float64)
    cols["flag"] = rng.random(n) < 0.4
    # dates are probed with datetime64 values: a timedelta64 probe raises in
    # both packages' _probe_epoch (ROADMAP, Queue 3)
    cols["day"] = (np.datetime64("2021-03-01") + rng.integers(0, 700, n)).astype(
        "datetime64[D]")
    cols["cur"] = WORDS[rng.integers(0, WORDS.size, n)]
    # the 5 % float column is f32: quantile's binary search over it costs
    # the reference 32 count_where passes a q, where f64 costs 64, each
    # through its eager f64 ALP decode (~0.1 s a pass on a CPU)
    for share, tag, fdt in ((0.05, "5", np.float32), (1.0, "100", np.float32)):
        cols[f"null{tag}_i32"] = _masked(rng.integers(-500, 500, n).astype(np.int32), rng, share)
        cols[f"null{tag}_f"] = _masked(np.round(rng.uniform(-9, 9, n), 1).astype(fdt), rng,
                                       share)
        cols[f"null{tag}_str"] = _masked(WORDS[rng.integers(0, 4, n)], rng, share)
    return {k: v if k == "sorted_u32" else _repeat_first_rows(v) for k, v in cols.items()}


COLUMNS = list(table_columns(3))
PLAIN = [c for c in COLUMNS if c not in ("flag", "day", "cur", "null5_str", "null100_str")]
#: each table's turn where an entry takes a column in one of several ways
#: (count_where's operators, top_k's direction): four turns cover every way
#: of every column; the two tables of one block take the same turn, so the
#: second reuses the reference's programs of the first
TURN = {0: None, 1: 0, 1023: 1, 1024: 1, 1025: 2, 3 * 1024 + 5: 3}
SEARCHED = ("u64", "i64", "null5_f")  # the columns whose quantiles search
SEARCH_MEDIAN = 1025  # the table of two chunks, where they search once
SEARCH_ALL = 1024  # the table where they search for every q
#: the reference decodes f64 (ALP) eagerly, ~0.1 s a chunk on a CPU, and
#: compiles a nullable float read ~2 s a shape: range reads skip them
FLOATS = ("f32", "f64", "null5_f", "null100_f")
DISTINCT_ROWS = ("u16", "u32", "i16", "i32", "sorted_u32", "null5_i32")


def dim_columns() -> dict:
    """The right side of the joins: a unique u16 key over part of
    small_u16's domain and a unique string key over part of WORDS."""
    rng = np.random.default_rng(0xD1)
    return {"small_u16": (np.arange(30, dtype=np.uint16) * 7 % 30)[::-1].copy(),
            "rate": np.round(rng.normal(1.0, 0.1, 30), 4),
            "label": np.array([f"k{i:02d}" for i in range(30)])}


def str_dim_columns() -> dict:
    return {"cur": np.array(["GBP", "EUR", "zł", "XXX"]),
            "sym": np.array(["£", "€", "z", "?"])}


def probes(col, kind: str):
    """A probe value and a probe list for the predicates on one column:
    values the column holds (where it holds any), so that every operator
    splits it."""
    data = np.ma.getdata(col)
    if data.size == 0:
        fallback = {"flag": True, "day": np.datetime64("2021-05-01"), "cur": "GBP",
                    "null5_str": "GBP", "null100_str": "GBP"}
        v = fallback.get(kind, 3)
        return v, [v]
    mid = data[data.size // 2]
    last = data[-1]
    if data.dtype.kind == "f":
        return float(mid), [float(mid), float(last), 0.5]
    if data.dtype.kind == "M":
        return mid, [mid, last]
    if data.dtype.kind == "U":
        return str(mid), [str(mid), str(last), "nope"]
    if data.dtype.kind == "b":
        return bool(mid), [bool(mid)]
    return int(mid), [int(mid), int(last), 12345]


# ---------------------------------------------------------------------------
# the calls: entry -> [(label, call(api))]; `api` is REF or PORT, the same
# names with the same signatures

#: entry -> (the reference's function, the port's)
ENTRY_FUNCTIONS = {
    "read_column_device": (jdev.read_column_device, tdev.read_column_device),
    "read_file_device": (jdev.read_file_device, tdev.read_file_device),
    **{name: (getattr(jan, name), getattr(tan, name)) for name in (
        "scan_column", "scan_table", "count_where", "scan_where_multi", "group_stats",
        "distinct", "value_counts", "top_k", "quantile", "median", "select", "join")},
}
ENTRIES = tuple(ENTRY_FUNCTIONS)
REF = types.SimpleNamespace(**{e: ref for e, (ref, _) in ENTRY_FUNCTIONS.items()})
PORT = types.SimpleNamespace(**{  # distinct runs on the host: no device argument
    e: port if e == "distinct" else functools.partial(port, device="cpu")
    for e, (_, port) in ENTRY_FUNCTIONS.items()})
#: the entries that take a mesh
MESH_ENTRIES = tuple(e for e in ENTRIES if e != "distinct")


def port_on(mesh):
    """The port's entries on `mesh` (same names and signatures)."""
    return types.SimpleNamespace(**{e: functools.partial(ENTRY_FUNCTIONS[e][1], device="cpu",
                                                         mesh=mesh) for e in MESH_ENTRIES})


def calls(entry: str, t: dict) -> list:
    """Every call of one entry on one table `t` (see the `world` fixture)."""
    p, cols = t["path"], t["cols"]
    out = []
    if entry == "read_column_device":
        # on the table of several chunks, a range across them (the float
        # columns whole: see FLOATS)
        n = t["n"]
        for c in COLUMNS:
            if n < 2 * 1024 or c in FLOATS:
                out.append((c, lambda a, c=c: a.read_column_device(p, c)))
            else:
                out.append((f"{c}[1:{n - 1}]",
                            lambda a, c=c: a.read_column_device(p, c, 1, n - 1)))
    elif entry == "read_file_device":
        for c in PLAIN:
            out.append((c, lambda a, c=c: a.read_file_device(t["files"][c])))
    elif entry == "scan_column":
        for c in COLUMNS:
            out.append((c, lambda a, c=c: a.scan_column(p, c)))
        # a plain file reads its own header
        out.append(("file:null5_f", lambda a: a.scan_column(t["files"]["null5_f"])))
    elif entry == "scan_table":
        out.append(("all", lambda a: a.scan_table(p)))
        out.append(("some", lambda a: a.scan_table(p, ["f64", "cur", "i64", "null5_i32"])))
    elif entry == "count_where":
        # the zero-row table takes every operator on every column, the others
        # one each, by TURN (the reference compiles a program for each
        # operator and column): every operator on every table, and four of
        # the eight on every column
        turn = TURN[t["n"]]
        for i, c in enumerate(COLUMNS):
            v, vs = probes(cols[c], c)
            for op in OPS if turn is None else (OPS[(i + 2 * turn) % len(OPS)],):
                arg = vs if op in ("in", "notin") else v
                out.append((f"{c} {op}", lambda a, c=c, op=op, arg=arg:
                            a.count_where(p, op, arg, column=c)))
    elif entry == "scan_where_multi":
        two = [("small_u16", "lt", 25), ("flag", "eq", True)]
        for c in ("u8", "u64", "i64", "sorted_u32", "f32", "day", "flag", "null5_i32",
                  "null5_f", "null100_i32"):
            out.append((c, lambda a, c=c: a.scan_where_multi(p, two, column=c)))
        mixed = [("cur", "in", ["EUR", "zł"]), ("f32", "ge", 0.0)]
        for c in ("i32", "null5_f", "cur"):
            out.append((f"{c} str+float", lambda a, c=c: a.scan_where_multi(p, mixed, column=c)))
    elif entry == "group_stats":
        # a u16 key of 40 values: its range is far inside int32 (the
        # reference raises OverflowError there under a mask) and a 64-bit
        # value column, which has no group cap, allocates 40 groups
        # (ROADMAP, Queue 3)
        for v in ("i32", "f64", "null5_i32"):
            out.append((v, lambda a, v=v: a.group_stats(p, "small_u16", v)))
            out.append((f"{v} where", lambda a, v=v: a.group_stats(
                p, "small_u16", v, preds=[("sorted_u32", "ge", 5000), ("flag", "eq", False)])))
    elif entry == "distinct":
        for c in COLUMNS:
            out.append((c, lambda a, c=c: a.distinct(p, c)))
    elif entry == "value_counts":
        # the reference compiles a counter as wide as the distinct set: a
        # column with a value a row takes it on the tables of 1 and 3077 rows
        for c in COLUMNS:
            if t["n"] in (0, 1, ROW_COUNTS[-1]) or c not in DISTINCT_ROWS:
                out.append((c, lambda a, c=c: a.value_counts(p, c)))
    elif entry == "median":
        searched = SEARCHED if t["n"] == SEARCH_MEDIAN else ()  # see quantile
        for c in searched + ("i8", "day", "flag", "cur", "null5_i32", "null100_f"):
            out.append((c, lambda a, c=c: a.median(p, c)))
    elif entry == "top_k":
        # each column one direction a table, by TURN (both on the empty one)
        turn = TURN[t["n"]]
        for i, c in enumerate(COLUMNS):
            for largest in (True, False) if turn is None else ((i + turn) % 2 == 0,):
                out.append((f"{c} largest={largest}", lambda a, c=c, largest=largest:
                            a.top_k(p, c, k=5, largest=largest)))
    elif entry == "quantile":
        # a column that value_counts refuses (64-bit, float) takes a binary
        # search over its key domain, 32 or 64 count_where passes a q in
        # both packages, each over every chunk: those columns take every q
        # on one table of one chunk and median (one q) on one of two chunks
        for c in COLUMNS:
            if c not in SEARCHED or t["n"] in (0, 1, SEARCH_ALL):
                out.append((c, lambda a, c=c: a.quantile(p, c, QS)))
    elif entry == "select":
        v, _ = probes(cols["i32"], "i32")
        one = [("small_u16", "ge", 20)]
        two = [("i32", "le", v), ("cur", "ne", "EUR")]
        # ORDER BY a key with no ties and never its type's worst value: the
        # reference's tie order depends on the key's width and it can leak
        # a masked row ahead of a worst-valued one (ROADMAP, Queue 3)
        variants = {
            "all": dict(),  # every column: on the tables of 0, 1 and 3077 rows
            "project": dict(columns=["cur", "i64", "null5_f", "day"]),
            "one pred": dict(columns=["sorted_u32", "null5_str", "f32"], preds=one),
            "two preds limit": dict(columns=["i32", "cur", "u16", "null5_i32", "null100_str",
                                             "f32"], preds=two, limit=7),
            "limit 0": dict(columns=["u8"], limit=0),
            "order asc limit": dict(columns=["sorted_u32", "cur", "null100_f"],
                                    preds=one, order_by="sorted_u32", limit=9),
            "order desc limit": dict(columns=["sorted_u32", "u64", "flag"], preds=two,
                                     order_by="sorted_u32", desc=True, limit=4),
            "order desc": dict(columns=["sorted_u32", "i8"], order_by="sorted_u32", desc=True),
        }
        if t["n"] in (1023, 1024, 1025):
            del variants["all"]
        for label, kw in variants.items():
            out.append((label, lambda a, kw=kw: a.select(p, **kw)))
    elif entry == "join":
        for how in ("inner", "left"):
            out.append((f"u16 {how}", lambda a, how=how: a.join(
                p, t["dim"], on="small_u16", columns=["small_u16", "i32", "null5_str"],
                how=how)))
            out.append((f"u16 {how} where limit", lambda a, how=how: a.join(
                p, t["dim"], on="small_u16", columns=["sorted_u32"], right_columns=["label"],
                preds=[("flag", "eq", True)], how=how, limit=6)))
            out.append((f"str {how}", lambda a, how=how: a.join(
                p, t["str_dim"], on="cur", columns=["cur", "f32"], how=how)))
    else:
        raise KeyError(entry)
    return out


# ---------------------------------------------------------------------------
# answers in comparable form


class Raised:
    def __init__(self, exc):
        self.type = type(exc)

    def __repr__(self):
        return f"raised {self.type.__name__}"


def host_form(x):
    """A result with every device array as a numpy array: port tensors, the
    reference's arrays and limb planes (np.asarray gives their interleaved
    uint32 image), through NullableColumn and StringColumn."""
    if isinstance(x, (tdev.NullableColumn, jdev.NullableColumn)):
        return {"valid": host_form(x.valid), "values": host_form(x.values)}
    if isinstance(x, (ttab.StringColumn, jtab.StringColumn)):
        return {"dictionary": np.asarray(x.dictionary), "codes": host_form(x.codes)}
    if isinstance(x, torch.Tensor):
        return x.numpy()
    if isinstance(x, (dict, list, tuple, np.ndarray)) or np.isscalar(x) or x is None:
        return x
    return np.asarray(x)


def run(call, api):
    try:
        return host_form(call(api))
    except Exception as exc:  # noqa: BLE001  (compared by type below)
        return Raised(exc)


def first_diff(got, want, bits: bool, at="") -> str:
    """None if `got` equals `want` as the module docstring says, else where
    and how they first differ. `bits`: arrays by bit pattern (device reads)."""
    if isinstance(want, Raised) or isinstance(got, Raised):
        if isinstance(want, Raised) and isinstance(got, Raised) and got.type is want.type:
            return None
        return f"{at}: port {got!r}, reference {want!r}"
    if isinstance(want, dict):
        if not isinstance(got, dict) or list(got) != list(want):
            return f"{at}: keys {list(got) if isinstance(got, dict) else got!r} != {list(want)}"
        for k in want:
            d = first_diff(got[k], want[k], bits, f"{at}[{k!r}]")
            if d:
                return d
        return None
    if isinstance(want, (list, tuple)):
        if type(got) is not type(want) or len(got) != len(want):
            return f"{at}: port {got!r} != reference {want!r}"
        for i, (g, w) in enumerate(zip(got, want)):
            d = first_diff(g, w, bits, f"{at}[{i}]")
            if d:
                return d
        return None
    if isinstance(want, np.ndarray):
        return array_diff(got, want, bits, at)
    if type(got) is not type(want):
        return f"{at}: port {type(got).__name__} {got!r}, " \
               f"reference {type(want).__name__} {want!r}"
    if isinstance(want, float):
        if math.isnan(want) and math.isnan(got):
            return None
        same = struct.pack("<d", got) == struct.pack("<d", want)
        return None if same else f"{at}: port {got!r} != reference {want!r}"
    return None if got == want else f"{at}: port {got!r} != reference {want!r}"


def array_diff(got, want, bits: bool, at) -> str:
    if bits and want.dtype.kind != "U":  # 64-bit values: (..., 2) uint32 limb pairs there
        if not isinstance(got, np.ndarray):
            return f"{at}: port {type(got).__name__}, reference an array"
        if got.dtype.itemsize == 8 and want.dtype == np.uint32 and \
                want.shape == got.shape + (2,):
            want = np.ascontiguousarray(want).view(np.uint64).reshape(got.shape)
        if got.dtype.itemsize != want.dtype.itemsize or got.shape != want.shape:
            return f"{at}: port {got.dtype} {got.shape}, reference {want.dtype} {want.shape}"
        got = np.ascontiguousarray(got).view(f"u{got.dtype.itemsize}")
        want = np.ascontiguousarray(want).view(got.dtype)
    elif type(got) is not type(want) or got.dtype != want.dtype or got.shape != want.shape:
        return (f"{at}: port {type(got).__name__} {getattr(got, 'dtype', None)} "
                f"{getattr(got, 'shape', None)}, reference {type(want).__name__} "
                f"{want.dtype} {want.shape}")
    gm, wm = np.ma.getmaskarray(got).reshape(-1), np.ma.getmaskarray(want).reshape(-1)
    if not np.array_equal(gm, wm):
        return f"{at}: the mask differs first at index {np.flatnonzero(gm != wm)[0]}"
    g, w = np.ma.getdata(got).reshape(-1), np.ma.getdata(want).reshape(-1)
    if w.dtype.kind in "biufcmM":  # by bytes: NaN is NaN, -0.0 is not 0.0
        bad = np.flatnonzero((g.view(np.uint8).reshape(g.size, g.itemsize)
                              != w.view(np.uint8).reshape(w.size, w.itemsize)).any(axis=1))
    else:
        bad = np.flatnonzero(g != w)
    if bad.size:
        i = bad[0]
        return f"{at}: first differing index {i}: port {g[i]!r}, reference {w[i]!r}"
    return None


# ---------------------------------------------------------------------------
# the tables, written by both writers


def write_both(root, name, cols, **kw):
    """Write `cols` (a dict: a table; else a plain FLT file) with the port's
    writer and the reference's; returns the port's path and whether the two
    files are byte-identical."""
    port, ref = str(root / f"{name}.flt"), str(root / f"{name}.ref.flt")
    if isinstance(cols, dict):
        ttab.write_table(port, cols, **kw)
        jtab.write_table(ref, cols, **kw)
    else:
        tfio.write_file(port, cols, **kw)
        jfio.write_file(ref, cols, **kw)
    with open(port, "rb") as a, open(ref, "rb") as b:
        return port, a.read() == b.read()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("parity")
    dim, dim_same = write_both(root, "dim", dim_columns())
    str_dim, str_same = write_both(root, "str_dim", str_dim_columns())
    out = {}
    for n in ROW_COUNTS:
        cols = table_columns(n)
        kw = {"chunk_blocks": 1}
        path, same = write_both(root, f"t{n}", cols, **kw)
        files, files_same = {}, {"dim": dim_same, "str_dim": str_same, "table": same}
        for c in PLAIN:
            files[c], files_same[c] = write_both(root, f"t{n}_{c}", cols[c], **kw)
        out[n] = {"n": n, "path": path, "cols": cols, "files": files, "dim": dim,
                  "str_dim": str_dim, "same_bytes": files_same}
    return out


@pytest.mark.parametrize("n", ROW_COUNTS)
def test_both_writers_write_the_same_bytes(world, n):
    t = world[n]
    assert [k for k, same in t["same_bytes"].items() if not same] == []
    assert tfio.read_header(t["files"]["u32"]) == jfio.read_header(t["files"]["u32"])


#: (entry, rows, label) -> the reference's answer, kept for the mesh axis
REFERENCE = {}


def reference(entry, n, label, call):
    if (entry, n, label) not in REFERENCE:
        REFERENCE[entry, n, label] = run(call, REF)
    return REFERENCE[entry, n, label]


@pytest.fixture(scope="module")
def mesh1():
    """A one-rank gloo group for this module only."""
    assert not dist.is_initialized()
    mesh = parallel.make_mesh(device="cpu")
    yield mesh
    dist.destroy_process_group()


def check(world, entry, n, api):
    t = world[n]
    assert all(t["same_bytes"].values())  # both packages read the one file
    bits = entry.startswith("read_")
    diffs = []
    for label, call in calls(entry, t):
        d = first_diff(run(call, api), reference(entry, n, label, call), bits)
        if d:
            diffs.append(f"{entry}({label}) on the {n}-row table{d}")
    kinds = ", ".join(f"{c}: {np.asarray(v).dtype}" for c, v in t["cols"].items())
    assert not diffs, "\n".join(diffs[:10]) + \
        f"\n({len(diffs)} calls differ; the table's columns: {kinds})"


@pytest.mark.parametrize("n", ROW_COUNTS)
@pytest.mark.parametrize("entry", ENTRIES)
def test_port_answers_equal_the_reference(world, entry, n):
    check(world, entry, n, PORT)


@pytest.mark.parametrize("n", ROW_COUNTS)
@pytest.mark.parametrize("entry", MESH_ENTRIES)
def test_port_answers_on_a_mesh_equal_the_reference(world, mesh1, entry, n):
    check(world, entry, n, port_on(mesh1))
