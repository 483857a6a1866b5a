"""`mesh=` on the port's reads, aggregations, select and join, against the JAX
package's same entries with `mesh=fastlanes_tpu.parallel.make_mesh(8)` and
against the port without a mesh, at tolerance 0.

The port splits an entry's chunks over the ranks of the mesh (one process a
device; parallel/shard.py): a read returns the rank's local part, and the
parts in rank order, concatenated, must be the reference's read; an
aggregation combines the ranks' exact partial states once, a select or join
the ranks' rows (or ORDER BY ... LIMIT candidates) once, and every rank
must return the reference's answer. A table of 17 one-block chunks of tied
keys has its lockstep window of chunks 8-15 cut by the two ranks' split. Two worlds: one rank on an in-process
gloo store, and two ranks in two child processes over a `file://` store,
spawned once for the module.

Three tables of 0, 1 and 2053 rows in chunks of one block: the two ranks
get 0 / 0, 1 / 0 and 2 / 1 chunks (the second rank's one chunk is the
five-row tail). Every table is
the first rows of one seeded table whose columns take every codec between
them (bitpack, ffor, delta, zdelta, rle, dict, alp, alprd), with nullable
ints, floats and strings, strings, dates, bools, and f32 / f64 with NaN,
+-inf and -0.0. One case per (entry, table); each computes the port's
answers, and the references (the JAX package with its mesh, the two ranks)
come from one module fixture, computed once. The reference compiles a
program for each (entry, column, shape), so the reads of every codec and
column kind, the ranges, the two-file datasets and the binary search run on
the largest table alone, which keeps the module near a minute and a half on
a CPU. Results compare as in tests/test_torch_parity.py (floats by bit
pattern, reads by bit pattern, an exception by its type)."""

import os
import pickle
import subprocess
import sys
import types

import numpy as np
import pytest
import torch
import torch.distributed as dist

from fastlanes_tpu_torch import analytics as tan
from fastlanes_tpu_torch import fio as tfio
from fastlanes_tpu_torch import fio_device as tdev
from fastlanes_tpu_torch import fio_table as ttab
from fastlanes_tpu_torch import parallel
from fastlanes_tpu_torch.parallel import shard

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROWS = (0, 1, 2053)
WORDS = np.array(["EUR", "GBP", "JPY", "USD", "zł", ""])
FILES = ("ffor_u32", "walk_i32", "null_f32")  # plain FLT files of these columns


def _base_columns(n: int) -> dict:
    rng = np.random.default_rng(0x3E54)
    bits = rng.integers(0, 64, n).astype(np.uint8)
    bits[:2] = [0, 63]  # bitpack ties ffor and wins
    f64 = np.round(rng.normal(0, 100, n), 1)
    f32 = np.round(rng.normal(0, 10, n), 1).astype(np.float32)
    for col in (f64, f32):
        col[:6] = np.array([np.nan, np.inf, -np.inf, -0.0, 0.0, 1.5], col.dtype)
    cols = {
        "bits_u8": bits,
        "ffor_u32": (rng.integers(0, 3000, n) + 3_000_000_000).astype(np.uint32),
        "walk_i32": (np.cumsum(rng.integers(-1000, 1000, n)) - 10 ** 6).astype(np.int32),
        "rle_u16": np.repeat(rng.integers(0, 60000, n // 50 + 1), 50)[:n].astype(np.uint16),
        "dict_u32": rng.choice(np.array([7, 4_000_000_000, 123456, 99], np.uint32), n),
        "alp_f64": np.round(rng.uniform(-1000, 1000, n), 2),
        "rd_f32": rng.normal(0, 1, n).astype(np.float32),
        "sp_f64": f64,
        "sp_f32": f32,
        "flag": rng.random(n) < 0.3,
        "day": (np.datetime64("2020-01-01") + rng.integers(0, 900, n)).astype("datetime64[D]"),
        "cur": WORDS[rng.integers(0, WORDS.size, n)],
        "key": rng.integers(0, 30, n).astype(np.uint16),
        "null_i32": np.ma.MaskedArray(rng.integers(-99, 99, n).astype(np.int32),
                                      mask=rng.random(n) < 0.1),
        "null_f32": np.ma.MaskedArray(np.round(rng.uniform(-9, 9, n), 1).astype(np.float32),
                                      mask=rng.random(n) < 0.1),
        "null_str": np.ma.MaskedArray(WORDS[rng.integers(0, 4, n)], mask=rng.random(n) < 0.1),
    }
    for col in cols.values():
        # the one-row chunk repeats row 0 and the five-row chunk rows 0-4:
        # those chunks then decode as the one-row table's and the first
        # chunk's, and the reference compiles fewer programs
        col[1024] = col[0]
        col[2048:2053] = col[0:5]
    # sorted after the repeats: delta chunks
    cols["delta_u64"] = (np.cumsum(rng.integers(1, 1000, n)) + (1 << 40)).astype(np.uint64)
    return cols


BASE = _base_columns(max(ROWS))
READ_COLUMNS = ("bits_u8", "ffor_u32", "delta_u64", "walk_i32", "rle_u16", "dict_u32",
                "alp_f64", "rd_f32", "sp_f32", "flag", "day", "cur", "null_i32", "null_str")


def table_columns(n: int) -> dict:
    return {name: col[:n] for name, col in BASE.items()}


#: rows of the tie table: 17 chunks of one block, which two ranks split 9 / 8,
#: so that rank 1's range starts inside the lockstep window of chunks 8-15
TIE_ROWS = 17 * 1024


def tie_columns() -> dict:
    """Order keys with many ties (every key in {0, 1, 2}) at 64 and at 32 bits,
    and the row number to see which of the tied rows came out."""
    rng = np.random.default_rng(0x71E5)
    return {"k64": rng.integers(0, 3, TIE_ROWS).astype(np.int64),
            "k32": rng.integers(0, 3, TIE_ROWS).astype(np.int32),
            "row": np.arange(TIE_ROWS, dtype=np.uint32)}


def dim_columns() -> dict:
    """The right sides of the joins: a unique u16 `key` over part of the
    table's key domain (and the same keys as u32, which the left key's
    dtype refuses), and a unique string `cur` over part of WORDS."""
    key = (np.arange(24, dtype=np.uint16) * 7 % 30)[::-1].copy()
    rng = np.random.default_rng(0xD1)
    dim = {"key": key, "rate": np.round(rng.normal(1.0, 0.1, key.size), 4),
           "label": np.array([f"k{int(k):02d}" for k in key])}
    return {"dim": dim, "dim_u32": dict(dim, key=key.astype(np.uint32)),
            "str_dim": {"cur": np.array(["GBP", "EUR", "zł", "XXX"]),
                        "sym": np.array(["£", "€", "z", "?"])},
            "str_key_dim": {"key": np.array(["1", "2"]), "sym": np.array(["a", "b"])}}


def strip_zone_maps(src: str, dst: str) -> None:
    """A copy of table `src` whose header holds no zone-map stats, as a file
    written before zone maps existed: ORDER BY ... LIMIT then walks every
    window in order."""
    import json
    import struct

    with open(src, "rb") as f:
        magic = f.read(len(ttab.MAGIC))
        (hlen,) = struct.unpack("<I", f.read(4))
        header = json.loads(f.read(hlen))
        payload = f.read()
    for col in header["columns"].values():
        for chunk in col["chunks"]:
            chunk.pop("stats", None)
    hdr = json.dumps(header).encode()
    with open(dst, "wb") as f:
        f.write(magic + struct.pack("<I", len(hdr)) + hdr + payload)


def world_paths(root: str) -> dict:
    """Where write_world puts every file."""
    out = {n: {"n": n, "path": f"{root}/t{n}.flt",
               "files": {c: f"{root}/t{n}_{c}.flt" for c in FILES}} for n in ROWS}
    out["ties"] = f"{root}/ties.flt"
    out["no_zone_maps"] = f"{root}/t{max(ROWS)}_no_zone_maps.flt"
    out.update({name: f"{root}/{name}.flt" for name in dim_columns()})
    return out


def write_world(root: str) -> dict:
    """Every table, a plain FLT file of each of FILES per table, the tie
    table, the largest table without zone maps and the joins' right sides."""
    out = world_paths(root)
    for n in ROWS:
        cols = table_columns(n)
        ttab.write_table(out[n]["path"], cols, chunk_blocks=1)
        for c in FILES:
            tfio.write_file(out[n]["files"][c], cols[c], chunk_blocks=1)
    ttab.write_table(out["ties"], tie_columns(), chunk_blocks=1)
    strip_zone_maps(out[max(ROWS)]["path"], out["no_zone_maps"])
    for name, cols in dim_columns().items():
        ttab.write_table(out[name], cols)
    return out


# ---------------------------------------------------------------------------
# the calls: entry -> [(label, call(api, **kw))]; `kw` is the port's device
# and mesh, or the reference's mesh

ENTRIES = ("read_blocks_device", "read_file_device", "read_files_device",
           "iter_files_device", "read_column_device", "scan_column", "scan_table",
           "count_where", "scan_where", "scan_where_multi", "group_stats", "value_counts",
           "top_k", "quantile", "median", "select", "join")
READS = ENTRIES[:5]
PORT = types.SimpleNamespace(**{e: getattr(tdev if e in READS else tan, e) for e in ENTRIES})


def calls(entry: str, t: dict, world: dict) -> list:
    p, n, files = t["path"], t["n"], t["files"]
    blocks = -(-n // 1024)
    big = n == max(ROWS)
    other = world[1]["path"]  # the second file of a two-file dataset
    out = []
    # the nullable float file costs the reference a compile a shape
    here = FILES if big else FILES[:2]
    if entry == "read_blocks_device":
        for c in here:
            out.append((c, lambda a, c=c, **kw: a.read_blocks_device(files[c], **kw)))
            if big and c != "null_f32":
                out.append((f"{c}[1:]", lambda a, c=c, **kw: a.read_blocks_device(
                    files[c], 1, blocks, **kw)))
    elif entry == "read_file_device":
        for c in here:
            out.append((c, lambda a, c=c, **kw: a.read_file_device(files[c], **kw)))
    elif entry == "read_files_device":
        out.append(("all", lambda a, **kw: a.read_files_device([files[c] for c in here], **kw)))
    elif entry == "iter_files_device":
        out.append(("all", lambda a, **kw: list(a.iter_files_device(
            [files[c] for c in here], **kw))))
    elif entry == "read_column_device":
        # every codec and every column kind once (the reference compiles a
        # read for each column and shape)
        for c in READ_COLUMNS if big else ("bits_u8", "delta_u64", "sp_f32", "cur",
                                           "null_i32", "null_str"):
            out.append((c, lambda a, c=c, **kw: a.read_column_device(p, c, **kw)))
        if big:
            for c in ("walk_i32", "null_str", "sp_f32"):
                out.append((f"{c}[1:{blocks}]", lambda a, c=c, **kw: a.read_column_device(
                    p, c, 1, blocks, **kw)))
    elif entry == "scan_column":
        for c in ("bits_u8", "delta_u64", "walk_i32", "rle_u16", "alp_f64", "rd_f32",
                  "sp_f64", "sp_f32", "day", "cur", "null_i32", "null_f32", "null_str"):
            out.append((c, lambda a, c=c, **kw: a.scan_column(p, c, **kw)))
        out.append(("file", lambda a, **kw: a.scan_column(files["walk_i32"], **kw)))
        for c in ("ffor_u32", "cur") if big else ():
            out.append((f"{c} dataset", lambda a, c=c, **kw: a.scan_column([p, other], c, **kw)))
    elif entry == "scan_table":
        out.append(("all", lambda a, **kw: a.scan_table(p, **kw)))
        if big:
            out.append(("dataset", lambda a, **kw: a.scan_table(
                [p, other], ["dict_u32", "null_str", "sp_f64"], **kw)))
    elif entry == "count_where":
        for c, op, v in (("bits_u8", "lt", 20), ("walk_i32", "ge", -10 ** 6),
                         ("sp_f64", "le", 0.0), ("cur", "in", ["EUR", "zł"]),
                         ("day", "gt", np.datetime64("2021-01-01")), ("null_i32", "ne", 3),
                         # zone maps: every chunk 'all', and every chunk 'none'
                         ("ffor_u32", "ge", 3_000_000_000), ("key", "gt", 99)):
            out.append((f"{c} {op}", lambda a, c=c, op=op, v=v, **kw: a.count_where(
                p, op, v, column=c, **kw)))
        if big:
            out.append(("dataset", lambda a, **kw: a.count_where(
                [p, other], "eq", "GBP", column="null_str", **kw)))
    elif entry == "scan_where":
        for c, w, op, v in (("alp_f64", "key", "lt", 12), ("sp_f32", "cur", "eq", "JPY"),
                            ("null_i32", None, "gt", 0), ("cur", "flag", "eq", True),
                            ("delta_u64", "null_f32", "ge", 0.0)):
            out.append((f"{c} where {w} {op}", lambda a, c=c, w=w, op=op, v=v, **kw:
                        a.scan_where(p, op, v, column=c, where=w, **kw)))
    elif entry == "scan_where_multi":
        two = [("key", "lt", 20), ("cur", "ne", "EUR")]
        for c in ("null_i32", "sp_f64", "cur"):
            out.append((c, lambda a, c=c, **kw: a.scan_where_multi(p, two, column=c, **kw)))
        pruned = [("ffor_u32", "lt", 0)]  # the zone maps rule out every chunk
        out.append(("pruned", lambda a, **kw: a.scan_where_multi(p, pruned, column="rd_f32",
                                                                 **kw)))
    elif entry == "group_stats":
        for v in ("sp_f64", "walk_i32", "null_str"):
            out.append((v, lambda a, v=v, **kw: a.group_stats(p, "key", v, **kw)))
        out.append(("cur->null_f32 where", lambda a, **kw: a.group_stats(
            p, "cur", "null_f32", preds=[("bits_u8", "ge", 10)], **kw)))
        if big:
            out.append(("dataset", lambda a, **kw: a.group_stats(
                [p, other], "cur", "walk_i32", **kw)))
    elif entry == "value_counts":
        for c in ("null_i32", "cur", "flag", "rle_u16", "dict_u32"):
            out.append((c, lambda a, c=c, **kw: a.value_counts(p, c, **kw)))
        out.append(("capped", lambda a, **kw: a.value_counts(p, "bits_u8", max_values=40,
                                                             **kw)))
        out.append(("float", lambda a, **kw: a.value_counts(p, "sp_f32", **kw)))
        if big:
            out.append(("dataset", lambda a, **kw: a.value_counts([p, other], "null_str",
                                                                  **kw)))
    elif entry == "top_k":
        for c, largest in (("sp_f64", True), ("sp_f32", False), ("walk_i32", True),
                           ("delta_u64", False), ("cur", True), ("day", False),
                           ("null_f32", True)):
            out.append((f"{c} largest={largest}", lambda a, c=c, largest=largest, **kw:
                        a.top_k(p, c, k=5, largest=largest, **kw)))
        if big:
            out.append(("dataset", lambda a, **kw: a.top_k([p, other], "alp_f64", k=4, **kw)))
    elif entry == "quantile":
        for c in ("ffor_u32", "null_i32", "cur", "day"):
            out.append((c, lambda a, c=c, **kw: a.quantile(p, c, [0.0, 0.3, 0.99, 1.0], **kw)))
        if big:  # a binary search over the f32 key space: a count_where a step
            out.append(("search rd_f32", lambda a, **kw: a.quantile(p, "rd_f32", 0.5, **kw)))
    elif entry == "median":
        for c in ("walk_i32", "sp_f64", "null_str", "flag"):
            out.append((c, lambda a, c=c, **kw: a.median(p, c, **kw)))
    elif entry == "select":
        out += select_calls(p, big, other, world)
    elif entry == "join":
        out += join_calls(p, big, other, world)
    else:
        raise KeyError(entry)
    return out


def select_calls(p: str, big: bool, other: str, world: dict) -> list:
    """select in every form: WHERE, LIMIT (inside rank 0's chunks and past
    them), ORDER BY, ORDER BY ... LIMIT with zone maps and without, the
    two-file dataset, the tie table, and a refusal. The ORDER BY ... LIMIT
    keys hold no null and never their type's worst value, and a WHERE leaves
    more rows than the limit: there the reference can return a row that
    fails the WHERE (ROADMAP.md, Queue 3, `select`)."""
    two = [("key", "lt", 20), ("cur", "ne", "EUR")]
    out = [
        ("where", lambda a, **kw: a.select(
            p, ["walk_i32", "cur", "null_f32", "day", "flag"], two, **kw)),
        ("limit past rank 0", lambda a, **kw: a.select(p, ["ffor_u32", "null_str"],
                                                       limit=2050, **kw)),
        ("where limit", lambda a, **kw: a.select(p, ["ffor_u32", "null_str"],
                                                 [("key", "ge", 5)], limit=1500, **kw)),
        ("limit 0", lambda a, **kw: a.select(p, ["bits_u8"], limit=0, **kw)),
        ("order desc", lambda a, **kw: a.select(p, ["walk_i32", "bits_u8"],
                                                order_by="walk_i32", desc=True, **kw)),
        ("order asc limit", lambda a, **kw: a.select(
            p, ["alp_f64", "cur", "null_i32"], [("key", "lt", 25)], order_by="alp_f64",
            limit=7, **kw)),
        ("order desc limit u64", lambda a, **kw: a.select(
            p, ["delta_u64", "null_str"], order_by="delta_u64", desc=True, limit=5, **kw)),
        ("unknown op", lambda a, **kw: a.select(p, ["key"], [("key", "zz", 1)], **kw)),
    ]
    if big:
        nz, ties = world["no_zone_maps"], world["ties"]
        out += [
            ("order desc limit, no zone maps", lambda a, **kw: a.select(
                nz, ["walk_i32", "cur"], order_by="walk_i32", desc=True, limit=6, **kw)),
            ("dataset where limit", lambda a, **kw: a.select(
                [p, other], ["walk_i32", "cur"], [("key", "lt", 10)], limit=700, **kw)),
            ("dataset order", lambda a, **kw: a.select(
                [p, other], ["walk_i32", "null_str"], order_by="walk_i32", **kw)),
            ("dataset order desc limit", lambda a, **kw: a.select(
                [p, other], ["alp_f64", "cur"], order_by="alp_f64", desc=True, limit=4, **kw)),
            ("dataset, a file that is no table", lambda a, **kw: a.select(
                [p, world[max(ROWS)]["files"]["walk_i32"]], ["walk_i32"], limit=3000, **kw)),
            ("ties i64 desc", lambda a, **kw: a.select(
                ties, ["row", "k32"], order_by="k64", desc=True, limit=3000, **kw)),
            ("ties i32 desc", lambda a, **kw: a.select(
                ties, ["row", "k64"], order_by="k32", desc=True, limit=3000, **kw)),
            ("ties i64 asc", lambda a, **kw: a.select(
                ties, ["row", "k32"], order_by="k64", limit=3000, **kw)),
        ]
    return out


def join_calls(p: str, big: bool, other: str, world: dict) -> list:
    """join inner and left on an int and a string key, with preds and LIMIT
    (inside rank 0's chunks and past them), the two-file dataset, and the
    refusals of the walk: a key dtype that differs (raised at the first
    window, so on the one-row table by rank 0 alone) and a string right key
    against an int left key (raised at the start of the file's walk)."""
    dim, dim32, sdim = world["dim"], world["dim_u32"], world["str_dim"]
    out = [
        ("u16 inner", lambda a, **kw: a.join(
            p, dim, on="key", columns=["key", "walk_i32", "null_str"], **kw)),
        ("u16 left where limit", lambda a, **kw: a.join(
            p, dim, on="key", columns=["ffor_u32"], right_columns=["label"],
            preds=[("flag", "eq", True)], how="left", limit=300, **kw)),
        ("str inner where", lambda a, **kw: a.join(
            p, sdim, on="cur", columns=["cur", "sp_f32"], preds=[("key", "ge", 3)], **kw)),
        ("str left limit past rank 0", lambda a, **kw: a.join(
            p, sdim, on="cur", columns=["null_i32"], how="left", limit=2050, **kw)),
        ("string right key, int left key", lambda a, **kw: a.join(
            p, world["str_key_dim"], on="key", columns=["walk_i32"], **kw)),
    ]
    if big:
        out.append(("dataset left limit", lambda a, **kw: a.join(
            [p, other], dim, on="key", columns=["walk_i32", "cur"], how="left", limit=2060,
            **kw)))
    else:  # the reference compiles the refusal's walk at each shape
        out.append(("key dtypes differ", lambda a, **kw: a.join(p, dim32, on="key", **kw)))
    return out


# ---------------------------------------------------------------------------
# answers in host form (no JAX here: the two-rank children import this module)


class Raised:
    def __init__(self, exc):
        self.type = type(exc)

    def __repr__(self):
        return f"raised {self.type.__name__}"


def port_host_form(x):
    """A port answer with every tensor as a numpy array, through
    NullableColumn, StringColumn, dicts, lists and tuples."""
    if isinstance(x, tdev.NullableColumn):
        return {"valid": port_host_form(x.valid), "values": port_host_form(x.values)}
    if isinstance(x, ttab.StringColumn):
        return {"dictionary": np.asarray(x.dictionary), "codes": port_host_form(x.codes)}
    if isinstance(x, torch.Tensor):
        return x.numpy()
    if isinstance(x, dict):
        return {k: port_host_form(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(port_host_form(v) for v in x)
    return x


def port_run(call, **kw):
    try:
        return port_host_form(call(PORT, device="cpu", **kw))
    except Exception as exc:  # noqa: BLE001  (compared by type)
        return Raised(exc)


def concat_parts(parts):
    """The ranks' local parts of a read, in rank order, as one read: arrays
    concatenate along the first axis; a string column keeps its dictionary."""
    first = parts[0]
    if isinstance(first, Raised):
        return first
    if isinstance(first, np.ndarray):
        return np.concatenate(parts)
    if isinstance(first, dict):
        return {k: first[k] if k == "dictionary" else concat_parts([p[k] for p in parts])
                for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(concat_parts(list(vs)) for vs in zip(*parts))
    assert all(p == first for p in parts)  # a path of iter_files_device
    return first


CHILD = r"""
import pickle, sys
sys.path.insert(0, sys.argv[4])
import test_torch_mesh as t
from fastlanes_tpu_torch import parallel
import torch.distributed as dist

rank, store, root = int(sys.argv[1]), sys.argv[2], sys.argv[3]
parallel.setup_distributed("file://" + store, 2, rank, device="cpu")
mesh = parallel.make_mesh(device="cpu")
world = t.world_paths(root)
gathers = 0
real_gather = dist.all_gather_object


def counted_gather(*args, **kwargs):  # the collectives a call makes
    global gathers
    gathers += 1
    return real_gather(*args, **kwargs)


dist.all_gather_object = counted_gather
out, collectives = {}, {}
for n in t.ROWS:
    for e in t.ENTRIES:
        for label, call in t.calls(e, world[n], world):
            gathers = 0
            out[e, n, label] = t.port_run(call, mesh=mesh)
            collectives[e, n, label] = gathers
with open(f"{root}/rank{rank}.pkl", "wb") as f:
    pickle.dump((out, collectives), f)
dist.destroy_process_group()
"""


def _parity_form():
    """-> a map of this module's answers to the parity test's forms (its
    Raised class) for its `first_diff`."""
    import test_torch_parity as par

    def form(x):
        if isinstance(x, Raised):
            out = par.Raised.__new__(par.Raised)
            out.type = x.type
            return out
        return x

    return form


@pytest.fixture(scope="module")
def answers(tmp_path_factory):
    """The tables, the JAX package's answers with its 8-device mesh and the
    two ranks' answers, each computed once: the children run while the
    reference computes."""
    import jax  # noqa: F401  (tests/conftest.py has set up the CPU mesh)
    from fastlanes_tpu import analytics as jan
    from fastlanes_tpu import fio_device as jdev
    from fastlanes_tpu.parallel import make_mesh
    from test_torch_parity import Raised as par_raised
    from test_torch_parity import host_form

    def deep_host_form(x):  # the reference's answer, through dicts, lists and tuples
        if isinstance(x, dict):
            return {k: deep_host_form(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(deep_host_form(v) for v in x)
        return host_form(x)

    root = tmp_path_factory.mktemp("mesh")
    world = write_world(str(root))
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen(
        [sys.executable, "-c", CHILD, str(rank), str(root / "store"), str(root),
         os.path.join(ROOT, "tests")], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for rank in range(2)]
    try:
        ref_api = types.SimpleNamespace(**{e: getattr(jdev if e in READS else jan, e)
                                           for e in ENTRIES})
        jmesh = make_mesh(8)
        ref = {}
        for n in ROWS:
            for e in ENTRIES:
                for label, call in calls(e, world[n], world):
                    try:
                        ref[e, n, label] = deep_host_form(call(ref_api, mesh=jmesh))
                    except Exception as exc:  # noqa: BLE001  (compared by type)
                        ref[e, n, label] = par_raised(exc)
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0, 0], [err[-3000:] for _, err in outs]
    ranks, collectives = [], []
    for rank in range(2):
        with open(root / f"rank{rank}.pkl", "rb") as f:
            got, counts = pickle.load(f)
        ranks.append(got)
        collectives.append(counts)
    return {"world": world, "reference": ref, "ranks": ranks, "collectives": collectives}


@pytest.fixture(scope="module")
def mesh1():
    """A one-rank gloo group for this module only."""
    assert not dist.is_initialized()
    mesh = parallel.make_mesh(device="cpu")
    yield mesh
    dist.destroy_process_group()


@pytest.mark.parametrize("n", ROWS)
@pytest.mark.parametrize("entry", ENTRIES)
def test_mesh_answers_equal_the_reference(answers, mesh1, entry, n):
    """The JAX package with its mesh == the port without a mesh == the port
    on one rank == the two ranks (a read: their parts in rank order; an
    aggregation: each rank's answer)."""
    from test_torch_parity import first_diff

    bits = entry in READS
    parity_form = _parity_form()
    diffs = []
    for label, call in calls(entry, answers["world"][n], answers["world"]):
        want = answers["reference"][entry, n, label]
        ranks = [r[entry, n, label] for r in answers["ranks"]]
        got = {"no mesh": port_run(call), "one rank": port_run(call, mesh=mesh1)}
        if bits:
            got["two ranks"] = concat_parts(ranks)
        else:
            got.update({f"rank {r}": a for r, a in enumerate(ranks)})
        for how, g in got.items():
            d = first_diff(parity_form(g), want, bits)
            if d:
                diffs.append(f"{entry}({label}) on the {n}-row table, {how}{d}")
    assert not diffs, "\n".join(diffs[:10]) + f"\n({len(diffs)} differ)"


def test_a_device_that_disagrees_with_the_mesh_raises(answers, mesh1):
    p = answers["world"][2053]["path"]
    for device in ("cuda", "cuda:0", "meta"):
        with pytest.raises(ValueError, match="disagrees with the mesh"):
            tan.scan_column(p, "key", device=device, mesh=mesh1)
        with pytest.raises(ValueError, match="disagrees with the mesh"):
            tdev.read_column_device(p, "key", device=device, mesh=mesh1)
    assert tan.scan_column(p, "key", device="cpu", mesh=mesh1) == \
        tan.scan_column(p, "key", device="cpu")


@pytest.mark.parametrize("n", ROWS)
def test_each_rank_reads_and_decodes_only_its_chunks(answers, n):
    """Rank r of 2 touches the chunks [r*s, min((r+1)*s, C)), s = ceil(C / 2):
    the reads read only those from disk, and the chunk walk of the
    aggregations decodes only those, at their file-wide block positions."""
    t = answers["world"][n]
    header = tfio.read_header(t["files"]["walk_i32"])
    n_chunks = len(header["chunks"])
    s = -(-n_chunks // 2)
    seen = []
    for r in range(2):
        part = shard._Part(None, 2, r)
        want = list(range(min(r * s, n_chunks), min((r + 1) * s, n_chunks)))
        _h, idxs, raws, (first, end) = tdev._read_raw_file(t["files"]["walk_i32"], part)
        assert idxs == want and len(raws) == len(want)
        assert (first, end) == ((want[0], want[-1] + 1) if want else (header["n_blocks"],) * 2)
        walked = [valid for _b, _d, _v, valid, _m in tan._decoded_chunks(
            t["path"], "null_i32", "cpu", part=part)]
        rows = min(n, (want[-1] + 1) * 1024) - want[0] * 1024 if want else 0
        assert sum(walked) == rows and (walked != []) == bool(want)
        seen += walked
    assert sum(seen) == n


def test_ties_of_a_64_bit_key_across_a_cut_window(answers):
    """ORDER BY k64 DESC LIMIT 3000 over 17 chunks of keys in {0, 1, 2}: the
    3000 rows are all tied, and the reference takes them window by window,
    highest row first inside a window. Two ranks split the chunks 9 / 8, so
    rank 1 starts at chunk 9, inside the window of chunks 8-15. This fails
    when a rank's windows start at its range (rank 1's first window would
    run to chunk 16): its windows must lie on the file's grid, and the merge
    must order candidates by their file-wide window and row."""
    from test_torch_parity import first_diff

    label = "ties i64 desc"
    want = answers["reference"]["select", max(ROWS), label]
    assert not isinstance(want, Raised) and len(want["row"]) == 3000
    parity_form = _parity_form()
    for rank, got in enumerate(answers["ranks"]):
        d = first_diff(parity_form(got["select", max(ROWS), label]), want, False)
        assert not d, f"rank {rank}{d}"


@pytest.mark.parametrize("entry", ("select", "join"))
def test_a_row_query_makes_one_collective_on_every_rank(answers, mesh1, entry):
    """Every select and join call, the two-file ones included, meets the
    other rank exactly once (select's refusal of an unknown operator, raised
    on every rank from the header before the walk, not at all): counted on both ranks of two, and at one
    rank here."""
    real = dist.all_gather_object
    counts = []

    def counted(*args, **kwargs):
        counts.append(1)
        return real(*args, **kwargs)

    for n in ROWS:
        for label, call in calls(entry, answers["world"][n], answers["world"]):
            key = (entry, n, label)
            on_ranks = [c[key] for c in answers["collectives"]]
            before = answers["reference"][key]
            want = 0 if label == "unknown op" else 1
            assert on_ranks == [want, want], (key, on_ranks, before)
            counts.clear()
            dist.all_gather_object = counted
            try:
                port_run(call, mesh=mesh1)
            finally:
                dist.all_gather_object = real
            assert len(counts) == want, (key, len(counts))


def test_a_rank_without_chunks_meets_the_one_that_raised(answers):
    """The one-row table has one chunk: rank 0 walks it and meets the join's
    key-dtype refusal at its first window; rank 1 holds no chunk and raises
    nothing of its own. Neither hangs: both raise the refusal, as the
    reference and the port without a mesh do."""
    key = ("join", 1, "key dtypes differ")
    want = answers["reference"][key]
    assert want.type is ValueError
    assert [r[key].type if isinstance(r[key], Raised) else r[key]
            for r in answers["ranks"]] == [ValueError, ValueError]
    assert [c[key] for c in answers["collectives"]] == [1, 1]
