"""The port's `join` on the CPU (`device="cpu"`) against the JAX package's on
the CPU: the same seeded tables through both, and the returned dicts of numpy
arrays are EQUAL (same_rows of test_torch_select.py: column order, masked or
not, dtypes, values, masks). The cases are those of tests/test_join.py and
the join cases of tests/test_review_fixes_r3.py (an empty right table,
logical dtypes), plus string keys over two left files, each with its own
dictionary, against right labels that no left file holds. Where the
reference raises, the port raises the same exception."""

import numpy as np
import pytest
import torch

from fastlanes_tpu import analytics as jan

from fastlanes_tpu_torch import analytics as tan
from fastlanes_tpu_torch import fio_table as ttab

from test_torch_select import same_rows


@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    """name -> path of every table the cases join."""
    rng = np.random.default_rng(0x701)
    root = tmp_path_factory.mktemp("join")
    paths = {}

    def write(name, cols, **kw):
        paths[name] = str(root / f"{name}.flt")
        ttab.write_table(paths[name], cols, **kw)

    n = 4000
    cid = rng.integers(0, 50, n).astype(np.uint32) * 3  # multiples of 3 only
    write("fact", {"cid": cid, "qty": rng.integers(0, 100, n).astype(np.uint32),
                   "day": (np.datetime64("2020-01-01") + rng.integers(0, 900, n)).astype(
                       "datetime64[D]"),
                   "flag": rng.random(n) < 0.5}, chunk_blocks=1)
    write("dim", {"cid": (np.arange(40, dtype=np.uint32) * 3)[::-1].copy(),  # unsorted
                  "rate": np.round(rng.normal(1.0, 0.1, 40), 4),
                  "name": np.array([f"c{i:02d}" for i in range(40)]),
                  "big": rng.integers(0, 1 << 64, 40, dtype=np.uint64),
                  "tier": np.ma.MaskedArray(rng.integers(0, 5, 40).astype(np.int16),
                                            mask=rng.random(40) < 0.3)})
    labels = np.array(["EUR", "GBP", "JPY", "XXX"])
    write("cur_fact", {"cur": labels[rng.integers(0, 4, 3000)],
                       "qty": rng.integers(0, 100, 3000).astype(np.uint32)})
    write("cur_dim", {"cur": np.array(["GBP", "EUR", "JPY", "USD"]),
                      "sym": np.array(["£", "€", "¥", "$"])})
    k = rng.integers(0, 10, 2000).astype(np.uint16)
    write("null_fact", {"k": np.ma.MaskedArray(k, mask=rng.random(2000) < 0.3),
                        "v": rng.integers(0, 9, 2000).astype(np.uint8)})
    write("k_dim", {"k": np.arange(10, dtype=np.uint16),
                    "name": np.array([f"g{i}" for i in range(10)])})
    write("v_dim", {"k": np.arange(5, dtype=np.uint16),
                    "v": np.arange(5, dtype=np.uint32) * 100})
    for i in range(2):
        write(f"shard{i}", {"k": rng.integers(0, 5, 1500).astype(np.uint16),
                            "v": rng.integers(0, 9, 1500).astype(np.uint32)})
    # string keys over two left files: each owns a dictionary, and the right
    # side has labels that neither left file holds
    write("left_a", {"cur": np.array(["AUD", "EUR", "GBP"])[rng.integers(0, 3, 2500)],
                     "qty": rng.integers(0, 50, 2500).astype(np.uint32)}, chunk_blocks=1)
    write("left_b", {"cur": np.array(["CHF", "EUR", "JPY", "NOK"])[rng.integers(0, 4, 1800)],
                     "qty": rng.integers(0, 50, 1800).astype(np.uint32)}, chunk_blocks=1)
    write("rates", {"cur": np.array(["ZAR", "JPY", "EUR", "CHF", "BRL"]),
                    "rate": np.array([0.05, 0.006, 1.0, 1.05, 0.18]),
                    "zone": np.array([3, 2, 1, 1, 4], np.uint8)})
    write("empty_dim", {"k": np.empty(0, np.uint16), "x": np.empty(0, np.uint32)})
    m = 2000
    write("logical", {"flags": rng.random(m) < 0.4,
                      "ts": np.datetime64("2026-01-01", "ns")
                      + rng.integers(0, 10**9, m).astype("timedelta64[ns]"),
                      "k": rng.integers(0, 3, m).astype(np.uint8)})
    write("active_dim", {"k": np.arange(3, dtype=np.uint8),
                         "active": np.array([True, False, True])})
    return paths


# (left, right, on, keyword arguments)
JOINS = {
    "inner_int_key": ("fact", "dim", "cid", {}),
    "left_masks_unmatched": ("fact", "dim", "cid", {"how": "left"}),
    "preds_and_limit": ("fact", "dim", "cid", {"columns": ["qty"],
                                                "preds": [("qty", "gt", 50)], "limit": 9}),
    "left_preds_projection": ("fact", "dim", "cid", {
        "how": "left", "columns": ["qty", "day"], "right_columns": ["name", "tier"],
        "preds": [("day", "ge", np.datetime64("2021-01-01"))]}),
    "left_limit_second_window": ("fact", "dim", "cid", {"how": "left", "limit": 3000}),
    "string_key": ("cur_fact", "cur_dim", "cur", {}),
    "string_key_left": ("cur_fact", "cur_dim", "cur", {"how": "left", "columns": ["qty"]}),
    "null_keys_inner": ("null_fact", "k_dim", "k", {}),
    "null_keys_left": ("null_fact", "k_dim", "k", {"how": "left", "columns": ["v"]}),
    "name_collision_sharded": (["shard0", "shard1"], "v_dim", "k", {}),
    "sharded_limit": (["shard0", "shard1"], "v_dim", "k", {"limit": 2000}),
    "string_two_files_inner": (["left_a", "left_b"], "rates", "cur", {}),
    "string_two_files_left": (["left_a", "left_b"], "rates", "cur", {"how": "left"}),
    "string_two_files_left_where": (["left_a", "left_b"], "rates", "cur", {
        "how": "left", "preds": [("qty", "lt", 20), ("cur", "ne", "EUR")]}),
    "string_two_files_limit": (["left_a", "left_b"], "rates", "cur", {"limit": 2600}),
    "empty_right_left": ("null_fact", "empty_dim", "k", {"how": "left"}),
    "empty_right_inner": ("null_fact", "empty_dim", "k", {"how": "inner"}),
    "logical_dtypes": ("logical", "active_dim", "k", {"columns": ["flags", "ts"]}),
    "logical_dtypes_left": ("logical", "active_dim", "k", {"how": "left",
                                                           "preds": [("flags", "eq", 1)]}),
}


def _paths(tables, names):
    return [tables[n] for n in names] if isinstance(names, list) else tables[names]


@pytest.mark.parametrize("name", list(JOINS))
def test_join_equals_the_reference(tables, name):
    left, right, on, kw = JOINS[name]
    lp, rp = _paths(tables, left), tables[right]
    same_rows(tan.join(lp, rp, on, device="cpu", **kw), jan.join(lp, rp, on, **kw))


def test_join_values_are_the_tables(tables):
    """Beside the reference: a left join over two files with their own
    dictionaries, against a lookup written here."""
    lp = [tables["left_a"], tables["left_b"]]
    rows = tan.join(lp, tables["rates"], "cur", how="left", device="cpu")
    cur = np.concatenate([ttab.read_column(p, "cur") for p in lp])
    rate = {"EUR": 1.0, "JPY": 0.006, "CHF": 1.05}
    assert rows["cur"].tolist() == cur.tolist()
    assert np.ma.getmaskarray(rows["rate"]).tolist() == [c not in rate for c in cur]
    assert [rate[c] for c in cur if c in rate] == \
        np.ma.getdata(rows["rate"])[~np.ma.getmaskarray(rows["rate"])].tolist()
    # every key matched: a left join gives plain (unmasked) arrays
    full = tan.join(tables["cur_fact"], tables["cur_dim"], "cur", how="left", device="cpu",
                    preds=[("cur", "ne", "XXX")])
    assert type(full["sym"]) is np.ndarray


def test_errors_are_the_reference_errors(tmp_path, tables):
    lpath = str(tmp_path / "f.flt")
    ttab.write_table(lpath, {"k": np.arange(1200, dtype=np.uint16),
                             "k64": np.arange(1200, dtype=np.uint64),
                             "s": np.array(["a", "b"])[np.arange(1200) % 2]})
    dup = str(tmp_path / "dup.flt")
    ttab.write_table(dup, {"k": np.array([1, 1, 2], np.uint16), "x": np.arange(3, dtype=np.uint8)})
    wide = str(tmp_path / "wide.flt")
    ttab.write_table(wide, {"k": np.array([1, 2], np.uint32), "x": np.arange(2, dtype=np.uint8),
                            "k64": np.array([1, 2], np.uint64)})
    strs = str(tmp_path / "strs.flt")
    ttab.write_table(strs, {"k": np.array(["a", "b"]), "s": np.array(["a", "c"]),
                            "x": np.arange(2, dtype=np.uint8)})
    nulls = str(tmp_path / "nulls.flt")
    ttab.write_table(nulls, {"k": np.ma.MaskedArray(np.array([1, 2], np.uint16),
                                                    mask=[False, True])})
    cases = [((lpath, dup, "k"), {}, "duplicates"),
             ((lpath, wide, "k"), {}, "dtypes differ"),
             ((lpath, wide, "k"), {"how": "outer"}, "inner.*left|how"),
             ((lpath, wide, "k64"), {}, "integers <= 32 bits"),
             ((lpath, strs, "k"), {}, "not a string column"),
             ((lpath, nulls, "k"), {}, "must not contain nulls")]
    for args, kw, match in cases:
        for mod, dev in ((tan, {"device": "cpu"}), (jan, {})):
            with pytest.raises(ValueError, match=match):
                mod.join(*args, **kw, **dev)
    # a right string key against a left string key of another file: fine
    same_rows(tan.join(lpath, strs, "s", device="cpu"), jan.join(lpath, strs, "s"))


def test_join_refuses_to_run_without_a_gpu(tables):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="cuda"):
        tan.join(tables["fact"], tables["dim"], "cid")
