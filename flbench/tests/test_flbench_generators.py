"""The generators follow their sources' rules at a small scale."""

import numpy as np
import pytest
from conftest import SMALL

from flbench import dataset


def _lineitem(seed):
    config, gen = dataset.load_config("tpch-lineitem-sf1", SMALL["tpch-lineitem-sf1"])
    return config, gen, gen.draw(config, seed), gen.generate(config, seed)["lineitem"]


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 11, -5])
def test_lineitem_follows_clause_4_2_3(seed):
    config, _gen, d, cols = _lineitem(seed)
    n = cols["l_quantity"].size
    assert d["lines"].min() >= 1 and d["lines"].max() <= 7 and d["lines"].sum() == n
    assert d["lines"].size == config["orders"]
    assert cols["l_quantity"].dtype == np.uint8
    assert cols["l_quantity"].min() >= 1 and cols["l_quantity"].max() <= 50
    pk = d["partkey"]
    assert pk.min() >= 1 and pk.max() <= config["parts"]
    retail = 90000 + (pk // 10) % 20001 + 100 * (pk % 1000)
    assert np.array_equal(d["price_cents"], cols["l_quantity"].astype(np.int64) * retail)
    assert np.array_equal(cols["l_extendedprice"], d["price_cents"] / 100.0)
    for name, hi in (("l_discount", 10), ("l_tax", 8)):
        cents = np.rint(cols[name] * 100).astype(np.int64)
        assert cents.min() >= 0 and cents.max() <= hi
        assert np.array_equal(cols[name], cents / 100.0)
    gap = d["ship_day"] - d["order_day"]
    assert gap.min() >= 1 and gap.max() <= 121
    gap = d["receipt_day"] - d["ship_day"]
    assert gap.min() >= 1 and gap.max() <= 30
    assert d["order_day"].max() <= (np.datetime64("1998-08-02") - np.datetime64("1992-01-01")).astype(int)
    flags = cols["l_returnflag"].strings()
    received = d["receipt_day"] <= d["current_day"]
    assert set(flags[received]) <= {"R", "A"} and set(flags[~received]) == {"N"}
    assert {"R", "A"} <= set(flags[received])
    status = cols["l_linestatus"].strings()
    assert np.array_equal(status == "O", d["ship_day"] > d["current_day"])
    ship = cols["l_shipdate"]
    assert ship.dtype == np.dtype("datetime64[D]")
    assert np.array_equal(ship, d["first"] + d["ship_day"].astype("timedelta64[D]"))
    order_date = d["first"] + d["order_day"].astype("timedelta64[D]")
    gap = (cols["l_commitdate"] - order_date).astype(int)
    assert gap.min() >= 30 and gap.max() <= 90
    assert np.array_equal(cols["l_receiptdate"],
                          d["first"] + d["receipt_day"].astype("timedelta64[D]"))


@pytest.mark.parametrize("seed", [1, 2**31 + 13])
def test_lineitem_keys_and_text_follow_the_clause(seed):
    config, gen, d, cols = _lineitem(seed)
    assert len(cols) == 16 and list(cols) == list(config["columns"])
    n = cols["l_orderkey"].size
    # orders in key order, the first 8 keys of every 32, their lines numbered 1..k together
    keys = np.unique(cols["l_orderkey"])
    assert keys.size == config["orders"] and np.all(np.diff(cols["l_orderkey"]) >= 0)
    assert np.all((keys - 1) % 32 < 8)
    starts = np.flatnonzero(np.diff(cols["l_orderkey"], prepend=-1))
    assert np.all(cols["l_linenumber"][starts] == 1)
    assert np.array_equal(np.bincount(cols["l_linenumber"])[1:8] > 0, [True] * 7)
    s = config["suppliers"]
    pk = cols["l_partkey"].astype(np.int64)
    four = [(pk + i * (s // 4 + (pk - 1) // s)) % s + 1 for i in range(4)]
    assert np.all(np.any([cols["l_suppkey"] == f for f in four], axis=0))
    assert cols["l_suppkey"].min() >= 1 and cols["l_suppkey"].max() <= s
    assert set(cols["l_shipinstruct"].strings()) == set(config["instructions"])
    assert set(cols["l_shipmode"].strings()) == set(config["modes"])
    text = cols["l_comment"]
    lengths = np.char.str_len(text)
    assert text.size == n and lengths.min() >= 10 and lengths.max() <= 43
    pool = d["pool"].tobytes().decode("ascii")
    assert all(t in pool for t in text[:200].tolist())
    assert np.unique(text).size > 0.9 * n
    words = set(pool.replace(",", " ").split())
    assert {"the", "foxes", "sleep"} <= words


def test_lineitem_seeds():
    a = _lineitem(3)[3]
    b = _lineitem(3)[3]
    c = _lineitem(4)[3]
    assert np.array_equal(a["l_extendedprice"], b["l_extendedprice"])
    assert not np.array_equal(a["l_extendedprice"][:100], c["l_extendedprice"][:100])


def test_every_run_writes_its_seed_anew(tmp_path):
    over = SMALL["tpch-lineitem-sf1"]
    a = dataset.build("tpch-lineitem-sf1", 5, over, str(tmp_path))
    first = open(a.paths()[0], "rb").read()
    b = dataset.build("tpch-lineitem-sf1", 6, over, str(tmp_path))
    assert a.paths() == b.paths() and open(b.paths()[0], "rb").read() != first
    assert sorted(p.name for p in (tmp_path / "tpch-lineitem-sf1").iterdir()) == ["lineitem.flt"]
    header = b.header(b.paths()[0])
    assert list(header["columns"]) == list(b.config["columns"])
