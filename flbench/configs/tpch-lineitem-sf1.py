"""TPC-H LINEITEM, all sixteen columns, generated by the rules of clause
4.2.3 of the TPC-H specification (v3.0.1) and written as one FLT table with
the program's `write_table`.

Per order (key order; the first 8 keys of every 32 are used): O_ORDERDATE
uniform in [1992-01-01, 1998-08-02] and 1 to 7 lines, numbered from 1.
Per line: L_PARTKEY uniform 1..SF*200000; L_SUPPKEY = (partkey + i * (S/4 +
(partkey - 1) / S)) mod S + 1 for i uniform 0..3 and S = SF*10000;
L_QUANTITY uniform 1..50; L_EXTENDEDPRICE = L_QUANTITY *
P_RETAILPRICE(L_PARTKEY), where P_RETAILPRICE = (90000 + ((partkey / 10)
mod 20001) + 100 * (partkey mod 1000)) / 100; L_DISCOUNT uniform 0.00..0.10
and L_TAX uniform 0.00..0.08 in steps of 0.01; L_SHIPDATE = O_ORDERDATE +
1..121 days, L_COMMITDATE = O_ORDERDATE + 30..90 days and L_RECEIPTDATE =
L_SHIPDATE + 1..30 days; L_RETURNFLAG R or A at random where L_RECEIPTDATE
<= CURRENTDATE (1995-06-17), else N; L_LINESTATUS O where L_SHIPDATE >
CURRENTDATE, else F; L_SHIPINSTRUCT and L_SHIPMODE uniform over their
lists; L_COMMENT a substring of 10..43 characters of a text pool made by the
grammar of clause 4.2.2.10. Decimals are the doubles nearest cents / 100.
"""

import os

import numpy as np

from flbench.dataset import Categorical, rng_of

VERSION = 2
TABLE = "lineitem.flt"
#: the overrides that cut this configuration to a size a CPU test holds
#: (flbench/tests): several chunks a column and several lockstep windows
SMALL = {"orders": 6000, "parts": 20000, "suppliers": 1000, "text_pool_bytes": 1 << 16,
         "file": {"writer": "fio_table.write_table", "codec": "auto", "chunk_blocks": 1}}

NOUNS = ("foxes ideas theodolites pinto_beans instructions dependencies excuses platelets "
         "asymptotes courts dolphins multipliers sauternes warthogs frets dinos attainments "
         "somas Tiresias' patterns forges braids hockey_players frays warhorses dugouts "
         "notornis epitaphs pearls tithes waters orbits gifts sheaves depths sentiments "
         "decoys realms pains grouches escapades").split()
VERBS = ("sleep wake are cajole haggle nag use boost affix detect integrate maintain nod was "
         "lose sublate solve thrash promise engage hinder print x-ray breach eat grow impress "
         "mold poach serve run dazzle snooze doze unwind kindle play hang believe doubt").split()
ADJECTIVES = ("furious sly careful blithe quick fluffy slow quiet ruthless thin close dogged "
              "daring brave stealthy permanent enticing idle busy regular final ironic even "
              "bold silent").split()
ADVERBS = ("sometimes always never furiously slyly carefully blithely quickly fluffily slowly "
           "quietly ruthlessly thinly closely doggedly daringly bravely stealthily "
           "permanently enticingly idly busily regularly finally ironically evenly boldly "
           "silently").split()
PREPOSITIONS = ("about above according_to across after against along alongside_of among "
                "around at atop before behind beneath beside besides between beyond by "
                "despite during except for from in_place_of inside instead_of into near of "
                "on outside over past since through throughout to toward under until up "
                "upon without with within").split()
AUXILIARIES = ("do may might shall will would can could should ought_to must will_have_to "
               "shall_have_to could_have_to should_have_to must_have_to need_to "
               "try_to").split()
TERMINATORS = (".", ";", ":", "?", "!", "--")


def _day(text: str) -> np.datetime64:
    return np.datetime64(text, "D")


class _Draws:
    """Uniform choices from a list, taken one after another from a block of
    random integers drawn at once."""

    def __init__(self, rng, n: int):
        self.ints = iter(rng.integers(0, 1 << 30, n, dtype=np.int64).tolist())

    def form(self, k: int) -> int:
        return next(self.ints) % k

    def pick(self, words) -> str:
        return words[next(self.ints) % len(words)].replace("_", " ")


def _noun_phrase(d: _Draws) -> str:
    form = d.form(4)
    noun = d.pick(NOUNS)
    if form == 0:
        return noun
    if form == 1:
        return f"{d.pick(ADJECTIVES)} {noun}"
    if form == 2:
        return f"{d.pick(ADJECTIVES)}, {d.pick(ADJECTIVES)} {noun}"
    return f"{d.pick(ADVERBS)} {d.pick(ADJECTIVES)} {noun}"


def _verb_phrase(d: _Draws) -> str:
    form = d.form(4)
    verb = d.pick(VERBS)
    aux = d.pick(AUXILIARIES) + " " if form in (1, 3) else ""
    adverb = " " + d.pick(ADVERBS) if form in (2, 3) else ""
    return aux + verb + adverb


def _prepositional_phrase(d: _Draws) -> str:
    return f"{d.pick(PREPOSITIONS)} the {_noun_phrase(d)}"


SENTENCES = ((_noun_phrase, _verb_phrase),
             (_noun_phrase, _verb_phrase, _prepositional_phrase),
             (_noun_phrase, _verb_phrase, _noun_phrase),
             (_noun_phrase, _prepositional_phrase, _verb_phrase, _noun_phrase),
             (_noun_phrase, _prepositional_phrase, _verb_phrase, _prepositional_phrase))


def text_pool(nbytes: int, rng) -> np.ndarray:
    """The pool of clause 4.2.2.10: sentences of the grammar, one space
    apart, as `nbytes` bytes."""
    d = _Draws(rng, nbytes)  # far more than a sentence a few bytes takes
    out, size = [], 0
    while size < nbytes:
        s = " ".join(p(d) for p in SENTENCES[d.form(len(SENTENCES))]) + d.pick(TERMINATORS)
        out.append(s)
        size += len(s) + 1
    return np.frombuffer(" ".join(out).encode("ascii")[:nbytes], dtype=np.uint8)


def comments(pool: np.ndarray, n: int, lo: int, hi: int, rng) -> np.ndarray:
    """n substrings of the pool, of lengths uniform in [lo, hi] at uniform
    offsets, as a fixed-width unicode array."""
    length = rng.integers(lo, hi + 1, n, dtype=np.int32)
    offset = (rng.random(n) * (pool.size - length + 1)).astype(np.int32)
    padded = np.concatenate([pool, np.zeros(hi, dtype=np.uint8)])
    cols = np.arange(hi, dtype=np.int32)
    out = np.empty((n, hi), dtype=np.uint8)
    for a in range(0, n, 1 << 20):
        b = min(n, a + (1 << 20))
        out[a:b] = padded[offset[a:b, None] + cols]
        out[a:b] *= cols < length[a:b, None]
    return out.view("S%d" % hi).ravel().astype("U%d" % hi)


def draw(config: dict, seed: int) -> dict:
    """Every field the clause draws, the ones that are not stored (order
    date, lines per order) included, as day offsets from the first order
    date and cents."""
    rng = rng_of(seed, 0)
    first, last = (_day(d) for d in config["orderdate"])
    span = int((last - first) / np.timedelta64(1, "D"))
    n_orders = config["orders"]
    lo, hi = config["lines_per_order"]
    lines = rng.integers(lo, hi + 1, n_orders, dtype=np.int64)
    order_day = np.repeat(rng.integers(0, span + 1, n_orders, dtype=np.int32), lines)
    n = order_day.size
    order = np.arange(n_orders, dtype=np.int64)
    used = config["orderkeys_used_of_32"]
    orderkey = np.repeat((order // used) * 32 + order % used + 1, lines)
    starts = np.repeat(np.cumsum(lines) - lines, lines)
    linenumber = (np.arange(n, dtype=np.int64) - starts + 1).astype(np.uint8)

    partkey = rng.integers(1, config["parts"] + 1, n, dtype=np.int64)
    s = config["suppliers"]
    supplier = rng.integers(0, 4, n, dtype=np.int64)
    suppkey = (partkey + supplier * (s // 4 + (partkey - 1) // s)) % s + 1
    retail_cents = 90000 + (partkey // 10) % 20001 + 100 * (partkey % 1000)
    quantity = rng.integers(config["quantity"][0], config["quantity"][1] + 1, n, dtype=np.uint8)
    price_cents = quantity.astype(np.int64) * retail_cents
    discount = rng.integers(config["discount_cents"][0], config["discount_cents"][1] + 1, n)
    tax = rng.integers(config["tax_cents"][0], config["tax_cents"][1] + 1, n)

    a, b = config["ship_after_order_days"]
    ship_day = order_day + rng.integers(a, b + 1, n, dtype=np.int32)
    a, b = config["commit_after_order_days"]
    commit_day = order_day + rng.integers(a, b + 1, n, dtype=np.int32)
    a, b = config["receipt_after_ship_days"]
    receipt_day = ship_day + rng.integers(a, b + 1, n, dtype=np.int32)
    current = int((_day(config["currentdate"]) - first) / np.timedelta64(1, "D"))

    # returnflag labels sorted: A, N, R; linestatus: F, O
    received = rng.integers(0, 2, n, dtype=np.int64)
    flag = np.where(receipt_day <= current, np.where(received == 1, 2, 0), 1)
    status = (ship_day > current).astype(np.int64)
    instruct = rng.integers(0, len(config["instructions"]), n, dtype=np.int64)
    mode = rng.integers(0, len(config["modes"]), n, dtype=np.int64)
    lo, hi = config["comment_length"]
    pool = text_pool(config["text_pool_bytes"], rng)
    comment = comments(pool, n, lo, hi, rng)
    return {"first": first, "current_day": current, "lines": lines, "order_day": order_day,
            "orderkey": orderkey, "linenumber": linenumber, "partkey": partkey,
            "suppkey": suppkey, "supplier": supplier, "quantity": quantity,
            "price_cents": price_cents, "discount_cents": discount, "tax_cents": tax,
            "ship_day": ship_day, "commit_day": commit_day, "receipt_day": receipt_day,
            "flag": flag, "status": status, "instruct": instruct, "mode": mode,
            "pool": pool, "comment": comment}


def _categorical(codes: np.ndarray, words) -> Categorical:
    """Codes into `words` as codes into the sorted labels."""
    order = np.argsort(np.asarray(words))
    rank = np.empty(len(words), dtype=np.int64)
    rank[order] = np.arange(len(words))
    return Categorical(rank[codes], np.asarray(words)[order])


def generate(config: dict, seed: int) -> dict:
    d = draw(config, seed)
    days = lambda k: d["first"] + d[k].astype("timedelta64[D]")  # noqa: E731
    return {"lineitem": {
        "l_orderkey": d["orderkey"].astype(np.int32),
        "l_partkey": d["partkey"].astype(np.int32),
        "l_suppkey": d["suppkey"].astype(np.int32),
        "l_linenumber": d["linenumber"],
        "l_quantity": d["quantity"],
        "l_extendedprice": d["price_cents"].astype(np.float64) / 100.0,
        "l_discount": d["discount_cents"].astype(np.float64) / 100.0,
        "l_tax": d["tax_cents"].astype(np.float64) / 100.0,
        "l_returnflag": Categorical(d["flag"], np.array(["A", "N", "R"])),
        "l_linestatus": Categorical(d["status"], np.array(["F", "O"])),
        "l_shipdate": days("ship_day"),
        "l_commitdate": days("commit_day"),
        "l_receiptdate": days("receipt_day"),
        "l_shipinstruct": _categorical(d["instruct"], config["instructions"]),
        "l_shipmode": _categorical(d["mode"], config["modes"]),
        "l_comment": d["comment"],
    }}


def write(config: dict, data: dict, out_dir: str) -> dict:
    from fastlanes_tpu_torch import fio_table

    cols = data["lineitem"]
    order = list(config["columns"])
    table = {name: (cols[name].strings() if isinstance(cols[name], Categorical) else cols[name])
             for name in order}
    spec = config["file"]
    fio_table.write_table(os.path.join(out_dir, TABLE), table, codec=spec["codec"],
                          chunk_blocks=spec["chunk_blocks"])
    return {"lineitem": {"path": TABLE, "rows": int(len(cols["l_quantity"]))}}
