#!/usr/bin/env python
"""Tour of the SQL-ish query surface over compressed FLT tables on the
PyTorch/CUDA port — the counterpart of examples/query_tour.py.

Covers the full column model — ints, floats, strings (sorted-dictionary),
bools, timestamps, NULLS — written by the streaming TableWriter across a
sharded 3-file dataset, then queried without ever materializing the
decoded columns on the host: scans, WHERE pushdown (single / multi
predicate / string probes), GROUP BY, distinct / value_counts / top_k, and
SELECT ... WHERE ... ORDER BY ... LIMIT.

Run: python examples/torch_query_tour.py [--on {cuda,cpu}] [rows_per_shard]

`--on cuda` (the default) needs a CUDA device and raises RuntimeError without
one; `--on cpu` runs the plain PyTorch versions of the kernels on the host.
Default size: 50 000 rows per shard.
"""

import argparse
import os
import shutil
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from fastlanes_tpu_torch import analytics, fio_table  # noqa: E402


def device_of(on: str) -> torch.device:
    """The device `--on` names; the card only if there is one."""
    if on == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("this example runs on a CUDA device by default and "
                           "torch.cuda.is_available() is false; pass --on cpu")
    return torch.device(on)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--on", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("rows_per_shard", nargs="?", type=int, default=50_000)
    args = p.parse_args(argv)
    dev = device_of(args.on)
    n = args.rows_per_shard
    rng = np.random.default_rng(0)
    cats = np.array(["EUR", "GBP", "JPY", "USD"])

    tmp = tempfile.mkdtemp()
    try:
        paths, all_qty, all_cur, all_price = [], [], [], []
        for shard in range(3):
            qty = rng.integers(0, 1000, n).astype(np.uint32)
            cur = cats[rng.integers(0, 4, n)]
            price = np.round(rng.normal(100.0, 15.0, n), 2)
            pmask = rng.random(n) < 0.05  # 5% missing prices
            ts = (np.datetime64("2026-08-18", "ns")
                  + np.sort(rng.integers(0, 86_400_000, n))
                  .astype("timedelta64[ms]").astype("timedelta64[ns]"))
            path = f"{tmp}/shard{shard}.flt"
            # streaming writer: batches spill chunk-by-chunk (O(chunk) memory)
            with fio_table.TableWriter(path) as w:
                for at in range(0, n, 16_384):
                    sl = slice(at, at + 16_384)
                    w.append({"qty": qty[sl], "cur": cur[sl],
                              "price": np.ma.MaskedArray(price, mask=pmask)[sl],
                              "ts": ts[sl], "paid": (qty[sl] > 0)})
            paths.append(path)
            all_qty.append(qty)
            all_cur.append(cur)
            all_price.append(np.ma.MaskedArray(price, mask=pmask))
        qty = np.concatenate(all_qty)
        cur = np.concatenate(all_cur)
        price = np.ma.concatenate(all_price)
        answers = query(paths, n, qty, cur, price, dev)
    finally:
        shutil.rmtree(tmp)
    return answers


def query(paths, n, qty, cur, price, dev) -> dict:
    """The tour's queries over the dataset `paths`, each held to numpy on the
    concatenated columns; returns the answers."""
    # 1) dataset scan: one shared accumulator across shards (exact sums)
    s = analytics.scan_table(paths, device=dev)
    assert s["qty"]["sum"] == int(qty.sum())
    assert s["price"]["n_null"] == int(np.ma.getmaskarray(price).sum())
    print(f"scan_table over {len(paths)} shards x {n} rows: "
          f"qty sum={s['qty']['sum']}, price nulls={s['price']['n_null']}")

    # 2) WHERE pushdown, string probe translated to dictionary codes
    eur = analytics.scan_where(paths, "eq", "EUR", column="qty", where="cur", device=dev)
    mask = cur == "EUR"
    assert eur["sum"] == int(qty[mask].sum())
    print(f"WHERE cur = 'EUR': {eur['count']} rows, qty sum {eur['sum']}")

    # 3) multi-predicate WHERE
    hot = analytics.scan_where_multi(
        paths, [("cur", "ne", "JPY"), ("qty", "gt", 900)], column="qty", device=dev)
    m2 = (cur != "JPY") & (qty > 900)
    assert hot["count"] == int(m2.sum())
    print(f"WHERE cur != 'JPY' AND qty > 900: {hot['count']} rows")

    # 4) GROUP BY a string key (device scatter-reduce per shard)
    per_cur = analytics.group_stats(paths, "cur", "qty", device=dev)
    assert per_cur["USD"]["sum"] == int(qty[cur == "USD"].sum())
    group_sums = {g: r["sum"] for g, r in sorted(per_cur.items())}
    print("GROUP BY cur:", group_sums)

    # 4b) GROUP BY ... WHERE: predicates filter rows before grouping
    big = analytics.group_stats(paths, "cur", "qty",
                                preds=[("qty", "gt", 900)], device=dev)
    mb = qty > 900
    assert big["USD"]["count"] == int((mb & (cur == "USD")).sum())
    big_counts = {g: r["count"] for g, r in sorted(big.items())}
    print("GROUP BY cur WHERE qty>900:", big_counts)

    # 5) distinct / value_counts / top_k
    distinct = [str(v) for v in analytics.distinct(paths, "cur")]
    assert distinct == sorted(set(cur))
    vc = analytics.value_counts(paths, "cur", device=dev)
    assert vc["GBP"] == int((cur == "GBP").sum())
    top = analytics.top_k(paths, "price", k=3, device=dev)
    print(f"value_counts(cur)={vc}; top-3 prices={top}")

    # 6) SELECT ... WHERE ... ORDER BY ... LIMIT (per-shard device top-k)
    rows = analytics.select(paths, columns=["qty", "cur", "price"],
                            preds=[("cur", "eq", "GBP")],
                            order_by="price", desc=True, limit=5, device=dev)
    sel = ~np.ma.getmaskarray(price)
    m3 = (cur == "GBP") & sel
    want = np.sort(np.ma.getdata(price)[m3])[::-1][:5]
    got = np.asarray(np.ma.getdata(rows["price"]))
    assert np.allclose(got, want)
    print("SELECT qty,cur,price WHERE cur='GBP' ORDER BY price DESC LIMIT 5:")
    selected = []
    for q, c, pr in zip(rows["qty"], rows["cur"], got):
        print(f"  qty={int(q):4d} cur={c} price={pr:.2f}")
        selected.append((int(q), str(c), float(pr)))
    return {"rows_per_shard": n, "shards": len(paths), "qty_sum": s["qty"]["sum"],
            "price_nulls": s["price"]["n_null"], "eur": eur, "hot_count": hot["count"],
            "group_sums": group_sums, "group_counts_qty_gt_900": big_counts,
            "distinct": distinct, "value_counts": vc, "top3": list(top),
            "select": selected}


if __name__ == "__main__":
    main()
