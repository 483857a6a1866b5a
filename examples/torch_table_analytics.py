#!/usr/bin/env python
"""Analytics over a compressed table file, decoded and aggregated on the card
by the PyTorch/CUDA port — the counterpart of examples/table_analytics.py.

The full pipeline: a multi-column FLTTAB file on disk -> only the compressed
bytes cross host memory/PCIe -> the device decodes each chunk with one
kernel and aggregates. Query: total quantity and order count for one
customer, over columns stored at ~4-14 bits/value. The decode is driven by
hand from the raw chunk bytes; the `analytics` one-liners that follow run
the same query (and GROUP BYs) without the plumbing.

Run: python examples/torch_table_analytics.py [--on {cuda,cpu}] [n_rows]

`--on cuda` (the default) needs a CUDA device and raises RuntimeError without
one; `--on cpu` runs the plain PyTorch versions of the kernels on the host.
Default size: 8 000 000 rows on the card, 200 000 on the host.
"""

import argparse
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from fastlanes_tpu_torch import (  # noqa: E402
    analytics, fio, fio_device, fio_table, kernels)
from fastlanes_tpu_torch.core import layout  # noqa: E402


def device_of(on: str) -> torch.device:
    """The device `--on` names; the card only if there is one."""
    if on == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("this example runs on a CUDA device by default and "
                           "torch.cuda.is_available() is false; pass --on cpu")
    return torch.device(on)


def card_name() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def load_column_chunks(path, name, device):
    """Ship one column's compressed chunks to the device. Returns a list of
    (meta, tensors): meta is the chunk's (codec, width, dtype, reference),
    tensors its packed words (and per-block delta base) on `device`."""
    header = fio_table.read_table_header(path)
    col = header["columns"][name]
    base_off = fio.payload_base_of(path, fio_table.MAGIC)
    dtype = col["dtype"]
    np_dt = layout.np_dtype(dtype)
    nl = layout.lanes(dtype)
    chunks = []
    with open(path, "rb") as f:
        for meta in col["chunks"]:
            f.seek(base_off + meta["offset"])
            raw = bytearray(f.read(meta["nbytes"]))
            nb = meta["n_blocks"]
            plen = layout.packed_len(dtype, meta["width"])
            tensors = {}
            if meta["codec"] in ("delta", "zdelta"):
                bb = nb * nl * np_dt.itemsize
                tensors["base"] = torch.from_numpy(
                    np.frombuffer(raw, np_dt, nb * nl).reshape(nb, nl)).to(device)
                raw = raw[bb:]
            tensors["packed"] = torch.from_numpy(
                np.frombuffer(raw, np_dt, nb * plen).reshape(nb, plen)).to(device)
            chunks.append(({"codec": meta["codec"], "width": meta["width"],
                            "dtype": dtype, "reference": meta.get("reference")}, tensors))
    return chunks


def decode_chunk(meta, tensors):
    """Decode one chunk in ORIGINAL order with one kernel: delta / zdelta
    chunks (stored transposed) through the fused original-order decode."""
    codec, w, dt = meta["codec"], meta["width"], meta["dtype"]
    if codec == "zdelta":
        return kernels.unzdelta_pack_orig(tensors["packed"], tensors["base"], w, dt)
    if codec == "delta":
        return kernels.undelta_pack_orig(tensors["packed"], tensors["base"], w, dt)
    if codec == "ffor":
        return kernels.unfor_pack(tensors["packed"], meta["reference"], w, dt)
    return kernels.unpack(tensors["packed"], w, dt)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--on", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("n_rows", nargs="?", type=int)
    args = p.parse_args(argv)
    dev = device_of(args.on)
    on_card = dev.type == "cuda"
    n = args.n_rows or (8_000_000 if on_card else 200_000)

    rng = np.random.default_rng(0)
    customer = rng.integers(0, 10_000, n, np.int64).astype(np.uint32)
    qty = rng.integers(1, 30, n, np.int64).astype(np.uint32)
    target = 4242
    # pad rows count to full blocks so padded tail values (repeats of the
    # final customer id) can't alias the target
    assert customer[-1] != target

    with tempfile.NamedTemporaryFile(suffix=".flt") as f:
        fio_table.write_table(f.name, {"customer": customer, "qty": qty})
        raw_mb = (customer.nbytes + qty.nbytes) / 2**20
        file_mb = os.path.getsize(f.name) / 2**20
        # correctness: the library device reader (handles any transform)
        dev_customer = fio_device.read_column_device(f.name, "customer", device=dev)
        assert np.array_equal(dev_customer.cpu().numpy(), customer)
        del dev_customer
        cchunks = load_column_chunks(f.name, "customer", dev)
        qchunks = load_column_chunks(f.name, "qty", dev)

    def query():
        hits = torch.zeros((), dtype=torch.int64, device=dev)
        total = torch.zeros((), dtype=torch.int64, device=dev)
        for (cm, ct), (qm, qt) in zip(cchunks, qchunks):
            # values below 2^31: the int32 views are the values
            c = decode_chunk(cm, ct).reshape(-1).view(torch.int32)
            q = decode_chunk(qm, qt).reshape(-1).view(torch.int32)
            m = c == target
            hits += m.sum(dtype=torch.int64)
            total += (q * m).sum(dtype=torch.int64)
        return hits, total

    hits, total = (int(x) for x in query())
    mask = customer == target
    assert hits == int(mask.sum()), (hits, int(mask.sum()))
    assert total == int(qty[mask].sum())
    times = []  # seconds of each of 5 runs; the median is reported
    for _ in range(5):
        if on_card:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            query()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            query()
            times.append(time.perf_counter() - t0)
    dt = sorted(times)[2]
    where = f"median of 5, CUDA events, {card_name()}" if on_card else \
        "median of 5, host clock, cpu"
    print(f"{n} rows, {raw_mb:.1f} MiB raw -> {file_mb:.1f} MiB on disk "
          f"({raw_mb/file_mb:.1f}x)")
    print(f"customer {target}: {hits} orders, {total} total qty "
          f"(on-chip result, verified vs numpy)")
    print(f"on-chip decode+filter+aggregate: {dt*1e3:.1f} ms = "
          f"{n/dt/1e6:.0f}M rows/s x 2 columns [{where}]")

    # The library spellings of the same query (analytics module): filtered
    # aggregation and GROUP BY run the same decode -> reduce pipeline
    # without the hand-rolled plumbing above.
    with tempfile.NamedTemporaryFile(suffix=".flt") as f:
        tier = (customer % 5).astype(np.uint16)
        cats = np.array(["EUR", "GBP", "JPY", "USD"])
        currency = cats[customer % 4]  # STRING column: dictionary-encoded
        fio_table.write_table(f.name, {"customer": customer, "qty": qty,
                                       "tier": tier, "currency": currency})
        s = analytics.scan_where(f.name, "eq", target,
                                 column="qty", where="customer", device=dev)
        assert s["count"] == int(mask.sum())
        assert s["sum"] == int(qty[mask].sum())
        per_tier = analytics.group_stats(f.name, "tier", "qty", device=dev)
        assert per_tier[0]["sum"] == int(qty[tier == 0].sum())
        tier_sums = {g: r["sum"] for g, r in sorted(per_tier.items())}
        print(f"analytics.scan_where one-liner agrees: {s}")
        print(f"analytics.group_stats('tier', 'qty'): {tier_sums}")
        # string predicates and group-bys run as integer code compares
        # (sorted dictionary: code order == lexicographic order)
        eur = analytics.scan_where(f.name, "eq", "EUR",
                                   column="qty", where="currency", device=dev)
        assert eur["sum"] == int(qty[currency == "EUR"].sum())
        per_cur = analytics.group_stats(f.name, "currency", "qty", device=dev)
        assert set(per_cur) == set(cats)
        cur_sums = {g: r["sum"] for g, r in sorted(per_cur.items())}
        print(f"analytics.group_stats('currency', 'qty') [string key]: {cur_sums}")
    return {"rows": n, "raw_mib": raw_mb, "file_mib": file_mb, "target": target,
            "hits": hits, "total_qty": total,
            "chunk_codecs": sorted({m["codec"] for m, _ in cchunks + qchunks}),
            "timing": {"query_ms": dt * 1e3, "rows_per_s": n / dt, "clock": where},
            "scan_where": s, "group_tier": tier_sums, "eur": eur,
            "group_currency": cur_sums}


if __name__ == "__main__":
    main()
