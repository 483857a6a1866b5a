"""The PyTorch port's command line (`python -m fastlanes_tpu_torch`) against
the JAX package's: every subcommand, called in-process with `--on cpu` on
the port's side, prints the same stdout (JSON) and stderr, returns or exits
with the same code, and writes the same output files (FLT bytes, .npy and
.npz arrays, Parquet tables). Without a CUDA device and without `--on cpu`
the device subcommands exit 1 with an `error:` line and decode nothing."""

import json
import os
import sys

import numpy as np
import pytest
import torch

from fastlanes_tpu import cli as jcli

from fastlanes_tpu_torch import cli
from fastlanes_tpu_torch.kernels import cuda_codecs as ck


def call(main, argv, capsys):
    """(code, stdout, stderr) of one in-process call; a SystemExit's code."""
    try:
        code = main(argv)
    except SystemExit as e:
        code = e.code
    out = capsys.readouterr()
    return code, out.out, out.err


def same_file(a, b):
    if a.endswith(".npy"):
        x, y = np.load(a), np.load(b)
        assert x.dtype == y.dtype and np.array_equal(x, y)
        return
    if a.endswith(".npz"):
        with np.load(a) as x, np.load(b) as y:
            assert sorted(x.files) == sorted(y.files)
            for k in x.files:
                assert x[k].dtype == y[k].dtype and np.array_equal(x[k], y[k]), k
        return
    if a.endswith(".parquet"):
        import pyarrow.parquet as pq

        assert pq.read_table(a).equals(pq.read_table(b))
        return
    with open(a, "rb") as f, open(b, "rb") as g:
        assert f.read() == g.read()


def both(tmp_path, capsys, argv, outputs=()):
    """Run argv through both CLIs ('{D}' is each side's output directory);
    assert equal answers and equal output files; -> the port's answer."""
    got = {}
    for side, main, pre in (("jax", jcli.main, []), ("port", cli.main, ["--on", "cpu"])):
        d = tmp_path / side
        d.mkdir(exist_ok=True)
        args = [a.replace("{D}", str(d)) for a in argv]
        code, out, err = call(main, pre + args, capsys)
        got[side] = (code, out.replace(str(d), "{D}"), err.replace(str(d), "{D}"))
    assert got["port"] == got["jax"]
    for name in outputs:
        same_file(str(tmp_path / "port" / name), str(tmp_path / "jax" / name))
    return got["port"]


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """Input files in one directory; the FLT inputs written by the port's
    CLI (the compress cases show them byte-identical to the JAX CLI's)."""
    d = tmp_path_factory.mktemp("cli_inputs")
    rng = np.random.default_rng(0xC11)
    n = 9 * 1024 + 100
    np.save(d / "sorted.npy", np.sort(rng.integers(0, 1 << 31, (12, 1024)), axis=1)
            .astype(np.uint32))
    np.save(d / "signed.npy", rng.integers(-5000, 5000, n).astype(np.int32))
    np.save(d / "wide.npy", rng.integers(0, 1 << 62, n, dtype=np.uint64) | np.uint64(1 << 63))
    np.save(d / "f32.npy", np.round(rng.uniform(-100, 100, n), 1).astype(np.float32))
    np.save(d / "strs.npy", np.array(["a", "b"]))
    cur = np.array(["EUR", "GBP", "JPY", "USD", "CHF"])[rng.integers(0, 5, n)]
    visits = rng.integers(0, 50, n).astype(np.uint16)
    np.savez(d / "table.npz", qty=rng.integers(0, 10_000, n).astype(np.uint32),
             cur=cur, price=np.round(rng.uniform(0, 500, n), 2).astype(np.float32),
             day=np.datetime64("2024-01-01") + rng.integers(0, 400, n).astype("timedelta64[D]"),
             visits=visits, visits__valid=rng.random(n) > 0.1)
    np.savez(d / "pair.npz", qty=rng.integers(0, 300, 3000).astype(np.uint16),
             cur=cur[:3000])
    np.savez(d / "dim.npz", cur=np.array(["EUR", "GBP", "JPY", "USD"]),
             rate=np.array([1.0, 1.17, 0.0062, 0.92]))
    for src, dst, extra in (("sorted.npy", "sorted.flt", ["--chunk-blocks", "4"]),
                            ("signed.npy", "signed.flt", []), ("wide.npy", "wide.flt", []),
                            ("f32.npy", "f32.flt", [])):
        assert cli.main(["compress", str(d / src), str(d / dst), *extra]) == 0
    for src, dst in (("table.npz", "table.flt"), ("pair.npz", "pair.flt"),
                     ("dim.npz", "dim.flt")):
        assert cli.main(["compress-table", str(d / src), str(d / dst)]) == 0
    try:
        import pyarrow as pa
        import pyarrow.parquet as pq

        pq.write_table(pa.table({"k": pa.array(np.arange(3000, dtype=np.int64)),
                                 "s": pa.array(["x", None, "yz"] * 1000)}),
                       str(d / "data.parquet"))
    except ImportError:
        pass
    with open(d / "data.csv", "w") as f:
        f.write("a,b\n" + "".join(f"{i},{'p' if i % 3 else 'q'}\n" for i in range(2500)))
    return d


def test_compress(tmp_path, capsys, inputs):
    i = str(inputs)
    for src, extra in (("sorted.npy", ["--chunk-blocks", "4"]), ("signed.npy", []),
                       ("signed.npy", ["--dtype", "u32"]), ("wide.npy", ["--codec", "ffor"]),
                       ("f32.npy", [])):
        code, out, _ = both(tmp_path, capsys, ["compress", f"{i}/{src}", "{D}/o.flt", *extra],
                            ["o.flt"])
        assert code == 0 and json.loads(out)["file"] == "{D}/o.flt"
    code, _, _ = both(tmp_path, capsys, ["compress", f"{i}/strs.npy", "{D}/s.flt"])
    assert code == "FastLanes compresses integers and floats, got <U1"
    code, _, _ = both(tmp_path, capsys, ["compress", f"{i}/f32.npy", "{D}/s.flt",
                                         "--dtype", "u32"])
    assert code == "float columns choose their own wire dtype; drop --dtype"


@pytest.mark.parametrize("device", [False, True], ids=["host", "device"])
def test_decompress(tmp_path, capsys, inputs, device):
    i = str(inputs)
    flag = ["--device"] if device else []
    # the device side: delta u32 by range, u64 whole (the JAX CLI rejoins its
    # limb image)
    for src in ("sorted.flt", "signed.flt", "wide.flt", "f32.flt") if not device else \
            ("wide.flt",):
        code, _, _ = both(tmp_path, capsys, ["decompress", f"{i}/{src}", "{D}/o.npy", *flag],
                          ["o.npy"])
        assert code == 0
    code, _, _ = both(tmp_path, capsys, ["decompress", f"{i}/sorted.flt", "{D}/r.npy",
                                         "--start", "3", "--stop", "10", *flag], ["r.npy"])
    assert code == 0


def test_inspect_and_get(tmp_path, capsys, inputs):
    i = str(inputs)
    for src in ("sorted.flt", "f32.flt", "table.flt"):
        assert both(tmp_path, capsys, ["inspect", f"{i}/{src}"])[0] == 0
    for src, block, index in (("sorted.flt", "5", "777"), ("signed.flt", "9", "99"),
                              ("wide.flt", "0", "1"), ("f32.flt", "2", "3")):
        assert both(tmp_path, capsys, ["get", f"{i}/{src}", block, index])[0] == 0
    code, _, err = both(tmp_path, capsys, ["get", f"{i}/sorted.flt", "12", "0"])
    assert code == 1 and err.startswith("error: ")
    code, _, err = both(tmp_path, capsys, ["inspect", f"{i}/missing.flt"])
    assert code == 1 and err.startswith("error: ")


def test_tables(tmp_path, capsys, inputs):
    i = str(inputs)
    assert both(tmp_path, capsys, ["compress-table", f"{i}/table.npz", "{D}/t.flt",
                                   "--chunk-blocks", "4"], ["t.flt"])[0] == 0
    assert both(tmp_path, capsys, ["decompress-table", f"{i}/table.flt", "{D}/t"],
                ["t.npz"])[0] == 0
    assert both(tmp_path, capsys, ["decompress-table", f"{i}/table.flt", "{D}/u.npz",
                                   "--columns", "cur, visits"], ["u.npz"])[0] == 0
    code, _, _ = both(tmp_path, capsys, ["compress-table", f"{i}/strs.npy", "{D}/x.flt"])
    assert "compress-table needs an .npz" in code
    for src, dst in (("table.flt", "r.flt"), ("sorted.flt", "c.flt")):
        assert both(tmp_path, capsys, ["recompress", f"{i}/{src}", "{D}/" + dst,
                                       "--chunk-blocks", "2"], [dst])[0] == 0


def test_scan(tmp_path, capsys, inputs):
    i = str(inputs)
    runs = [
        ["scan", f"{i}/sorted.flt", "--where", "gt:1000000000", "--top", "3",
         "--bottom", "2", "--quantile", "0.9"],
        ["scan", f"{i}/signed.flt", "--distinct", "--where", "in:-3,7,4999"],
        ["scan", f"{i}/pair.flt"],  # every column, one pass
        ["scan", f"{i}/table.flt", "--column", "qty", "--where", "eq:EUR",
         "--where-column", "cur", "--value-counts"],
        ["scan", f"{i}/table.flt", "--column", "qty", "--group-by", "cur",
         "--where", "lt:5000", "--where-column", "qty"],
        ["scan", f"{i}/table.flt", f"{i}/table.flt", "--column", "visits", "--distinct"],
    ]
    for argv in runs:
        code, out, _ = both(tmp_path, capsys, argv)
        assert code == 0 and json.loads(out)
    code, _, _ = both(tmp_path, capsys, ["scan", f"{i}/table.flt", "--where", "gt:10"])
    assert code == "--where on a table file needs --column"
    code, _, _ = both(tmp_path, capsys, ["scan", f"{i}/sorted.flt", "--group-by", "k"])
    assert code == "--group-by needs a table file and --column"


def test_select_and_join(tmp_path, capsys, inputs):
    i = str(inputs)
    runs = [
        (["select", f"{i}/table.flt", "{D}/a.npz", "--where", "cur:in:EUR,GBP",
          "--where", "qty:lt:5000", "--order-by", "qty", "--desc", "--limit", "10"], "a.npz"),
        (["select", f"{i}/table.flt", "{D}/b", "--columns", "qty,visits", "--where",
          "visits:ge:10", "--limit", "300"], "b.npz"),
        (["join", f"{i}/table.flt", f"{i}/dim.flt", "{D}/j.npz", "--on", "cur",
          "--how", "left", "--where", "qty:gt:9000"], "j.npz"),
    ]
    for argv, output in runs:
        assert both(tmp_path, capsys, argv, [output])[0] == 0
    code, _, _ = both(tmp_path, capsys, ["select", f"{i}/table.flt", "{D}/x.npz",
                                         "--where", "qty:gt"])
    assert code == "--where takes COLUMN:OP:VALUE, got 'qty:gt'"
    code, _, _ = both(tmp_path, capsys, ["select", f"{i}/table.flt", "{D}/x.npz",
                                         "--where", "nope:gt:1"])
    assert code.startswith("error: ")
    code, _, _ = both(tmp_path, capsys, ["join", f"{i}/table.flt", f"{i}/dim.flt",
                                         "{D}/x.npz", "--on", "qty"])
    assert code.startswith("error: ")


def test_import_export(tmp_path, capsys, inputs):
    pytest.importorskip("pyarrow")
    i = str(inputs)
    for argv, output in ((["import", f"{i}/data.parquet", "{D}/p.flt"], "p.flt"),
                         (["import", f"{i}/data.parquet", "{D}/q.flt", "--batch-rows", "700",
                           "--chunk-blocks", "1"], "q.flt"),
                         (["import", f"{i}/data.csv", "{D}/c.flt"], "c.flt"),
                         (["export", f"{i}/table.flt", "{D}/t.parquet"], "t.parquet")):
        assert both(tmp_path, capsys, argv, [output])[0] == 0
    code, _, _ = both(tmp_path, capsys, ["import", f"{i}/dim.npz", "{D}/x.flt"])
    assert code == "import takes .parquet/.pq/.csv, got 'npz'"


def test_bench_answers_with_the_same_keys(capsys):
    argv = ["bench", "--dtype", "u32", "--width", "7", "--repeat", "3"]
    assert jcli.main(argv) == 0
    want = json.loads(capsys.readouterr().out)
    assert cli.main(argv) == 0
    got = json.loads(capsys.readouterr().out)
    assert list(got) == list(want)
    assert {k: v for k, v in got.items() if not isinstance(v, dict)} == \
        {k: v for k, v in want.items() if not isinstance(v, dict)}
    for path, times in got.items():
        if isinstance(times, dict):
            assert list(times) == list(want[path]) and all(t > 0 for t in times.values())
    code, _, _ = call(cli.main, ["bench", "--dtype", "u8", "--width", "9"], capsys)
    assert code == "width 9 out of range for u8 (0..8)"


def test_without_a_card_the_device_subcommands_exit_1(tmp_path, capsys, inputs):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    i = str(inputs)
    before = dict(ck.LAUNCHES)
    for argv in (["decompress", f"{i}/sorted.flt", str(tmp_path / "o.npy"), "--device"],
                 ["scan", f"{i}/sorted.flt"],
                 ["select", f"{i}/table.flt", str(tmp_path / "s.npz")],
                 ["join", f"{i}/table.flt", f"{i}/dim.flt", str(tmp_path / "j.npz"),
                  "--on", "cur"],
                 ["--on", "cuda", "scan", f"{i}/table.flt"]):
        code, out, err = call(cli.main, argv, capsys)
        assert code == 1 and out == ""
        assert err.startswith("error: no CUDA device") and "--on cpu" in err
    assert os.listdir(tmp_path) == [] and ck.LAUNCHES == before
    # the host subcommands need no card
    assert call(cli.main, ["get", f"{i}/sorted.flt", "0", "0"], capsys)[0] == 0


def test_the_module_runs_as_a_program(inputs, capsys, monkeypatch):
    """`python -m fastlanes_tpu_torch ...`: __main__ exits with main's code
    (importing the module alone runs nothing)."""
    import importlib
    import runpy

    monkeypatch.delitem(sys.modules, "fastlanes_tpu_torch.__main__", raising=False)
    monkeypatch.setattr("sys.argv", ["fastlanes_tpu_torch", "--on", "cpu", "inspect",
                                     str(inputs / "sorted.flt")])
    with pytest.raises(SystemExit) as stop:
        runpy.run_module("fastlanes_tpu_torch", run_name="__main__")
    assert stop.value.code == 0
    assert json.loads(capsys.readouterr().out)["n_blocks"] == 12
    importlib.import_module("fastlanes_tpu_torch.__main__")
    assert capsys.readouterr().out == ""
