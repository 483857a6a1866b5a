"""The port's C++ host codec (fastlanes_tpu_torch/native) against the JAX
package's (fastlanes_tpu/native) and the NumPy oracle: every export over
every (dtype, width), byte for byte; the parallel build under a race of two
processes; and the FLT files the port writes through it, byte for byte the
JAX package's and the port's own without it."""

import os
import subprocess
import sys

import numpy as np
import pytest

from fastlanes_tpu import fio as jfio
from fastlanes_tpu import fio_table as jtab
from fastlanes_tpu import native as jnative

from fastlanes_tpu_torch import fio as tfio
from fastlanes_tpu_torch import fio_table as ttab
from fastlanes_tpu_torch import native
from fastlanes_tpu_torch.core import layout
from fastlanes_tpu_torch.ref import numpy_ref as ref

from conftest import random_values, width_sweep

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def same(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


def test_the_library_builds_and_loads():
    assert native.available()
    lib_dir = native.build()
    assert os.path.dirname(lib_dir) == native.BUILD_DIR
    assert sorted(os.listdir(lib_dir)) == sorted(
        f"libfastlanes_native_{p}.so" for p in range(native.PARTS))


@pytest.mark.parametrize("dt,w", width_sweep())
def test_every_export_equals_the_reference(dt, w):
    """pack / unpack / for / delta_pack / unpack_single at (dt, w), and the
    width-free exports once per dtype, against both other implementations."""
    rng = np.random.default_rng(1000 * layout.bit_width(dt) + w)
    t, nl = layout.bit_width(dt), layout.lanes(dt)
    values = random_values(rng, dt, w, n_blocks=3)
    packed = ref.pack(values, w, dt)
    impls = [ref] + ([jnative] if jnative.available() else [])
    for other in impls:
        assert same(native.pack(values, w, dt), other.pack(values, w, dt))
        assert same(native.unpack(packed, w, dt), other.unpack(packed, w, dt))
    idx = np.array([0, 5, 99, 1023])
    assert same(native.unpack_single(packed, w, idx, dt), values[:, idx])
    full = random_values(rng, dt, t, n_blocks=3)
    reference = int(rng.integers(0, 1 << min(t - 1, 63)))
    base = random_values(rng, dt, t, n_blocks=3)[:, :nl]
    for other in impls:
        assert same(native.for_pack(full, reference, w, dt),
                    other.for_pack(full, reference, w, dt))
        assert same(native.unfor_pack(packed, reference, w, dt),
                    other.unfor_pack(packed, reference, w, dt))
        assert same(native.delta_pack(full, base, w, dt), other.delta_pack(full, base, w, dt))
        assert same(native.undelta_pack(packed, base, w, dt),
                    other.undelta_pack(packed, base, w, dt))
    if w == t:
        transposed = ref.transpose(full, dt)
        for other in impls:
            assert same(native.transpose(full, dt), other.transpose(full, dt))
            assert same(native.untranspose(transposed, dt), other.untranspose(transposed, dt))
            assert same(native.delta(transposed, base, dt), other.delta(transposed, base, dt))
            assert same(native.undelta(transposed, base, dt),
                        other.undelta(transposed, base, dt))
        # one shared base row broadcasts over the blocks
        assert same(native.delta(transposed, base[0], dt), ref.delta(
            transposed, np.broadcast_to(base[0], base.shape), dt))


def test_non_temporal_paths_and_out_buffers():
    """The streaming-store decode (>= 512 blocks, 64-byte-aligned output)
    and an unaligned caller buffer give the oracle's bytes; preallocated
    outputs are used and validated."""
    rng = np.random.default_rng(7)
    n, w = 600, 3
    for dt in layout.DTYPES:
        vals = random_values(rng, dt, w, n_blocks=n)
        packed = ref.pack(vals, w, dt)
        assert same(native.unpack(packed, w, dt), vals)
        raw = np.empty(n * 1024 * vals.dtype.itemsize + 64, np.uint8)
        off = (-raw.ctypes.data) % 64 + vals.dtype.itemsize
        ubuf = raw[off:off + n * 1024 * vals.dtype.itemsize].view(vals.dtype).reshape(n, 1024)
        assert same(native.unpack(packed, w, dt, out=ubuf), vals)
        tr = ref.transpose(vals, dt)
        base = np.ascontiguousarray(tr[:, :layout.lanes(dt)])
        pd = ref.pack(ref.delta(tr, base, dt), w, dt)
        assert same(native.undelta_pack(pd, base, w, dt), ref.undelta_pack(pd, base, w, dt))
        assert same(native.unfor_pack(packed, 0, w, dt), ref.unfor_pack(packed, 0, w, dt))
    vals = rng.integers(0, 8, (16, 1024), np.int64).astype(np.uint32)
    pbuf = np.empty((16, layout.packed_len("u32", 3)), np.uint32)
    obuf = np.empty((16, 1024), np.uint32)
    assert native.pack(vals, 3, "u32", out=pbuf) is pbuf
    assert native.unpack(pbuf, 3, "u32", out=obuf) is obuf and same(obuf, vals)
    with pytest.raises(ValueError, match="C-contiguous"):
        native.unpack(pbuf, 3, "u32", out=np.empty((16, 1024), np.uint16))
    with pytest.raises(ValueError):
        native.pack(np.zeros((1, 1024), np.uint8), 9, "u8")
    with pytest.raises(IndexError):
        native.unpack_single(pbuf, 3, [1024], "u32")
    assert native.aligned_empty((3, 5), np.uint64).ctypes.data % 64 == 0


#: the race is about the lock and the rename, not the code g++ makes: at -O0
#: the 8 parts build in well under half the time of the package's -O2
RACE = r"""
import sys
from fastlanes_tpu_torch import native
native.BUILD_DIR = sys.argv[1]
native.CXX_FLAGS = ("-O0",) + tuple(f for f in native.CXX_FLAGS if not f.startswith("-O"))
lib_dir = native.build()
import numpy as np
v = (np.arange(2 * 1024) % 8).astype(np.uint32).reshape(2, 1024)
for w in range(3, 3 + native.PARTS):  # every part answers
    assert np.array_equal(native.unpack(native.pack(v, w, "u32"), w, "u32"), v)
print(lib_dir, native.last_build_seconds is not None)
"""


def test_two_processes_building_at_once_load_one_whole_library(tmp_path):
    build_dir = str(tmp_path / "build")
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen([sys.executable, "-c", RACE, build_dir], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=900) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], [err for _o, err in outs]
    dirs, compiled = zip(*(out.split() for out, _err in outs))
    assert dirs[0] == dirs[1] and sorted(compiled) == ["False", "True"]
    assert sorted(os.listdir(build_dir)) == sorted([os.path.basename(dirs[0]), "native.lock"])
    assert len(os.listdir(dirs[0])) == native.PARTS


def file_cases(rng):
    """name -> (values, write_file keyword arguments): every codec's native
    branch on the writer and the reader."""
    n = 5 * 1024 + 300
    srt = np.sort(rng.integers(0, 1 << 30, n)).astype(np.uint32)
    return {
        "bitpack_u8": (rng.integers(0, 60, n).astype(np.uint8), {"codec": "bitpack"}),
        "ffor_u16": (rng.integers(4000, 4100, n).astype(np.uint16), {"codec": "ffor"}),
        "delta_u32": (srt, {"codec": "delta"}),
        "zdelta_u64": (np.cumsum(rng.integers(-5, 9, n)).astype(np.uint64) + np.uint64(1 << 40),
                       {"codec": "zdelta"}),
        "rle_u32": (np.repeat(rng.integers(0, 1 << 20, n // 64 + 1), 64)[:n].astype(np.uint32),
                    {"codec": "rle"}),
        "dict_u64": (rng.choice(np.array([3, 1 << 40, 1 << 63, 77], np.uint64), n),
                     {"codec": "dict"}),
        "auto_i32": (rng.integers(-3000, 3000, n).astype(np.int32), {}),
        "alp_f64": (np.round(rng.uniform(-1000, 1000, n), 2), {}),
        "alprd_f64": (rng.normal(0, 1, n), {"codec": "alprd"}),
        "alp_f32": (np.round(rng.uniform(-50, 50, n), 1).astype(np.float32), {}),
    }


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    """name -> (port file with native, port file without, JAX package file)."""
    root = tmp_path_factory.mktemp("native_files")
    cases = file_cases(np.random.default_rng(0x7A7))
    out = {}
    for name, (values, kw) in cases.items():
        paths = [str(root / f"{name}_{tag}.flt") for tag in ("native", "numpy", "jax")]
        tfio.write_file(paths[0], values, chunk_blocks=2, **kw)
        real = tfio.native.available
        tfio.native.available = lambda: False
        try:
            tfio.write_file(paths[1], values, chunk_blocks=2, **kw)
        finally:
            tfio.native.available = real
        jfio.write_file(paths[2], values, chunk_blocks=2, **kw)
        out[name] = (values, paths)
    cols = {k: v for k, (v, _kw) in cases.items()}
    cols["s"] = np.array(["x", "yy", "zzz"])[np.arange(len(cols["alp_f64"])) % 3]
    tables = [str(root / f"table_{tag}.flt") for tag in ("native", "jax")]
    ttab.write_table(tables[0], cols, chunk_blocks=2)
    jtab.write_table(tables[1], cols, chunk_blocks=2)
    return out, tables


@pytest.mark.parametrize("name", list(file_cases(np.random.default_rng(0))))
def test_written_files_are_the_reference_bytes(written, name):
    files, _tables = written
    values, paths = files[name]
    native_bytes, numpy_bytes, jax_bytes = (open(p, "rb").read() for p in paths)
    assert native_bytes == jax_bytes and native_bytes == numpy_bytes
    got = tfio.read_file(paths[0])
    assert got.dtype == values.dtype and np.array_equal(
        got.view(np.uint8), np.ascontiguousarray(values).view(np.uint8))
    assert np.array_equal(tfio.read_blocks(paths[0], 1, 4), jfio.read_blocks(paths[0], 1, 4))
    for i in (0, 1029, len(values) - 1):
        assert tfio.read_single(paths[0], i // 1024, i % 1024) == \
            jfio.read_single(paths[0], i // 1024, i % 1024)


def test_written_table_is_the_reference_bytes(written):
    _files, (port, jax) = written
    assert open(port, "rb").read() == open(jax, "rb").read()


def test_the_writer_and_reader_take_the_native_branch(tmp_path, monkeypatch):
    """fio.py calls the library wherever the JAX package's fio calls its own."""
    calls = []
    for name in ("pack", "unpack", "for_pack", "unfor_pack", "transpose", "untranspose",
                 "delta", "undelta", "undelta_pack", "unpack_single"):
        real = getattr(native, name)
        monkeypatch.setattr(native, name, lambda *a, _r=real, _n=name, **k: (
            calls.append(_n), _r(*a, **k))[1])
    vals = np.sort(np.random.default_rng(3).integers(0, 1 << 20, 3000)).astype(np.uint32)
    path = str(tmp_path / "d.flt")
    tfio.write_file(path, vals, codec="delta")
    tfio.read_file(path)
    path = str(tmp_path / "b.flt")
    tfio.write_file(path, vals, codec="bitpack")
    tfio.read_single(path, 1, 5)
    assert {"transpose", "delta", "pack", "undelta_pack", "untranspose",
            "unpack_single"} <= set(calls)


class _FakeGxx:
    """Stands in for the g++ processes `_compile` starts: writes the part
    named after -o and succeeds (the lock and the renames are under test,
    not the compiler)."""

    started = 0

    def __init__(self, cmd, **_kw):
        _FakeGxx.started += 1
        with open(cmd[cmd.index("-o") + 1], "w") as f:
            f.write("new")
        self.returncode = 0

    def communicate(self):
        return "", ""


@pytest.mark.parametrize("force", [False, True])
def test_build_compiles_when_the_parts_are_missing(tmp_path, monkeypatch, force):
    lib_dir = str(tmp_path / "build" / "native-key")
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "library_dir", lambda: lib_dir)
    monkeypatch.setattr(native.subprocess, "Popen", _FakeGxx)
    _FakeGxx.started = 0
    assert native.build(force=force) == lib_dir
    assert _FakeGxx.started == native.PARTS
    assert sorted(os.listdir(lib_dir)) == sorted(
        os.path.basename(native._part_path(lib_dir, p)) for p in range(native.PARTS))


def test_build_force_rebuilds_parts_that_exist(tmp_path, monkeypatch):
    """force=False loads what is there; force=True compiles the 8 parts anew
    under the file lock and swaps them in whole."""
    lib_dir = str(tmp_path / "build" / "native-key")
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "library_dir", lambda: lib_dir)
    monkeypatch.setattr(native.subprocess, "Popen", _FakeGxx)
    os.makedirs(lib_dir)
    stale = os.path.join(lib_dir, "stale")
    open(stale, "w").close()
    _FakeGxx.started = 0
    assert native.build() == lib_dir and native.build(force=False) == lib_dir
    assert _FakeGxx.started == 0 and os.path.exists(stale)
    assert native.build(force=True) == lib_dir
    assert _FakeGxx.started == native.PARTS and not os.path.exists(stale)
    assert len(os.listdir(lib_dir)) == native.PARTS
    assert sorted(os.listdir(tmp_path / "build")) == ["native-key", "native.lock"]
