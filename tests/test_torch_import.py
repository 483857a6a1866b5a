"""The PyTorch port stands alone: it imports torch and numpy, never jax and
nothing of the JAX package, and it never runs on the CPU unasked."""

import os
import pkgutil
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import fastlanes_tpu_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "fastlanes_tpu_torch")


def port_modules():
    names = ["fastlanes_tpu_torch"]
    for info in pkgutil.walk_packages([PKG], prefix="fastlanes_tpu_torch."):
        names.append(info.name)
    return names


def port_sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for base, _, files in os.walk(PKG):
        out += [os.path.join(base, f) for f in files if f.endswith((".py", ".cu", ".cuh"))]
    return sorted(out)


def test_every_module_is_listed():
    names = port_modules()
    for want in ("core.layout", "ref.numpy_ref", "transforms", "zonemaps", "alp",
                 "fio", "ops._engine", "ops.bitpack", "ops.ffor", "ops.delta",
                 "ops.transpose", "kernels.cuda_codecs", "kernels.build",
                 "fio_device", "convert", "ops.orig", "ops.single", "ops.dispatch",
                 "models.codecs", "fio_table", "analytics", "native", "parallel",
                 "parallel.mesh", "parallel.shard", "utils", "utils.serialization",
                 "utils.testing", "utils.timing", "utils.trace", "interop", "cli", "__main__"):
        assert f"fastlanes_tpu_torch.{want}" in names


def test_import_loads_no_jax_and_no_reference_package():
    """In a fresh interpreter: import the package, every submodule and the
    lazy API names; neither jax nor fastlanes_tpu may be loaded."""
    code = (
        "import importlib, sys\n"
        f"names = {port_modules()!r}\n"
        "for n in names: importlib.import_module(n)\n"
        "import fastlanes_tpu_torch as ft\n"
        "for n in ft.__all__: getattr(ft, n)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'jaxlib' or m == 'fastlanes_tpu' or m.startswith('fastlanes_tpu.'))\n"
        "assert not bad, bad\n"
        "print('clean', len(names))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("clean")


@pytest.mark.parametrize("path", port_sources(), ids=lambda p: os.path.relpath(p, ROOT))
def test_source_names_no_jax_import(path):
    with open(path) as f:
        text = f.read()
    assert not re.search(r"^\s*(import|from)\s+jax\b", text, re.M)
    assert not re.search(r"^\s*(import|from)\s+fastlanes_tpu(\.|\s)", text, re.M)
    # no dotted reference into the JAX package either (prose names its files
    # by path, fastlanes_tpu/...)
    assert not re.search(r"\bfastlanes_tpu\.[A-Za-z_]", text)


def test_lazy_api_names_resolve():
    for name in fastlanes_tpu_torch.__all__:
        assert getattr(fastlanes_tpu_torch, name) is not None
    with pytest.raises(AttributeError):
        fastlanes_tpu_torch.no_such_name


def test_public_names_are_the_kernel_wrappers():
    """The names with a CUDA kernel resolve to the wrappers of
    kernels/cuda_codecs.py (kernel on a CUDA tensor, plain version on a CPU
    tensor), never to the plain ops; the ops without a kernel stay in ops.*."""
    from fastlanes_tpu_torch.kernels import cuda_codecs as ck
    from fastlanes_tpu_torch.models import codecs
    from fastlanes_tpu_torch.ops import bitpack, delta, dispatch, ffor, single, transpose

    for name in ("pack", "pack_map", "unpack", "undelta_pack", "delta_pack", "for_pack",
                 "unfor_pack", "unpack_orig", "undelta_pack_orig", "unzdelta_pack_orig",
                 "delta_pack_orig"):
        assert getattr(fastlanes_tpu_torch, name) is getattr(ck, name), name
    for name, plain in (("pack", bitpack.pack), ("unpack", bitpack.unpack),
                        ("undelta_pack", delta.undelta_pack),
                        ("delta_pack", delta.delta_pack), ("for_pack", ffor.for_pack),
                        ("unfor_pack", ffor.unfor_pack)):
        assert getattr(fastlanes_tpu_torch, name) is not plain, name
    for name in ("delta", "undelta"):
        assert getattr(fastlanes_tpu_torch, name) is getattr(delta, name)
    for name in ("transpose", "untranspose"):
        assert getattr(fastlanes_tpu_torch, name) is getattr(transpose, name)
    assert fastlanes_tpu_torch.unpack_single is single.unpack_single
    for name in ("unchecked_pack", "unchecked_unpack", "unchecked_unpack_single"):
        assert getattr(fastlanes_tpu_torch, name) is getattr(dispatch, name)
    assert fastlanes_tpu_torch.auto_encode is codecs.auto_encode
    assert fastlanes_tpu_torch.get_codec is codecs.get_codec
    assert set(ck.LAUNCHES) == {"unpack", "unfor_pack", "undelta_pack", "unzdelta_pack",
                                "pack", "delta_pack", "for_pack", "unpack_orig",
                                "undelta_pack_orig", "unzdelta_pack_orig",
                                "delta_pack_orig"}


def test_public_codec_names_match_the_reference_package():
    """Every codec name of the JAX package's public API that this slice
    covers is a public name of the port."""
    for name in ("pack", "pack_map", "unpack", "unpack_single", "delta", "undelta",
                 "undelta_pack", "delta_pack", "for_pack", "unfor_pack", "transpose",
                 "untranspose", "unchecked_pack", "unchecked_unpack",
                 "unchecked_unpack_single", "auto_encode", "get_codec"):
        assert name in fastlanes_tpu_torch.__all__, name


def test_table_multi_file_and_scan_names_resolve_to_their_modules():
    """The twenty-one names of the float / table / scan / aggregation / row
    paths, under the JAX package's names: the port's analytics has every
    public entry of the JAX package's."""
    from fastlanes_tpu_torch import analytics, fio_device, fio_table

    homes = {fio_table: ("write_table", "read_table", "read_column", "TableWriter",
                         "StringColumn"),
             fio_device: ("read_files_device", "iter_files_device", "read_column_device"),
             analytics: ("scan_column", "scan_table", "count_where", "scan_where",
                         "scan_where_multi", "group_stats", "distinct", "value_counts",
                         "top_k", "quantile", "median", "select", "join")}
    for module, names in homes.items():
        for name in names:
            assert name in fastlanes_tpu_torch.__all__, name
            assert getattr(fastlanes_tpu_torch, name) is getattr(module, name), name


def test_default_device_is_the_gpu_or_an_error(tmp_path):
    """`device=None` means CUDA: on a machine without it the entry points
    raise instead of carrying on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    from fastlanes_tpu_torch import convert, fio, fio_device

    path = str(tmp_path / "col.flt")
    values = np.arange(2048, dtype=np.uint32).reshape(2, 1024)
    fio.write_file(path, values)
    with pytest.raises(RuntimeError, match="cuda"):
        fio_device.read_file_device(path)
    with pytest.raises(RuntimeError, match="cuda"):
        fio_device.read_blocks_device(path, 0, 1)
    with pytest.raises(RuntimeError, match="cuda"):
        convert.from_reference(values, "u32")
    got = fio_device.read_file_device(path, device="cpu")
    assert got.device.type == "cpu" and np.array_equal(got.numpy(), values)
    from fastlanes_tpu_torch import alp

    with pytest.raises(RuntimeError, match="cuda"):
        fastlanes_tpu_torch.scan_column(path)
    with pytest.raises(RuntimeError, match="cuda"):
        fastlanes_tpu_torch.count_where(path, "gt", 5)
    # the decoders run where their payload lies: a CPU tensor stays on the CPU
    out = alp.decode_device(torch.zeros(4, dtype=torch.uint32), 2, 0, 0, np.float32)
    assert out.device.type == "cpu"


def test_chip_smoke_refuses_to_run_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                          cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
