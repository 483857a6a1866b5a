"""`fastlanes_tpu_torch.kernels.warmup` against the JAX package's
`kernels.warmup` on the CPU: the same count for the same arguments, the
plain versions on the host (no kernel launch), the same refusals. On the card
it is driven in tests/test_torch_kernels_cuda.py. Also: every package of the
port exports the JAX package's public names, but the TPU-only ones."""

import importlib

import pytest
import torch

from fastlanes_tpu import kernels as jkernels
from fastlanes_tpu_torch import kernels
from fastlanes_tpu_torch.core import layout
from fastlanes_tpu_torch.kernels import cuda_codecs as ck

#: the JAX function's ops: every kernel name of the port but delta_pack
JAX_OPS = ("pack", "unpack", "undelta_pack", "unzdelta_pack", "for_pack", "unfor_pack",
           "unpack_orig", "undelta_pack_orig", "unzdelta_pack_orig", "delta_pack_orig")


@pytest.mark.parametrize("kw,count", [
    # the arguments of tests/test_routing.py::test_warmup_compiles_routed_entries
    (dict(ops=("pack", "unpack", "undelta_pack", "unfor_pack"), dtypes=("u16", "u64"),
          widths=(1, 3), n_blocks=4), 16),
    (dict(ops=JAX_OPS, dtypes=("uint8",), widths=(1, 8), n_blocks=2), 20),
    # the defaults: ("pack", "unpack") over every dtype and width 1..T
    (dict(n_blocks=1), 240),
], ids=["routing", "every_op", "defaults"])
def test_count_equals_the_jax_function(kw, count):
    ck.reset_launches()
    assert kernels.warmup(**kw, device="cpu") == count == jkernels.warmup(**kw)
    assert sum(ck.LAUNCHES.values()) == 0  # the plain versions ran, no kernel


def test_every_kernel_name_runs_on_the_cpu():
    n_widths = sum(layout.bit_width(dt) for dt in layout.DTYPES)
    ck.reset_launches()
    assert kernels.warmup(ops=tuple(ck.LAUNCHES), n_blocks=2, device="cpu") \
        == len(ck.LAUNCHES) * n_widths == 11 * 120
    assert sum(ck.LAUNCHES.values()) == 0


@pytest.mark.parametrize("ops", [("pack", "bogus"), ("pack_map",)])
def test_unknown_op_raises_before_any_work(ops):
    with pytest.raises(ValueError, match="unknown op"):
        kernels.warmup(ops=ops, device="cpu")


def test_bad_width_raises():
    with pytest.raises(ValueError):
        kernels.warmup(dtypes=("u8",), widths=(9,), device="cpu")


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        kernels.warmup(dtypes=("u8",), widths=(1,))


#: package -> the JAX package's names the port leaves out on purpose
#: (ROADMAP.md, ground rules): the u64 limb form, the Pallas module, and
#: ops.dispatch, which sits above the kernel wrappers and is imported by name
LEFT_OUT = {
    "": {"LimbPlanes"},
    "ops": {"dispatch", "unchecked_pack", "unchecked_unpack", "unchecked_unpack_single",
            "unpack_planes"},
    "kernels": {"pallas_codecs"},
}


@pytest.mark.parametrize("package", ["", "core", "ref", "ops", "kernels", "models",
                                     "parallel", "utils"])
def test_packages_export_the_jax_names(package):
    suffix = f".{package}" if package else ""
    jax_names = set(importlib.import_module(f"fastlanes_tpu{suffix}").__all__)
    port = importlib.import_module(f"fastlanes_tpu_torch{suffix}")
    missing = jax_names - set(port.__all__) - LEFT_OUT.get(package, set())
    assert not missing
    for name in port.__all__:
        getattr(port, name)
