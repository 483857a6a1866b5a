"""fastlanes_tpu_torch: the PyTorch/CUDA port of fastlanes_tpu.

The FastLanes compression layout (Afroozeh & Boncz, VLDB 2023) over
1024-value blocks of u8/u16/u32/u64 on an NVIDIA Hopper GPU: the FLT file
format on the host, device-side column reads, and device-side column encode
through the codec classes, with the encode and decode kernels hand-written
in CUDA. Imports torch and numpy, never jax, and nothing of the JAX package.

Device rule: every entry that touches the device takes `device=None`, which
means the GPU and raises RuntimeError when there is none; the CPU is used
only when asked for by name (`device="cpu"`), with the plain PyTorch
versions of the kernels.

Layer map (same module names as fastlanes_tpu):
  core/      layout spec: FL_ORDER, index maps, inverse tables
  ref/       NumPy oracle and host codec
  ops/       plain PyTorch codecs over signed bit patterns
  kernels/   CUDA kernels (csrc/codecs.cu) and their wrappers
  models/    composed codecs (BitPacked/FFoR/Delta/ZDelta/RLE/Dict/auto)
  fio        FLT file format, host writer and reader
  fio_device device-side FLT reads
  convert    array forms of the JAX package <-> tensors of the port
"""

__version__ = "0.1.0"

from .core import layout
from .core.layout import BLOCK, DTYPES, FL_ORDER, bit_width, lanes, packed_len

__all__ = [
    "layout", "BLOCK", "DTYPES", "FL_ORDER", "bit_width", "lanes", "packed_len",
    "pack", "pack_map", "unpack", "unpack_single", "delta", "undelta",
    "undelta_pack", "delta_pack", "for_pack", "unfor_pack", "transpose",
    "untranspose", "unchecked_pack", "unchecked_unpack",
    "unchecked_unpack_single", "auto_encode", "get_codec",
    "write_file", "read_file", "read_blocks", "read_single",
    "read_blocks_device", "read_file_device", "NullableColumn",
    "from_reference", "to_reference", "__version__",
]


# name -> owning submodule for the lazy re-exports; only the owner is
# imported. The seven names with a CUDA kernel resolve to the kernel wrappers
# (CUDA tensor -> kernel or raise, CPU tensor -> plain version); the ops
# without a kernel stay in ops.*.
_API_HOME = {
    **{n: "kernels.cuda_codecs" for n in (
        "pack", "pack_map", "unpack", "undelta_pack", "delta_pack", "for_pack",
        "unfor_pack")},
    "unpack_single": "ops.single",
    **{n: "ops.delta" for n in ("delta", "undelta")},
    **{n: "ops.transpose" for n in ("transpose", "untranspose")},
    **{n: "ops.dispatch" for n in ("unchecked_pack", "unchecked_unpack",
                                   "unchecked_unpack_single")},
    **{n: "models.codecs" for n in ("auto_encode", "get_codec")},
    **{n: "fio" for n in ("write_file", "read_file", "read_blocks", "read_single")},
    **{n: "fio_device" for n in ("read_blocks_device", "read_file_device",
                                 "NullableColumn")},
    **{n: "convert" for n in ("from_reference", "to_reference")},
}


def __getattr__(name):
    home = _API_HOME.get(name)
    if home is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(f".{home}", __name__), name)
