"""fastlanes_tpu_torch: the PyTorch/CUDA port of fastlanes_tpu.

The FastLanes compression layout (Afroozeh & Boncz, VLDB 2023) over
1024-value blocks of u8/u16/u32/u64 on an NVIDIA Hopper GPU: the FLT file
format on the host (single columns and tables), device-side column reads
(one file, many files, table columns; integer, string and float columns),
device-side column encode through the codec classes, and scans and
aggregations that consume a device read, and the codecs sharded over
the ranks of a process group, with the encode and decode kernels hand-written in CUDA. Imports torch and numpy, never jax, and nothing of the JAX package.

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
  alp        ALP / ALP_RD float codecs: host encoder, host and device decoders
  fio        FLT file format, host writer and reader
  fio_table  FLT table container (named columns, strings, nulls), host side
  fio_device device-side FLT reads
  analytics  scans and aggregations over compressed columns (scan_column,
             scan_table, count_where, scan_where, scan_where_multi,
             group_stats, distinct, value_counts, top_k, quantile, median,
             select, join)
  convert    array forms of the JAX package <-> tensors of the port
  parallel/  process-group meshes and the sharded codecs (torch.distributed)
  native/    C++ host codec (ctypes, built with g++ at first use)
  utils/     golden-vector helpers, timing, Encoded persistence
  interop    Arrow / Parquet / CSV / pandas <-> FLT tables (pyarrow, lazily)
  cli        `python -m fastlanes_tpu_torch`, the FLT command line
"""

__version__ = "0.1.0"

from .core import layout
from .core.layout import BLOCK, DTYPES, FL_ORDER, bit_width, lanes, packed_len

__all__ = [
    "layout", "BLOCK", "DTYPES", "FL_ORDER", "bit_width", "lanes", "packed_len",
    "pack", "pack_map", "unpack", "unpack_single", "delta", "undelta",
    "undelta_pack", "delta_pack", "for_pack", "unfor_pack", "unpack_orig",
    "undelta_pack_orig", "unzdelta_pack_orig", "delta_pack_orig", "transpose",
    "untranspose", "unchecked_pack", "unchecked_unpack",
    "unchecked_unpack_single", "auto_encode", "get_codec",
    "write_file", "read_file", "read_blocks", "read_single",
    "read_blocks_device", "read_file_device", "NullableColumn",
    "write_table", "read_table", "read_column", "TableWriter", "StringColumn",
    "read_files_device", "iter_files_device", "read_column_device",
    "scan_column", "scan_table", "count_where", "scan_where",
    "scan_where_multi", "group_stats", "distinct", "value_counts", "top_k",
    "quantile", "median", "select", "join", "from_reference", "to_reference", "__version__",
]


# name -> owning submodule for the lazy re-exports; only the owner is
# imported. The eleven names with a CUDA kernel resolve to the kernel wrappers
# (CUDA tensor -> kernel or raise, CPU tensor -> plain version); the ops
# without a kernel stay in ops.*.
_API_HOME = {
    **{n: "kernels.cuda_codecs" for n in (
        "pack", "pack_map", "unpack", "undelta_pack", "delta_pack", "for_pack",
        "unfor_pack", "unpack_orig", "undelta_pack_orig", "unzdelta_pack_orig",
        "delta_pack_orig")},
    "unpack_single": "ops.single",
    **{n: "ops.delta" for n in ("delta", "undelta")},
    **{n: "ops.transpose" for n in ("transpose", "untranspose")},
    **{n: "ops.dispatch" for n in ("unchecked_pack", "unchecked_unpack",
                                   "unchecked_unpack_single")},
    **{n: "models.codecs" for n in ("auto_encode", "get_codec")},
    **{n: "fio" for n in ("write_file", "read_file", "read_blocks", "read_single")},
    **{n: "fio_device" for n in ("read_blocks_device", "read_file_device",
                                 "NullableColumn", "read_files_device",
                                 "iter_files_device", "read_column_device")},
    **{n: "fio_table" for n in ("write_table", "read_table", "read_column",
                                "TableWriter", "StringColumn")},
    **{n: "analytics" for n in (
        "scan_column", "scan_table", "count_where", "scan_where",
        "scan_where_multi", "group_stats", "distinct", "value_counts", "top_k",
        "quantile", "median", "select", "join")},
    **{n: "convert" for n in ("from_reference", "to_reference")},
}


def __getattr__(name):
    home = _API_HOME.get(name)
    if home is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(f".{home}", __name__), name)
