"""Plain PyTorch ops: batched codec encoders and decoders on CPU or CUDA
tensors.

The exact FastLanes semantics expressed as static shift/mask chains over
signed bit patterns. They are the CPU path of the port and the plain
versions that the CUDA kernels in `fastlanes_tpu_torch.kernels` are held
against on the card. `dispatch` sits above the kernel wrappers, which import
this package, so it is imported by name and not re-exported from here."""

from . import _engine, bitpack, delta, ffor, orig, single, transpose
from .bitpack import pack, pack_map, unpack
from .delta import delta as delta_encode
from .delta import delta_pack, undelta, undelta_pack
from .ffor import for_pack, unfor_pack
from .single import unpack_single
from .transpose import transpose as transpose_blocks
from .transpose import untranspose as untranspose_blocks

__all__ = [
    "_engine", "bitpack", "delta", "ffor", "orig", "single", "transpose",
    "pack", "pack_map", "unpack", "delta_encode", "delta_pack", "undelta",
    "undelta_pack", "for_pack", "unfor_pack", "unpack_single",
    "transpose_blocks", "untranspose_blocks",
]
