"""CUDA kernels for Hopper: the hot compute path. Same names and argument
order as the ops layer; a CPU tensor takes the plain PyTorch version."""

from . import cuda_codecs
from .cuda_codecs import (
    LAUNCHES,
    delta_pack,
    delta_pack_orig,
    for_pack,
    pack,
    pack_map,
    undelta_pack,
    undelta_pack_orig,
    unfor_pack,
    unpack,
    unpack_orig,
    unzdelta_pack,
    unzdelta_pack_orig,
    warmup,
)

__all__ = [
    "cuda_codecs", "LAUNCHES", "pack", "pack_map", "unpack", "unfor_pack",
    "undelta_pack", "unzdelta_pack", "delta_pack", "for_pack", "unpack_orig",
    "undelta_pack_orig", "unzdelta_pack_orig", "delta_pack_orig", "warmup",
]
