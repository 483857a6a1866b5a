"""Composed codec pipelines: the encoder/decoder classes over the kernel
wrappers (BitPacked, FFoR, Delta, ZDelta, RLE, Dict) and the automatic
width / reference / codec selection."""

from .codecs import (
    BitPackedCodec,
    Codec,
    DeltaCodec,
    DictCodec,
    Encoded,
    FFoRCodec,
    RLECodec,
    ZDeltaCodec,
    auto_costs,
    auto_encode,
    bits_needed,
    get_codec,
)

__all__ = [
    "Codec", "BitPackedCodec", "DeltaCodec", "DictCodec", "FFoRCodec", "RLECodec",
    "ZDeltaCodec", "Encoded", "auto_costs", "auto_encode", "bits_needed",
    "get_codec",
]
