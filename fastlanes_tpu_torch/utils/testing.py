"""Test-support helpers shared by the suites and tools (numpy only).

The port's copy of fastlanes_tpu/utils/testing.py. Its `to_jax_form` and
`from_jax_form` have no counterpart here: the port's ops take a u64 column
as a native uint64 tensor, not as limb pairs (`to_limb_view` /
`from_limb_view` still give the JAX package's limb image)."""

from __future__ import annotations

import hashlib

import numpy as np

#: Golden sha256 digests of packed payloads (little-endian bytes), derived
#: from the reference crate's own examples (SURVEY.md §8):
#: - README example: u16, W=3, values[i] = i % 8 (reference README.md:21-24)
#: - Delta pipeline: u16, W=15, values[i] = i // 8, zero base
#:   (reference delta.rs:80-96)
GOLDEN_SHA256 = {
    ("readme_u16_w3"): "f949547d2b920f409dc21441e8ce7d412965a9ff3eac94d551362f689372db20",
    ("delta_u16_w15"): "5185857a43fed531c32020253fb0c165e8fd8fa423455769c8e96f181bae7848",
}


def sha256_le(arr: np.ndarray) -> str:
    """sha256 of an array's little-endian byte image."""
    dt = arr.dtype.newbyteorder("<")
    return hashlib.sha256(np.ascontiguousarray(arr).astype(dt).tobytes()).hexdigest()


def to_limb_view(arr: np.ndarray) -> np.ndarray:
    """uint64 array -> (..., 2) uint32 little-endian limb view (byte image)."""
    return np.ascontiguousarray(arr).view("<u4").reshape(*arr.shape, 2)


def from_limb_view(arr: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(arr).view("<u8").reshape(arr.shape[:-1])
