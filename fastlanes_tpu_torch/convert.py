"""State carried across the two packages: array forms of the JAX package
(`fastlanes_tpu`) to and from the tensors of this port.

The JAX package holds integer columns in several forms: native-width
unsigned numpy arrays (u8/u16/u32), `uint64` arrays, the `(..., 2)` uint32
limb image of a u64 buffer (little-endian lo, hi), and `LimbPlanes`, whose
`np.asarray` is that limb image. The port holds one form: the native
unsigned torch tensor (signed after a zigzag/viewu transform). Both
functions take and return numpy arrays on the reference's side, never a
`jax.Array`: callers convert with `np.asarray` first. An FLT file needs no
conversion, since both packages read the same bytes.

`encoded_from_reference` / `encoded_to_reference` carry a whole `Encoded` of
the codec classes (models/codecs.py) across, so that either package decodes
what the other encoded.
"""

from __future__ import annotations

import numpy as np
import torch

from .core import layout
from .ops import _engine as eng

_SIGNED_NP = {"u8": np.int8, "u16": np.int16, "u32": np.int32, "u64": np.int64}


def from_reference(arr, dtype, device=None) -> torch.Tensor:
    """A reference-side numpy array -> the port's tensor on `device`.

    `dtype` is the FastLanes dtype ('u8'..'u64'). For u64 both `uint64` and
    the `(..., 2)` uint32 limb image are accepted. Signed arrays of the same
    width (a column after its zigzag/viewu transform) keep their sign."""
    dtype = layout.canon_dtype(dtype)
    device = eng.resolve_device(device)
    arr = np.ascontiguousarray(np.asarray(arr))
    if arr.dtype == _SIGNED_NP[dtype]:
        return torch.from_numpy(arr.copy()).to(device)
    if dtype == "u64" and arr.dtype == np.uint32:
        if arr.ndim == 0 or arr.shape[-1] != 2:
            raise ValueError("u64 limb arrays must have trailing axis 2 (lo, hi)")
        arr = arr.view(np.uint64).reshape(arr.shape[:-1])
    if arr.dtype != layout.np_dtype(dtype):
        raise ValueError(f"expected a {dtype} array form, got {arr.dtype}")
    return torch.from_numpy(arr.copy()).to(device)


def to_reference(tensor: torch.Tensor, dtype, form: str = "native") -> np.ndarray:
    """The port's tensor -> the numpy array whose bytes the reference would
    produce. `form='native'` gives the native-width array (uint64 for u64,
    signed if the tensor is signed); `form='limbs'` (u64 only) gives the
    `(..., 2)` uint32 limb image that the JAX package returns without x64."""
    dtype = layout.canon_dtype(dtype)
    want = (eng.torch_dtype(dtype), eng.signed_dtype(dtype))
    if tensor.dtype not in want:
        raise ValueError(f"expected a {dtype} tensor, got {tensor.dtype}")
    arr = tensor.detach().cpu().contiguous().numpy()
    if form == "native":
        return arr
    if form == "limbs":
        if dtype != "u64":
            raise ValueError("form='limbs' is the u64 limb image")
        return arr.view(np.uint32).reshape(*arr.shape, 2)
    raise ValueError(f"unknown form {form!r}")


def _wire_dtype(codec: str, dtype: str) -> str:
    """Wire dtype of the payload and base of a codec's Encoded: rle's run
    index and dict's codes ride a u16 stream whatever the column dtype."""
    return "u16" if codec in ("rle", "dict") else dtype


def _param_dtype(key: str, codec: str, dtype: str):
    """FastLanes dtype of an array param's elements (None: the int64 run
    counts, carried as they are)."""
    if key == "base":
        return _wire_dtype(codec, dtype)
    if key in ("run_values", "dictionary"):
        return dtype
    return None


#: params of an alp Encoded that stay on the host as they are on both sides:
#: the exception positions and values (numpy), the value dtype's name, the
#: shape. (`e`, `f` and `reference` are ints like any scalar param.)
_HOST_PARAMS = ("exc_pos", "exc_val", "vtype", "shape")


def encoded_from_reference(enc, device=None):
    """An `Encoded` of the JAX package, its fields as numpy arrays (anything
    with `codec`, `dtype`, `width`, `n_blocks`, `payload` and `params`; u64
    payloads and bases as `uint64` or as the limb image, the payload of an
    alp f64 column included), -> the port's `Encoded` with payload and array
    params on `device`; an alp Encoded's exceptions stay host numpy arrays."""
    from .models.codecs import Encoded

    dtype = layout.canon_dtype(enc.dtype)
    device = eng.resolve_device(device)
    payload = from_reference(np.asarray(enc.payload), _wire_dtype(enc.codec, dtype), device)
    params = None
    if enc.params is not None:
        params = {}
        for key, val in enc.params.items():
            if isinstance(val, (int, np.integer)):
                params[key] = int(val)
                continue
            if key in _HOST_PARAMS:
                params[key] = val if isinstance(val, (str, tuple)) else np.asarray(val)
                continue
            pdt = _param_dtype(key, enc.codec, dtype)
            arr = np.asarray(val)
            params[key] = (torch.from_numpy(arr.copy()).to(device) if pdt is None
                           else from_reference(arr, pdt, device))
    return Encoded(enc.codec, dtype, int(enc.width), int(enc.n_blocks), payload, params)


def encoded_to_reference(enc, form: str = "native") -> dict:
    """The port's `Encoded` -> the fields of the JAX package's `Encoded` as a
    dict of numpy arrays and ints (`Encoded(**fields)` there). `form='limbs'`
    gives u64 payloads and bases as the `(..., 2)` uint32 limb image, the
    form the JAX package computes in without x64; run values and the
    dictionary stay `uint64`, as its host-side encoders leave them."""
    def out(tensor, dt, limbs_ok=True):
        use = form if (dt == "u64" and limbs_ok) else "native"
        return to_reference(tensor, dt, form=use)

    dtype = layout.canon_dtype(enc.dtype)
    params = None
    if enc.params is not None:
        params = {}
        for key, val in enc.params.items():
            if not isinstance(val, torch.Tensor):
                params[key] = val
                continue
            pdt = _param_dtype(key, enc.codec, dtype)
            params[key] = (val.detach().cpu().numpy() if pdt is None
                           else out(val, pdt, limbs_ok=key == "base"))
    return {"codec": enc.codec, "dtype": dtype, "width": enc.width,
            "n_blocks": enc.n_blocks,
            "payload": out(enc.payload, _wire_dtype(enc.codec, dtype)),
            "params": params}
