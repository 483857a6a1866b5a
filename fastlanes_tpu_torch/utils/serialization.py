"""Persistence for Encoded batches: a minimal container format.

The port of fastlanes_tpu/utils/serialization.py, and the same file: the
packed payload is the wire format (byte-identical to the Rust crate per
block); this module only adds a self-describing envelope (codec name, dtype,
width, params) via .npz. A file that either package saves loads in the
other and decodes to the same values: the arrays are written in the forms
the JAX package writes (a u64 payload or base as its `(..., 2)` uint32 limb
image), through `convert.encoded_to_reference` / `encoded_from_reference`.
"""

from __future__ import annotations

import json
import types

import numpy as np

from .. import convert
from ..core import layout

_FORMAT_VERSION = 1


def save_encoded(path: str, enc) -> None:
    """Write the port's `Encoded` (payload on any device) to `path`."""
    fields = convert.encoded_to_reference(enc, form="limbs")
    meta = {
        "version": _FORMAT_VERSION,
        "codec": fields["codec"],
        "dtype": fields["dtype"],
        "width": int(fields["width"]),
        "n_blocks": int(fields["n_blocks"]),
    }
    arrays = {"payload": np.asarray(fields["payload"])}
    for key, val in (fields["params"] or {}).items():
        if isinstance(val, (int, np.integer)):
            meta[f"param_int_{key}"] = int(val)
        elif isinstance(val, str):
            meta[f"param_str_{key}"] = val  # e.g. ALP vtype
        elif isinstance(val, tuple):
            meta[f"param_tup_{key}"] = list(val)  # e.g. ALP value shape
        else:
            arrays[f"param_arr_{key}"] = np.asarray(val)
    np.savez(path, __meta__=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8),
             **arrays)


def load_encoded(path: str, device=None):
    """Read an `Encoded` that either package saved; payload and array params
    on `device` (None: the GPU, raising without one)."""
    with np.load(path) as data:
        meta = json.loads(bytes(data["__meta__"]).decode())
        if meta["version"] != _FORMAT_VERSION:
            raise ValueError(f"unsupported format version {meta['version']}")
        params = {}
        for key in data.files:
            if key.startswith("param_arr_"):
                params[key[len("param_arr_"):]] = data[key]
        for key, val in meta.items():
            if key.startswith("param_int_"):
                params[key[len("param_int_"):]] = val
            elif key.startswith("param_str_"):
                params[key[len("param_str_"):]] = val
            elif key.startswith("param_tup_"):
                params[key[len("param_tup_"):]] = tuple(val)
        layout.check_width(meta["dtype"], meta["width"])
        fields = types.SimpleNamespace(
            codec=meta["codec"], dtype=meta["dtype"], width=meta["width"],
            n_blocks=meta["n_blocks"], payload=data["payload"], params=params or None)
        return convert.encoded_from_reference(fields, device)
