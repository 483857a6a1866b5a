"""`h2d_host_ms_per_call` of the lineitem-q6 cell, where it is kept per layer: there
the host's speed moves values_per_s between runs by more than its bound can
hold, so the cell's end-to-end metrics are setup_s and memory_peak_mb and its
speed is read here, from the traced run."""

from .h2d_host_ms_per_call import read  # noqa: F401
