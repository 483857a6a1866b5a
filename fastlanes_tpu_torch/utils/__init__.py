"""Utilities: golden-vector helpers, timing, serialization, trace spans."""

from . import serialization, testing, timing, trace
from .serialization import load_encoded, save_encoded

__all__ = ["serialization", "testing", "timing", "trace", "save_encoded", "load_encoded"]
