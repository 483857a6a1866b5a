"""Utilities: golden-vector helpers, timing, serialization."""

from . import serialization, testing, timing
from .serialization import load_encoded, save_encoded

__all__ = ["serialization", "testing", "timing", "save_encoded", "load_encoded"]
