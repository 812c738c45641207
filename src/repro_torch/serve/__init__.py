"""Serving: the sketch index (plain mode) and its state conversion."""
from .convert import index_from_arrays
from .sketch_service import SketchIndex

__all__ = ["SketchIndex", "index_from_arrays"]
