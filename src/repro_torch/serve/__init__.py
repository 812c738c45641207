"""Serving: the sketch index (plain mode), the matrix sketch store and
their state conversion."""
from .convert import index_from_arrays, store_from_arrays
from .sketch_service import MatrixSketchStore, SketchIndex

__all__ = ["MatrixSketchStore", "SketchIndex", "index_from_arrays",
           "store_from_arrays"]
