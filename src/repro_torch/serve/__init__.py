"""Serving: the sketch index (plain, bias-aware and private modes), the
matrix sketch store, and the state conversion of those and of the table
store and its combined sketches."""
from .convert import (combined_from_arrays, index_from_arrays,
                      store_from_arrays, table_store_from_arrays)
from .sketch_service import MatrixSketchStore, SketchIndex

__all__ = ["MatrixSketchStore", "SketchIndex", "combined_from_arrays",
           "index_from_arrays", "store_from_arrays",
           "table_store_from_arrays"]
