"""Serving: the sketch index (plain, bias-aware and private modes) and its
bound-pruned top-k discovery, the matrix sketch store, and the state
conversion of those and of the table store and its combined sketches."""
from .convert import (combined_from_arrays, index_from_arrays,
                      store_from_arrays, table_store_from_arrays)
from .sketch_service import MatrixSketchStore, SketchIndex
from .discovery import (DiscoveryEngine, DiscoveryResult, ScanStats,
                        TileSummaries)

__all__ = ["DiscoveryEngine", "DiscoveryResult", "MatrixSketchStore",
           "ScanStats", "SketchIndex", "TileSummaries",
           "combined_from_arrays", "index_from_arrays", "store_from_arrays",
           "table_store_from_arrays"]
