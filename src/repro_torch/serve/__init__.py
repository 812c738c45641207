"""Serving: the sketch index (plain, bias-aware and private modes), its
sharded form, bound-pruned top-k discovery over either with the sharded
fan-out's retry guard, the matrix sketch store, and the state conversion
of those and of the table store and its combined sketches."""
from .convert import (combined_from_arrays, index_from_arrays,
                      store_from_arrays, table_store_from_arrays)
from .resilience import (ResilienceError, RetryPolicy, ShardDownError,
                         ShardHealth)
from .sketch_service import (MatrixSketchStore, ShardedSketchIndex,
                             SketchIndex)
from .discovery import (DiscoveryEngine, DiscoveryResult, ScanStats,
                        ShardedDiscoveryEngine, TileSummaries)

__all__ = ["DiscoveryEngine", "DiscoveryResult", "MatrixSketchStore",
           "ResilienceError", "RetryPolicy", "ScanStats", "ShardDownError",
           "ShardHealth", "ShardedDiscoveryEngine", "ShardedSketchIndex",
           "SketchIndex", "TileSummaries", "combined_from_arrays",
           "index_from_arrays", "store_from_arrays",
           "table_store_from_arrays"]
