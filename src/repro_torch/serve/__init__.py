"""Serving: the batched LM engine, the sketch index (plain, bias-aware
and private modes), its sharded form, bound-pruned top-k discovery over
either, the matrix sketch store, the resilience layer (snapshots, the
ingest journal, the durable index, degraded-mode reads over coordinate
and row shards under a guarded fan-out), and the state conversion of the
indexes, the table store and its combined sketches."""
from .engine import Engine, Request
from .convert import (combined_from_arrays, index_from_arrays,
                      store_from_arrays, table_store_from_arrays)
from .sketch_service import (MatrixSketchStore, ShardedSketchIndex,
                             SketchIndex)
from .discovery import (DiscoveryEngine, DiscoveryResult, ScanStats,
                        ShardedDiscoveryEngine, TileSummaries)
from .resilience import (DegradedResult, DegradedServiceError,
                         DurableSketchIndex, IngestJournal, ResilienceError,
                         ResilientMatrixStore, ResilientSketchIndex,
                         RetryPolicy, ShardDownError, ShardHealth,
                         SnapshotCorruptionError, SnapshotReadError,
                         list_snapshots, load_latest_snapshot, load_snapshot,
                         quarantine_snapshot, save_snapshot)

__all__ = ["Engine", "Request",
           "MatrixSketchStore", "ShardedSketchIndex", "SketchIndex",
           "DiscoveryEngine", "DiscoveryResult", "ScanStats",
           "ShardedDiscoveryEngine", "TileSummaries",
           "DegradedResult", "DegradedServiceError", "DurableSketchIndex",
           "IngestJournal", "ResilienceError", "ResilientMatrixStore",
           "ResilientSketchIndex", "RetryPolicy", "ShardDownError",
           "ShardHealth", "SnapshotCorruptionError", "SnapshotReadError",
           "list_snapshots", "load_latest_snapshot", "load_snapshot",
           "quarantine_snapshot", "save_snapshot",
           "combined_from_arrays", "index_from_arrays", "store_from_arrays",
           "table_store_from_arrays"]
