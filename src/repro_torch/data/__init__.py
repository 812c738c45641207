"""Data substrate: token pipelines, the table store and the paper's
synthetic data generators."""
from .pipeline import BinTokenSource, Prefetcher, SyntheticLM
from .synthetic import correlated_pair, vector_pair, zipf_frequency_tables
from .tables import SketchedTableStore, column_to_vector

__all__ = ["BinTokenSource", "Prefetcher", "SyntheticLM", "correlated_pair",
           "vector_pair", "zipf_frequency_tables", "SketchedTableStore",
           "column_to_vector"]
