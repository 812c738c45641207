"""The paper's own workload: sketching/estimation over sparse vectors.

Used by the benchmark harness (Section 5 settings) and by the SketchDP
gradient-compression configuration in the distributed runtime."""
from dataclasses import dataclass


@dataclass(frozen=True)
class SketchWorkloadConfig:
    n: int = 250_000           # vector length (runtime experiment, Fig 7)
    nnz: int = 50_000          # non-zero entries
    outlier_frac: float = 0.10
    sketch_sizes: tuple = (100, 200, 400, 800, 1600, 3200, 5000)
    # Section 5.1 accuracy experiments
    acc_n: int = 100_000
    acc_nnz: int = 20_000
    acc_outlier_frac: float = 0.02
    acc_outlier_scale: float = 10.0
    overlaps: tuple = (0.01, 0.05, 0.1, 0.2, 0.5, 1.0)
    n_pairs: int = 100


CONFIG = SketchWorkloadConfig()
