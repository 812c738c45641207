"""Quickstart: sketch two vectors, estimate their inner product with a
confidence interval, and check the paper's error guarantees — the port of
``examples/quickstart.py``.

Both sketches are built through the linear-time kernel build
(``backend="kernel"``); the asserts make this an end-to-end smoke test.
The CountSketch baseline at the same storage is printed beside them, not
asserted, as in the example.

    PYTHONPATH=src python -m repro_torch.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core import (chebyshev_interval, countsketch,
                              countsketch_estimate, estimate_inner_product,
                              priority_sketch, threshold_sketch)
from repro_torch.device import resolve_device


def make_vectors(n: int = 100_000, nnz: int = 20_000, seed: int = 0):
    """The example's pair: sparse vectors with 10% support overlap (the
    data-discovery regime)."""
    rng = np.random.default_rng(seed)
    a = np.zeros(n, np.float32)
    b = np.zeros(n, np.float32)
    perm = rng.permutation(n)
    a[perm[:nnz]] = rng.uniform(-1, 1, nnz)
    shared = perm[:nnz // 10]
    b[shared] = 0.8 * a[shared] + 0.2 * rng.standard_normal(len(shared))
    b[perm[nnz:2 * nnz - nnz // 10]] = rng.uniform(-1, 1, nnz - nnz // 10)
    return a, b


M, SEED = 400, 42


def main(device=None) -> dict:
    """Run the example on ``device`` (default ``cuda``); returns the
    estimates and scaled errors after its asserts pass."""
    dev = resolve_device(device)
    m, seed = M, SEED
    a, b = make_vectors()
    true = float(a @ b)
    ta, tb = torch.as_tensor(a, device=dev), torch.as_tensor(b, device=dev)

    # the paper's methods: coordinated (same seed) weighted sampling
    sa = priority_sketch(ta, m, seed, backend="kernel")          # Alg. 3
    sb = priority_sketch(tb, m, seed, backend="kernel")
    est = float(estimate_inner_product(sa, sb))                  # Alg. 2
    lo, hi = chebyshev_interval(est, float(a @ a), float(b @ b), m)
    print(f"true <a,b>            = {true:+.3f}")
    print(f"priority sampling     = {est:+.3f}   95% CI "
          f"[{float(lo):+.1f}, {float(hi):+.1f}]")

    xa = threshold_sketch(ta, m, seed, backend="kernel")         # Alg. 1+4
    xb = threshold_sketch(tb, m, seed, backend="kernel")
    est_t = float(estimate_inner_product(xa, xb))
    print(f"threshold sampling    = {est_t:+.3f}"
          f"   (sketch size {int(xa.size())}, E[size]=m)")

    # the linear-sketch baseline at the same storage (1.5x samples rule)
    ca = countsketch(ta, int(m * 1.5), seed)
    cb = countsketch(tb, int(m * 1.5), seed)
    est_cs = float(countsketch_estimate(ca, cb))
    print(f"CountSketch baseline  = {est_cs:+.3f}")

    # Theorem 1/3 concentration: the scaled error |est - true| /
    # (||a|| ||b||) is O(1/sqrt(m)); 8x covers the tail at this seed
    bound = 8.0 / np.sqrt(m)
    norm = float(np.linalg.norm(a) * np.linalg.norm(b))
    scaled = {"priority": abs(est - true) / norm,
              "threshold": abs(est_t - true) / norm}
    for name, e in scaled.items():
        assert e < bound, f"{name} scaled error {e:.4f} > {bound:.4f}"
    assert int(sa.size()) == m, "priority sketch must have exactly m samples"
    print("error bounds ok")
    return {"true": true, "priority": est, "threshold": est_t,
            "countsketch": est_cs,
            "scaled_error": scaled, "bound": bound,
            "threshold_size": int(xa.size())}


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="cuda (default) or cpu")
    main(parser.parse_args().device)
