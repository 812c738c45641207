"""Input hardening shared by the serving layer (DESIGN.md §16 of the
reference; a copy of ``repro.serve.validation`` on the port's obs).

Bad input is a fault class like any other: a single NaN ingested into a
sketch poisons every estimate it later participates in (NaN sampling ranks
propagate through the rank selection), a wrong-length query silently
estimates against the wrong coordinate universe, and a duplicate name
double-counts in ``all_pairs``.  Every ingest/read surface of
``repro.serve`` funnels through these checks so the failure is a clear
``ValueError`` at the boundary, not garbage estimates downstream.
"""
from __future__ import annotations

import numpy as np

from repro_torch import obs

NONFINITE_POLICIES = ("raise", "sanitize")


def _reject(check: str) -> None:
    """Count a boundary rejection (immediately before the ValueError)."""
    obs.counter("repro_validation_rejects_total", check)


def check_nonfinite_policy(policy: str) -> str:
    if policy not in NONFINITE_POLICIES:
        _reject("policy")
        raise ValueError(f"nonfinite policy must be one of "
                         f"{NONFINITE_POLICIES}, got {policy!r}")
    return policy


def check_finite(arr, what: str, *, nonfinite: str = "raise") -> np.ndarray:
    """Return ``arr`` as float32 with NaN/Inf either rejected (``'raise'``,
    a clear ValueError naming the offending input) or zeroed
    (``'sanitize'`` — a zero value has sampling weight 0 and can never be
    selected, so sanitized entries simply drop out of the sketch)."""
    arr = np.asarray(arr, np.float32)
    bad = ~np.isfinite(arr)
    if bad.any():
        if nonfinite == "sanitize":
            obs.counter("repro_validation_sanitized_total",
                        n=int(bad.sum()))
            return np.where(bad, np.float32(0), arr)
        _reject("nonfinite")
        raise ValueError(
            f"{what} contains {int(bad.sum())} non-finite value(s) "
            f"(NaN/Inf) out of {arr.size}; clean the input or construct "
            "with nonfinite='sanitize' to zero them")
    return arr


def check_vector(vector, what: str, *, dim=None,
                 nonfinite: str = "raise") -> np.ndarray:
    """1-D shape + finiteness + (known) coordinate-universe size check."""
    vector = np.asarray(vector, np.float32)
    if vector.ndim != 1:
        _reject("shape")
        raise ValueError(f"{what} must be 1-D, got shape {vector.shape}")
    if dim is not None and vector.shape[0] != dim:
        _reject("dim")
        raise ValueError(f"{what} has {vector.shape[0]} coordinates but "
                         f"this index was built over {dim} — estimates "
                         "across different universes are meaningless")
    return check_finite(vector, what, nonfinite=nonfinite)


def check_sparse(indices, values, *, dim=None,
                 nonfinite: str = "raise") -> tuple:
    """Validate an ``(indices, values)`` sparse column: equal-length 1-D,
    non-negative strictly-ascending coordinates (duplicates would be
    sketched twice), in-universe when the universe size is known."""
    indices = np.asarray(indices, np.int32)
    values = np.asarray(values, np.float32)
    if indices.shape != values.shape or indices.ndim != 1:
        _reject("shape")
        raise ValueError("indices/values must be equal-length 1-D")
    if indices.size:
        if int(indices.min()) < 0:
            _reject("sparse_index")
            raise ValueError("sparse indices must be non-negative")
        if np.any(np.diff(indices) <= 0):
            _reject("sparse_index")
            raise ValueError("sparse indices must be strictly ascending "
                             "(duplicate coordinates would be double-"
                             "sketched)")
        if dim is not None and int(indices.max()) >= dim:
            _reject("sparse_index")
            raise ValueError(f"sparse index {int(indices.max())} out of "
                             f"range for a {dim}-coordinate universe")
    values = check_finite(values, "sparse values", nonfinite=nonfinite)
    return indices, values


def check_unique_name(name, existing, *, what: str = "index") -> None:
    if name in existing:
        _reject("duplicate_name")
        raise ValueError(f"duplicate name {name!r}: already present in "
                         f"this {what} — a second copy would double-count "
                         "in all_pairs/query results")


def check_unique_names(names, existing, *, what: str = "index") -> None:
    seen = set()
    for name in names:
        if name in seen:
            _reject("duplicate_name")
            raise ValueError(f"duplicate name {name!r} within the batch")
        seen.add(name)
        check_unique_name(name, existing, what=what)
