"""Carry a serving index's, a matrix store's or a table store's state
across packages.

The state of a ``SketchIndex`` is its host blocks, not weights: the
bucketized ids and values, the taus and drop counts, the row summaries
and the exact heads, plus the names, the layout parameters and the
private mode's state (its ``DPParams``, budget and privacy ledger).  A
``MatrixSketchStore`` holds its sketches' ids, rows and taus.  A caller
that holds these as numpy arrays — for instance pulled out of the
reference package's objects — gets a port object that answers exactly as
one the port built itself.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.core import CombinedSketch, Sketch
from repro_torch.data import SketchedTableStore
from repro_torch.device import resolve_device

from .sketch_service import MatrixSketchStore, SketchIndex


def index_from_arrays(*, idx, val, tau, dropped, g, kn, head_idx, head_val,
                      head_kept, names: Sequence, dim, m: int, n_buckets: int,
                      slots: int, seed: int, nonfinite: str = "raise",
                      dp=None, privacy_budget=None, ledger=(), dp_rng=None,
                      device=None) -> SketchIndex:
    """Build a port ``SketchIndex`` from host-state arrays.

    ``idx``/``val``: (R, n_buckets, slots) int32/float32; ``tau``,
    ``dropped``, ``g``, ``kn``: (R,); ``head_idx``/``head_val``/
    ``head_kept``: (R, head_h); R >= len(names) rows, of which the first
    len(names) are occupied (the rest are dropped and refilled as
    padding).  ``dim`` is the coordinate universe (None for an empty
    index).  ``dp``, ``privacy_budget`` and ``dp_rng`` are the index's
    private-mode arguments; ``ledger`` is the spent releases as
    ``(label, epsilon, delta, mem_epsilon)`` tuples, charged in order on
    the new index's accountant (strict, as any spend), and the release
    numbering continues after the ledger's ``index-release-*`` entries."""
    D = len(names)
    idx = np.asarray(idx, np.int32)
    if idx.shape[1:] != (n_buckets, slots) or idx.shape[0] < D:
        raise ValueError(f"idx shape {idx.shape} does not hold {D} rows of "
                         f"({n_buckets}, {slots})")
    head_idx = np.asarray(head_idx, np.int64)
    out = SketchIndex(m, n_buckets=n_buckets, slots=slots, seed=seed,
                      initial_capacity=max(idx.shape[0], 1),
                      nonfinite=nonfinite, head_h=head_idx.shape[1], dp=dp,
                      privacy_budget=privacy_budget, dp_rng=dp_rng,
                      device=device)
    while out.capacity < D:
        out._grow()
    out._idx[:D] = idx[:D]
    out._val[:D] = np.asarray(val, np.float32)[:D]
    out._tau[:D] = np.asarray(tau, np.float32)[:D]
    out._dropped[:D] = np.asarray(dropped, np.int32)[:D]
    out._g[:D] = np.asarray(g, np.float32)[:D]
    out._kn[:D] = np.asarray(kn, np.float32)[:D]
    out._head_idx[:D] = head_idx[:D]
    out._head_val[:D] = np.asarray(head_val, np.float32)[:D]
    out._head_kept[:D] = np.asarray(head_kept, bool)[:D]
    out._names = list(names)
    out._name_set = set(out._names)
    if len(out._name_set) != D:
        raise ValueError("names must be unique")
    out._dim = None if dim is None else int(dim)
    out._stats_epoch = 1 if D else 0
    for label, epsilon, delta, mem_epsilon in ledger:
        out.accountant.spend(epsilon, delta, label=label,
                             mem_epsilon=mem_epsilon)
        out._release_count += str(label).startswith("index-release-")
    return out


def store_from_arrays(*, idx, rows, tau, names: Sequence, m: int, dim: int,
                      seed: int, nonfinite: str = "raise",
                      device=None) -> MatrixSketchStore:
    """Build a port ``MatrixSketchStore`` from host-state arrays.

    ``idx``: (R, m) int32; ``rows``: (R, m, dim) float32; ``tau``: (R,);
    R >= len(names) sketches, of which the first len(names) are stored
    (the rest are dropped and refilled as padding)."""
    C = len(names)
    idx = np.asarray(idx, np.int32)
    rows = np.asarray(rows, np.float32)
    if idx.shape[1:] != (m,) or rows.shape[1:] != (m, dim) or idx.shape[0] < C:
        raise ValueError(f"idx {idx.shape} / rows {rows.shape} do not hold "
                         f"{C} sketches of ({m},) ids and ({m}, {dim}) rows")
    out = MatrixSketchStore(m, dim=dim, seed=seed,
                            initial_capacity=max(C, 1), nonfinite=nonfinite,
                            device=device)
    out._idx[:C] = idx[:C]
    out._rows[:C] = rows[:C]
    out._tau[:C] = np.asarray(tau, np.float32)[:C]
    out._names = list(names)
    out._name_set = set(out._names)
    if len(out._name_set) != C:
        raise ValueError("names must be unique")
    return out


def combined_from_arrays(idx, val, tau_ones, tau_val, tau_sq, scale, *,
                         device=None) -> CombinedSketch:
    """A port ``CombinedSketch`` (one sketch or a leading batch dim) from
    host arrays: int32 ids, float32 values and the four float32
    scalars."""
    dev = resolve_device(device)

    def f32(x):
        return torch.tensor(np.asarray(x, np.float32), device=dev)

    return CombinedSketch(torch.tensor(np.asarray(idx, np.int32), device=dev),
                          f32(val), f32(tau_ones), f32(tau_val), f32(tau_sq),
                          f32(scale))


def table_store_from_arrays(*, names: Sequence, ip, corr, freq,
                            universe: int, m: int, seed: int,
                            device=None) -> SketchedTableStore:
    """Build a port ``SketchedTableStore`` from host-state arrays.

    ``ip`` and ``freq``: ``(idx, val, tau)`` of the value and key-count
    priority sketches, stacked (len(names), m) / (len(names),); ``corr``:
    ``(idx, val, tau_ones, tau_val, tau_sq, scale)`` of the combined
    sketches, stacked the same way; row i belongs to ``names[i]``."""
    out = SketchedTableStore(universe=universe, m=m, seed=seed,
                             device=device)
    if len(set(names)) != len(names):
        raise ValueError("names must be unique")
    dev = out.device
    def sketches(arrays) -> Sketch:
        return Sketch(*(torch.tensor(np.asarray(x, t), device=dev) for x, t
                        in zip(arrays, (np.int32, np.float32, np.float32))))

    ip_s, freq_s = sketches(ip), sketches(freq)
    corr_s = combined_from_arrays(*corr, device=dev)
    for i, name in enumerate(names):
        out._ip[name] = Sketch(*(f[i] for f in ip_s))
        out._freq[name] = Sketch(*(f[i] for f in freq_s))
        out._corr[name] = CombinedSketch(*(f[i] for f in corr_s))
    return out
