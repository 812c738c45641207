"""Differentially-private release of coordinated sampling sketches
(DESIGN.md §20 of the reference), as ``repro.private.release``: host
numpy in float64, with the same random draws in the same order, so the
same ``rng`` gives the reference's release bit for bit.

A raw sketch leaks *exactly which coordinates a row kept* — membership of
a coordinate in the kept set is a deterministic function of that record's
weight.  :func:`private_release` turns any d=1/d>1
:class:`~repro_torch.engine.containers.PayloadSketch` (or legacy ``Sketch``)
into a :class:`PrivateSketch` that can be handed to an untrusted reader.

**Adjacency.**  The unit of protection is one whole input row (one
indexed vector): neighboring datasets swap a single row for another.
This matches the serving accountant's parallel-composition argument —
each row of a corpus release is a disjoint record — and it is what makes
the sensitivity analysis below airtight: swapping a row may change
*every* slot of that row's release (including through the row's
data-dependent ``tau``, which perturbs every ``p_eff`` in the row), and
the noise is calibrated for exactly that.

1. **Horvitz-Thompson rescale at the curator** — released values are
   ``z_i = clip(v_i, ±C) / p_eff_i`` with ``p_eff = clip(p_i, p_floor,
   1)``, computed from the *true* inclusion probability ``p_i = min(1,
   tau w_i)`` before anything is noised.  Every downstream estimator is
   then *linear* in the released values, which is what makes debiasing
   under noise possible at all (Algorithm 2's ``min(p_a, p_b)``
   denominator cannot be privately debiased — see §20).  ``|z| <= Z =
   C / p_floor`` bounds the per-lane magnitude.
2. **Decoy survival filter on membership** — each kept entry survives
   into the release with probability ``q = e^{mem_epsilon} / (1 +
   e^{mem_epsilon})``; every non-surviving slot (dropped, or capacity
   padding) is replaced by a **decoy**: a uniformly random coordinate
   with value 0.  The release always has exactly ``capacity`` slots, so
   neither the sketch size nor which slots are real is visible.  This is
   **appearance deniability, not formal DP** — an absent coordinate can
   only appear as a uniform decoy, so the membership likelihood ratio is
   not bounded by ``e^{mem_epsilon}``.  ``mem_epsilon`` is therefore
   recorded on the ledger as an *informal* annotation and never booked
   as budget (DESIGN.md §20).
3. **Calibrated value noise** — every slot (decoys included) gets
   ``Laplace(scale = 2 capacity d Z / epsilon)`` noise per payload lane:
   swapping one row moves the row's release by at most ``2 capacity d
   Z`` in L1 (``capacity`` slots x ``d`` lanes x ``2 Z`` each), so the
   value channel is ``epsilon``-DP under row-level adjacency.

The formal per-release cost is ``epsilon`` (the value channel alone),
spent on a strict :class:`~repro.private.accountant.PrivacyAccountant`
*before* the release is produced.  Releases of disjoint rows compose in
parallel (one charge covers a whole corpus release); re-releasing after
the data changed is a new sequential charge; querying a cached release
is free post-processing.

**Randomness.**  The ``rng`` that drives survival coins, decoys, and
Laplace noise is *secret curator state*: it must come from OS entropy
(``np.random.default_rng()`` with no seed) or a separately held secret
key.  Deriving it from anything the reader knows — in particular the
public sketch coordination seed — lets the reader replay the mechanism
and invert the release (the serving layer draws from OS entropy by
default; see ``SketchIndex(dp_rng=...)``).

**What is formally protected and what is not** (§20): the released
*values* are ``epsilon``-DP under row-level adjacency, tau-induced
cross-slot effects included (the full-row sensitivity bound covers
them); ``tau`` itself is still withheld from the release.  The released
*support* (which coordinates appear) is protected only by the decoy
mixture of step 2 — deniability, not DP.  The clamp ``C`` and
``p_floor`` must be domain constants, not data-derived.

Estimator unbiasedness (up to the deterministic clamp/floor gap
:func:`repro_torch.core.variance.dp_debias_gap`):

- :func:`estimate_private_dense` — private sketch vs a fully known
  vector: always unbiased (``E[(1/q) sum z~_j b[idx_j]] = sum p_i z_i
  b_i``).
- :func:`estimate_private_product` — private vs private: unbiased only
  when the two sketches were built with **independent seeds**; with
  coordinated seeds the joint inclusion probability is ``min(p_a, p_b)``
  (not ``p_a p_b``) and the released values cannot see the partner's
  ``p``.  Privacy costs the coordination trick — honestly accounted as a
  wider :func:`repro_torch.core.variance.dp_variance_bound`.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Union

import numpy as np

from repro_torch.core.sketches import INVALID_IDX, Sketch

from .accountant import PrivacyAccountant

_VARIANTS = ("l2", "l1", "uniform")


class DPParams(NamedTuple):
    """Release calibration under row-level adjacency (module docstring).

    ``epsilon`` is the **formal** charge, spent entirely on the value
    channel (Laplace noise).  ``mem_epsilon`` tunes the decoy survival
    filter — an *informal* appearance-deniability knob that is recorded
    on the ledger but never booked as budget (the membership channel is
    not a DP mechanism; DESIGN.md §20).  ``clamp`` and ``p_floor`` must
    be domain constants (a data-derived clamp leaks)."""

    epsilon: float = 1.0
    delta: float = 0.0
    mem_epsilon: float = 1.0
    clamp: float = 1.0
    p_floor: float = 0.05

    @property
    def survival(self) -> float:
        """Decoy-filter survival probability
        q = e^mem_epsilon / (1 + e^mem_epsilon)."""
        return math.exp(self.mem_epsilon) / (1.0 + math.exp(self.mem_epsilon))

    @property
    def value_bound(self) -> float:
        """Z = C / p_floor, the released-value magnitude bound."""
        return self.clamp / self.p_floor

    def noise_scale(self, slots: int, d: int = 1) -> float:
        """Laplace scale b = 2 slots d Z / epsilon: swapping one row
        changes all ``slots`` release slots x ``d`` payload lanes, each
        by at most ``2 Z`` in L1 (row-level adjacency)."""
        if slots < 1:
            raise ValueError("slots must be >= 1")
        return 2.0 * slots * d * self.value_bound / self.epsilon

    def validate(self) -> "DPParams":
        if self.epsilon <= 0:
            raise ValueError("epsilon must be positive")
        if self.mem_epsilon <= 0:
            raise ValueError("mem_epsilon must be positive")
        if self.clamp <= 0:
            raise ValueError("clamp must be positive")
        if not (0.0 < self.p_floor <= 1.0):
            raise ValueError("p_floor must be in (0, 1]")
        if self.delta < 0:
            raise ValueError("delta must be nonnegative")
        return self


class PrivateSketch(NamedTuple):
    """A released sketch: coordinates + noised HT-rescaled payloads.

    Deliberately does **not** carry ``tau`` (it leaks the weight profile)
    — the values are pre-rescaled so no estimator needs it.  ``idx`` has
    a fixed ``capacity`` slots (decoys hide size and membership);
    ``z`` is ``(..., capacity)`` for vector releases and
    ``(..., capacity, d)`` for payload releases.
    """

    idx: np.ndarray       # int32 (..., cap): real coords and decoys, mixed
    z: np.ndarray         # f32 noised z-values, 0-mean noise at decoys
    universe: int         # coordinate universe the decoys were drawn from
    params: DPParams

    @property
    def capacity(self) -> int:
        return self.idx.shape[-1]


def _host(x) -> np.ndarray:
    """A tensor (on any device) or array as a numpy array."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _as_rng(rng) -> np.random.Generator:
    if isinstance(rng, np.random.Generator):
        return rng
    return np.random.default_rng(rng)


def _weights(val2d: np.ndarray, variant: str) -> np.ndarray:
    """(..., cap, d) payload -> (..., cap) sampling weight (numpy twin of
    ``repro_torch.engine.containers.payload_weight``)."""
    if variant == "l2":
        return np.sum(val2d * val2d, axis=-1)
    if variant == "l1":
        return np.sum(np.abs(val2d), axis=-1)
    if variant == "uniform":
        return np.any(val2d != 0, axis=-1).astype(np.float32)
    raise ValueError(f"unknown variant {variant!r}; expected {_VARIANTS}")


def private_release_corpus(idx: np.ndarray, val: np.ndarray,
                           tau: np.ndarray, universe: int,
                           params: DPParams, *,
                           rng, variant: str = "l2",
                           accountant: Optional[PrivacyAccountant] = None,
                           label: str = "corpus-release") -> PrivateSketch:
    """Release a whole corpus of disjoint rows in one charge.

    ``idx``: int32 (D, cap); ``val``: f32 (D, cap) or (D, cap, d);
    ``tau``: f32 (D,).  Rows are disjoint records, so the accountant is
    charged **once** (parallel composition) for the whole release.

    ``rng`` is secret curator state: pass OS entropy
    (``np.random.default_rng()``), never anything derived from the
    public sketch seed (module docstring).
    """
    params.validate()
    idx = _host(idx).astype(np.int32, copy=False)
    val = _host(val).astype(np.float32, copy=False)
    vec = val.ndim == idx.ndim          # (D, cap) vector layout
    pay = val[..., None] if vec else val
    d = pay.shape[-1]
    cap = idx.shape[-1]
    tau = _host(tau).astype(np.float32, copy=False).reshape(
        idx.shape[:-1] + (1,))
    if universe < 1:
        raise ValueError("universe must be >= 1")
    if accountant is not None:
        # strict: charge (and possibly raise) before any noise is drawn
        accountant.spend(params.epsilon, params.delta, label=label,
                         mem_epsilon=params.mem_epsilon)
    rng = _as_rng(rng)

    valid = idx != INVALID_IDX
    w = _weights(pay, variant)
    # inf tau * 0 weight at padding: route through `where` to avoid NaN
    with np.errstate(over="ignore", invalid="ignore"):
        p = np.where(valid & (w > 0), np.minimum(1.0, tau * w), 0.0)
    p_eff = np.clip(p, params.p_floor, 1.0)
    z = np.clip(pay, -params.clamp, params.clamp) / p_eff[..., None]
    z = np.where(valid[..., None], z, 0.0)

    survive = valid & (rng.random(idx.shape) < params.survival)
    decoy_idx = rng.integers(0, universe, size=idx.shape, dtype=np.int64)
    out_idx = np.where(survive, idx, decoy_idx.astype(np.int32))
    out_z = np.where(survive[..., None], z, 0.0)
    out_z = out_z + rng.laplace(0.0, params.noise_scale(cap, d),
                                size=out_z.shape)
    out_z = out_z.astype(np.float32)
    if vec:
        out_z = out_z[..., 0]
    # released order must not reveal which slots are real: sort by coord
    order = np.argsort(out_idx, axis=-1, kind="stable")
    out_idx = np.take_along_axis(out_idx, order, axis=-1)
    out_z = np.take_along_axis(
        out_z, order if vec else order[..., None], axis=-1 if vec else -2)
    return PrivateSketch(idx=out_idx, z=out_z, universe=int(universe),
                         params=params)


def private_release(sketch: Union[Sketch, "PayloadSketch"], universe: int,
                    params: DPParams, *, rng,
                    variant: str = "l2",
                    accountant: Optional[PrivacyAccountant] = None,
                    label: str = "release") -> PrivateSketch:
    """Release one sketch (legacy ``Sketch`` or payload-generic
    ``PayloadSketch``); see module docstring for the mechanism."""
    idx = _host(sketch.idx)[None]
    if hasattr(sketch, "payload"):      # engine PayloadSketch
        val = _host(sketch.payload)[None]
    else:                               # core Sketch
        val = _host(sketch.val)[None]
    tau = _host(sketch.tau).reshape(1)
    rel = private_release_corpus(idx, val, tau, universe, params, rng=rng,
                                 variant=variant, accountant=accountant,
                                 label=label)
    return PrivateSketch(idx=rel.idx[0], z=rel.z[0], universe=rel.universe,
                         params=rel.params)


def estimate_private_dense(ps: PrivateSketch, b: np.ndarray) -> np.ndarray:
    """Debiased estimate of ``<a, b>`` from a's release and a fully known
    ``b``: ``(1/q) sum_j z~_j b[idx_j]``.

    Unbiased for the clamped/floored target ``sum_i p_i z_i b_i`` —
    decoys and the Laplace noise are zero-mean, RR survival divides out.
    Supports a leading batch axis on ``ps`` ((D, cap) releases -> (D,)
    estimates).
    """
    if ps.z.ndim > ps.idx.ndim:
        raise ValueError("dense estimation is defined for d=1 releases")
    b = _host(b).astype(np.float64)
    terms = np.asarray(ps.z, np.float64) * b[np.asarray(ps.idx, np.int64)]
    return terms.sum(axis=-1) / ps.params.survival


def estimate_private_product(pa: PrivateSketch,
                             pb: PrivateSketch) -> float:
    """Debiased private x private estimate: ``(1/(q_a q_b)) sum_{idx
    match} z~_a z~_b``.

    Requires the two releases to come from **independently seeded**
    sketches (coordinated seeds bias the joint inclusion through
    ``min(p_a, p_b)`` — DESIGN.md §20); the caller owns that contract.
    Noise-noise and decoy cross terms are zero-mean, so the estimate is
    unbiased for ``sum_i (p_a p_b z_a z_b)_i`` = the clamp/floor target.
    Defined for single-row d=1 releases only (the sorted-join below
    would silently mix coordinates across rows of a batched release).
    """
    if pa.universe != pb.universe:
        raise ValueError("releases must share a coordinate universe")
    if pa.idx.ndim != 1 or pb.idx.ndim != 1 \
            or pa.z.ndim != 1 or pb.z.ndim != 1:
        raise ValueError(
            "estimate_private_product needs two single-row d=1 releases "
            f"(1-D idx/z); got idx {pa.idx.shape} x {pb.idx.shape}, "
            f"z {pa.z.shape} x {pb.z.shape}")
    ia = np.asarray(pa.idx, np.int64)
    ib = np.asarray(pb.idx, np.int64)
    za = np.asarray(pa.z, np.float64)
    zb = np.asarray(pb.z, np.float64)
    # both sides may hold duplicate coords (decoy collisions): join on the
    # sorted b side, summing b-side duplicates per unique coordinate
    uniq, start = np.unique(ib, return_index=True)
    csum = np.concatenate([[0.0], np.cumsum(zb)])
    end = np.concatenate([start[1:], [ib.size]])
    per_coord = csum[end] - csum[start]          # sum of zb per unique coord
    upos = np.searchsorted(uniq, ia)
    upos = np.clip(upos, 0, uniq.size - 1)
    match = uniq[upos] == ia
    est = float(np.sum(np.where(match, za * per_coord[upos], 0.0)))
    return est / (pa.params.survival * pb.params.survival)
