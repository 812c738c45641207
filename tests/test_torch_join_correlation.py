"""Port parity: join correlation (``core.join_correlation``), the
linear-time combined builds (``kernels.sketch_build.combined``), the
combined merge and ``serve.combined_from_arrays``.

The same numpy inputs go through ``repro`` (JAX on the CPU; the all-pairs
moments kernel in interpret mode) and ``repro_torch`` (``device="cpu"``).
Contract: each priority route bit-equal to the reference's same route
(idx, val, taus, scale); threshold kept sets and values bit-equal with the
taus within rtol 1e-6 (float32 sums in another order, as the reference's
own ``tests/test_sketch_build.py``); estimates within ``RTOL`` /
``atol_for``; correlation matrices within 1e-4 of the reference's and
1e-5 of the per-pair estimator.

One block of edge rows and correlated pairs is sketched once a module by
each package and route (the reference's builds compile once a shape)."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from _torch_common import RTOL, assert_bits, atol_for, to_np
from _torch_common import release_jax_executables  # noqa: F401

import repro.core as jc
from repro.core.join_correlation import (
    combined_estimates_matrix as j_estimates_matrix,
    combined_sketch_corpus as j_corpus)
from repro.kernels.sketch_build import (
    build_combined_priority_corpus as j_fused_priority,
    build_combined_threshold_corpus as j_fused_threshold)
from repro_torch.core import (CombinedSketch, combined_estimates,
                              combined_estimates_matrix,
                              combined_priority_sketch,
                              combined_sketch_corpus,
                              combined_threshold_sketch,
                              correlation_from_estimates, correlation_matrix,
                              default_capacity, empirical_correlation,
                              estimate_join_correlation,
                              merge_combined_sketches, priority_sketch)
from repro_torch.core.hashing import hash_unit
from repro_torch.core.join_correlation import _bucketized_moment_inputs
from repro_torch.data import correlated_pair
from repro_torch.kernels import (build_combined_priority_corpus,
                                 build_combined_threshold_corpus)
from repro_torch.serve import combined_from_arrays

M, N = 48, 4096
TIE, PAIRS = 6, 7        # the tie row; the first of three correlated pairs
CUT = N // 2             # the merge's parts split by coordinate here


def _tie_seed_and_row(rng):
    """A seed and a row whose ones-family ranks (the hash units of its
    nonzeros) tie at the (m+1)-th smallest: two coordinates with one
    24-bit hash unit, m - 1 nonzeros below them, 200 above."""
    for seed in range(200):
        h = to_np(hash_unit(seed, torch.arange(N, dtype=torch.int32)))
        u, cnt = np.unique(h, return_counts=True)
        for t in u[cnt > 1]:
            below, above = np.flatnonzero(h < t), np.flatnonzero(h > t)
            if len(below) >= M - 1 and len(above) >= 200:
                sup = np.concatenate([np.flatnonzero(h == t)[:2],
                                      rng.choice(below, M - 1, False),
                                      rng.choice(above, 200, False)])
                row = np.zeros(N, np.float32)
                row[sup] = rng.uniform(0.5, 1.0, len(sup))
                return seed, row
    raise AssertionError("no hash-unit tie found")


def _edge_block(rng) -> np.ndarray:
    """(6, N): an all-zero row, a row of m - 3 nonzeros (keep-all, inf
    taus), a heavy-tailed row (one 1e6 among ~2000 values near 1e-4, so
    (a/scale)^4 is subnormal there) with subnormal inputs too, and three
    Gaussian rows at 40% density."""
    A = rng.standard_normal((6, N)).astype(np.float32)
    A[rng.random(A.shape) < 0.6] = 0.0
    A[0] = 0.0
    A[1] = 0.0
    A[1, rng.choice(N, M - 3, replace=False)] = 1.5
    A[2] = (rng.random(N) * 1e-4).astype(np.float32)
    A[2, rng.random(N) < 0.5] = 0.0
    A[2, 7] = 1e6
    A[2, 11:14] = (1e-40, -1e-39, 1e-20)
    return A


def _fields_equal(got: CombinedSketch, ref, *, tau_rtol=None):
    for f in CombinedSketch._fields:
        g, r = to_np(getattr(got, f)), np.asarray(getattr(ref, f))
        if f.startswith("tau") and tau_rtol is not None:
            inf = np.isinf(g) & np.isinf(r)
            np.testing.assert_allclose(np.where(inf, 0, g),
                                       np.where(inf, 0, r), rtol=tau_rtol)
        else:
            assert_bits(g, r)


def _to_torch(s) -> CombinedSketch:
    return CombinedSketch(*(torch.as_tensor(np.array(f)) for f in s))


def _rows(s, rows):
    return type(s)(*(f[rows] for f in s))


def _tau_rtol(method):
    return None if method == "priority" else 1e-6


@pytest.fixture(scope="module")
def block():
    """(13, N): the edge rows, the tie row, three correlated pairs (the
    first pair's ``a`` scaled by 40, so merged parts renormalize); the
    tie row's seed is the module's seed."""
    rng = np.random.default_rng(19)
    seed, tie_row = _tie_seed_and_row(rng)
    pairs = [v for rho in (-0.8, 0.1, 0.7)
             for v in correlated_pair(rng, N, 1200, 0.5, rho)]
    A = np.concatenate([_edge_block(rng), tie_row[None],
                        np.stack(pairs)]).astype(np.float32)
    A[PAIRS] *= np.float32(40.0)
    return A, seed


@pytest.fixture(scope="module")
def legacy(block):
    """Both packages' legacy corpora of the block, by method."""
    A, seed = block
    return {method: (combined_sketch_corpus(A, M, seed, method=method,
                                            device="cpu"),
                     j_corpus(jnp.asarray(A), M, seed, method=method))
            for method in ("priority", "threshold")}


# ------------------------------------------------------------- builders


@pytest.mark.parametrize("method", ["priority", "threshold"])
def test_legacy_builders_bit_equal(block, legacy, method):
    A, seed = block
    got, ref = legacy[method]
    _fields_equal(got, ref, tau_rtol=_tau_rtol(method))
    one = (combined_priority_sketch if method == "priority"
           else combined_threshold_sketch)(torch.as_tensor(A[3]), M, seed)
    _fields_equal(one, _rows(ref, 3), tau_rtol=_tau_rtol(method))


@pytest.mark.parametrize("method", ["priority", "threshold"])
def test_fused_builds_bit_equal(block, method):
    """Every row of the block, the tie row with ones-family rank ties at
    the cut included."""
    A, seed = block
    ours = (build_combined_priority_corpus if method == "priority"
            else build_combined_threshold_corpus)
    theirs = j_fused_priority if method == "priority" else j_fused_threshold
    got = ours(A, M, seed, device="cpu")
    _fields_equal(got, theirs(jnp.asarray(A), M, seed),
                  tau_rtol=_tau_rtol(method))
    # the plain versions of the kernels give the same bits
    _fields_equal(ours(A, M, seed, device="cpu", use_kernel=False), got)


def test_fused_priority_short_rows():
    """n < m + 1: every nonzero kept, inf taus."""
    B = np.random.default_rng(3).standard_normal((2, 40)).astype(np.float32)
    got = build_combined_priority_corpus(B, M, 5, device="cpu")
    _fields_equal(got, j_fused_priority(jnp.asarray(B), M, 5))
    assert torch.isinf(got.tau_sq).all()


def test_tie_row_routes_each_match_their_reference(block, legacy):
    """The legacy route on the tie row, one vector, against the
    reference's legacy builder (the fused route's tie row is in
    ``test_fused_builds_bit_equal``; the two routes need not agree)."""
    A, seed = block
    _fields_equal(combined_priority_sketch(torch.as_tensor(A[TIE]), M, seed),
                  _rows(legacy["priority"][1], TIE))


def test_capacities_follow_m(block, legacy):
    """Priority sketches hold m entries and threshold sketches
    m + 4 ceil(sqrt(m)) on every route; a merge holds the larger part's
    capacity."""
    A, seed = block
    P, T = legacy["priority"][0], legacy["threshold"][0]
    assert default_capacity(M) > M
    assert P.capacity == M
    assert T.capacity == default_capacity(M)
    assert build_combined_priority_corpus(A, M, seed,
                                          device="cpu").capacity == M
    assert build_combined_threshold_corpus(
        A, M, seed, device="cpu").capacity == default_capacity(M)
    assert combined_threshold_sketch(torch.as_tensor(A[3]), M,
                                     seed).capacity == default_capacity(M)
    assert merge_combined_sketches(P, P, seed, m=M).capacity == M
    assert merge_combined_sketches(P, T, seed, m=M).capacity == \
        default_capacity(M)


# ------------------------------------------------------------ estimates


@pytest.mark.parametrize("method", ["priority", "threshold"])
def test_combined_estimates_and_correlation(legacy, method):
    _, ref = legacy[method]
    for i in range(PAIRS, PAIRS + 6, 2):
        sa, sb = _rows(ref, i), _rows(ref, i + 1)
        want = jc.combined_estimates(sa, sb)
        got = combined_estimates(_to_torch(sa), _to_torch(sb))
        for k, v in want.items():
            np.testing.assert_allclose(to_np(got[k]), np.asarray(v),
                                       rtol=RTOL, atol=atol_for(v))
        np.testing.assert_allclose(
            float(estimate_join_correlation(_to_torch(sa), _to_torch(sb))),
            float(jc.estimate_join_correlation(sa, sb)), atol=1e-5)


def test_correlation_matrix_both_backends(legacy):
    """The three pairs' six rows: the moments and the correlations of
    both backends against the reference's both backends (its all-pairs
    kernel in interpret mode, run once)."""
    rows = slice(PAIRS, PAIRS + 6)
    S = _rows(legacy["priority"][0], rows)
    jS = _rows(legacy["priority"][1], rows)
    kw = dict(n_buckets=64, slots=4)
    got, ref = {}, {}
    for ours, theirs in (("reference", "reference"), ("kernel", "pallas")):
        e = combined_estimates_matrix(S, S, backend=ours, **kw)
        w = j_estimates_matrix(jS, jS, backend=theirs, **kw)
        for k, v in w.items():
            np.testing.assert_allclose(to_np(e[k]), np.asarray(v), rtol=RTOL,
                                       atol=atol_for(v))
        got[ours] = to_np(correlation_matrix(S, backend=ours, **kw))
        assert_bits(got[ours], correlation_from_estimates(e))
        ref[ours] = np.asarray(jc.correlation_from_estimates(w))
        np.testing.assert_allclose(got[ours], ref[ours], atol=1e-4)
    per_pair = np.array([[float(estimate_join_correlation(_rows(S, i),
                                                          _rows(S, j)))
                          for j in range(6)] for i in range(6)])
    np.testing.assert_allclose(got["reference"], per_pair, atol=1e-5)
    # where neither row lost an entry to a full bucket, the kernel's
    # matrix is the per-pair estimator's
    dropped = to_np(_bucketized_moment_inputs(S, 64, 4)[3]) > 0
    clean = ~(dropped[:, None] | dropped[None, :])
    assert clean.sum() >= 9
    np.testing.assert_allclose(got["kernel"][clean], per_pair[clean],
                               atol=1e-5)


def test_empirical_correlation(block):
    A, _ = block
    a, b = A[PAIRS + 2], A[PAIRS + 3]
    sa = jc.priority_sketch(jnp.asarray(a), 96, 4, variant="uniform")
    sb = jc.priority_sketch(jnp.asarray(b), 96, 4, variant="uniform")
    ta = priority_sketch(torch.as_tensor(a), 96, 4, variant="uniform")
    tb = priority_sketch(torch.as_tensor(b), 96, 4, variant="uniform")
    assert_bits(ta.idx, sa.idx)
    np.testing.assert_allclose(float(empirical_correlation(ta, tb)),
                               float(jc.empirical_correlation(sa, sb)),
                               atol=1e-5)


# ---------------------------------------------------------------- merge


def test_merge_combined_sketches(block):
    """The block split by coordinate: every row's halves (the edge rows
    and the rescaled pair included) merged by both packages."""
    A, seed = block
    lo, hi = A.copy(), A.copy()
    lo[:, CUT:] = 0.0
    hi[:, :CUT] = 0.0
    parts = [j_corpus(jnp.asarray(x), M, seed) for x in (lo, hi)]
    want = jc.merge_combined_sketches(*parts, seed, m=M)
    got = merge_combined_sketches(*(_to_torch(p) for p in parts), seed, m=M)
    assert_bits(got.idx, want.idx)
    assert_bits(got.val, want.val)
    for f in ("tau_ones", "tau_val", "tau_sq", "scale"):
        np.testing.assert_allclose(to_np(getattr(got, f)),
                                   np.asarray(getattr(want, f)), rtol=1e-6)
    # single sketches lift and squeeze
    one = merge_combined_sketches(_to_torch(_rows(parts[0], PAIRS)),
                                  _to_torch(_rows(parts[1], PAIRS)), seed,
                                  m=M)
    assert_bits(one.idx, got.idx[PAIRS])


def test_combined_from_arrays_round_trip(block, legacy):
    A, seed = block
    jP = legacy["priority"][1]
    sa, sb = _rows(jP, PAIRS + 4), _rows(jP, PAIRS + 5)
    ta, tb = (combined_from_arrays(*(np.asarray(f) for f in s), device="cpu")
              for s in (sa, sb))
    _fields_equal(ta, sa)
    np.testing.assert_allclose(float(estimate_join_correlation(ta, tb)),
                               float(jc.estimate_join_correlation(sa, sb)),
                               atol=1e-5)
    # a port sketch joins with a reference one
    mine = combined_priority_sketch(torch.as_tensor(A[PAIRS + 5]), M, seed)
    np.testing.assert_allclose(float(estimate_join_correlation(ta, mine)),
                               float(jc.estimate_join_correlation(sa, sb)),
                               atol=1e-5)


def test_combined_sketch_containers_are_the_references():
    """``repro_torch.core.sketches.CombinedSketch`` is the reference's
    five-field container of ``repro.core.sketches`` and the builders'
    ``CombinedSketch`` (``repro_torch.core``) its six-field one of
    ``repro.core.join_correlation``: the same fields in the same order,
    the same capacity and size of a built sketch."""
    import repro.core.sketches as j_sketches
    import repro_torch.core.sketches as t_sketches
    from repro.core.join_correlation import CombinedSketch as JCombined
    assert t_sketches.CombinedSketch._fields == \
        j_sketches.CombinedSketch._fields
    assert CombinedSketch._fields == JCombined._fields
    a = correlated_pair(np.random.default_rng(3), 4000, 300, 0.2, 0.5)[0]
    got = combined_priority_sketch(torch.as_tensor(a), 64, 5)
    ref = jc.combined_priority_sketch(jnp.asarray(a), 64, 5)
    five = t_sketches.CombinedSketch(*got[:5])
    j_five = j_sketches.CombinedSketch(*ref[:5])
    assert five.capacity == j_five.capacity == got.capacity
    assert int(five.size()) == int(j_five.size()) == int(got.size())
    for f in t_sketches.CombinedSketch._fields:
        assert_bits(getattr(five, f), getattr(j_five, f))
