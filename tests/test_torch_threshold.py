"""Port parity: threshold sampling (Algorithms 1+4) and its linear-time
build, the hash/rank kernel's plain version, batched sketching, the
variance helpers and the quickstart port.

The same numpy inputs go through ``repro`` (JAX on the CPU; the Pallas
kernels in interpret mode) and ``repro_torch`` (``device="cpu"``, the
kernels' plain versions).  Contract per output: ids, values and kept sets
bit for bit; the adaptive tau within rtol 1e-6 (1e-5 where the reference's
own tests allow it), since it comes from float sums taken over other sets
of terms; the non-adaptive tau and the sort-form adaptive tau of one
vector likewise.  The CUDA kernel is held against the plain version on the
card (``test_torch_cuda.py``)."""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from parity._grid import Case, MATRIX_CASES, VECTOR_CASES, make_payloads
from _torch_common import assert_bits, edge_values, sparse_block, to_np
from _torch_common import release_jax_executables  # noqa: F401

import repro.core as jc
from repro.engine import build_payload_corpus as j_build_payload
from repro.kernels import build_threshold_corpus as j_build_threshold
from repro.kernels import hash_rank as j_hash_rank
from repro.kernels import hash_rank_batched as j_hash_rank_batched
from repro_torch import quickstart
from repro_torch.core import (adaptive_tau, chebyshev_interval,
                              error_guarantee, intersection_norms,
                              linear_sketch_error, rescaled_kept_norms,
                              sketch_corpus, sketch_size_high_prob,
                              threshold_sketch, variance_bound)
from repro_torch.core.threshold import suffix_sums
from repro_torch.engine import build_payload_corpus
from repro_torch.kernels import hash_rank, hash_rank_batched
from repro_torch.kernels.hash_rank import (hash_rank_batched_ref,
                                           hash_rank_ref)
from repro_torch.kernels.sketch_build import (adaptive_tau_batched,
                                              build_threshold_corpus,
                                              build_threshold_corpus_ref,
                                              kth_smallest_ranks)

THRESHOLD_CASES = [c for c in VECTOR_CASES if c.method == "threshold"]
MATRIX_THRESHOLD = [c for c in MATRIX_CASES if c.method == "threshold"] + [
    Case("threshold-l2-n200-m12-d2-dense", "threshold", "l2", 200, 12, 2,
         "dense")]


def _assert_tau(got, ref, rtol):
    got, ref = to_np(got), np.asarray(ref)
    both_inf = np.isinf(got) & np.isinf(ref)
    np.testing.assert_allclose(np.where(both_inf, 0, got),
                               np.where(both_inf, 0, ref), rtol=rtol)


def _assert_threshold(got, ref, rtol=1e-6):
    """Same kept set and values; tau within ``rtol``."""
    assert_bits(got.idx, ref.idx)
    assert_bits(got.val if hasattr(got, "val") else got.payload,
                ref.val if hasattr(ref, "val") else ref.payload)
    _assert_tau(got.tau, ref.tau, rtol)


def _corpus(rng, D=6, n=3000, density=0.3):
    A = rng.standard_normal((D, n)).astype(np.float32)
    return np.where(rng.random((D, n)) < density, A, 0.0).astype(np.float32)


# ------------------------------------------------------ B3, plain version


ONE_VECTOR_N = 30000   # Fig. 10's key space: the join path's single vectors


@pytest.mark.parametrize("variant", ["l2", "l1", "uniform"])
@pytest.mark.parametrize("n", [2048, 3000 + 77, ONE_VECTOR_N])
def test_hash_rank_plain_matches_pallas(variant, n):
    """Both forms against the Pallas kernels in interpret mode, with zeros
    and the flush-to-zero traps among the values; the wrappers take the
    plain version for CPU tensors.  At the join path's n the block is one
    vector (D = 1, the kernel's spread route on the card)."""
    rng = np.random.default_rng(n)
    D = 1 if n == ONE_VECTOR_N else 3
    A = edge_values(rng, D, n)
    h_j, r_j = j_hash_rank_batched(jnp.asarray(A), 0xB0C4, variant=variant,
                                   use_pallas=True)
    h_t, r_t = hash_rank_batched_ref(torch.as_tensor(A), 0xB0C4,
                                     variant=variant)
    assert_bits(h_t, h_j)
    assert_bits(r_t, r_j)
    for got in (hash_rank_batched(torch.as_tensor(A), 0xB0C4,
                                  variant=variant),):
        assert_bits(got[0], h_j)
        assert_bits(got[1], r_j)
    row = A[D // 2]
    h1_j, r1_j = j_hash_rank(jnp.asarray(row), 7, variant=variant,
                             use_pallas=True)
    for h1_t, r1_t in (hash_rank_ref(torch.as_tensor(row), 7,
                                     variant=variant),
                       hash_rank(torch.as_tensor(row), 7, variant=variant)):
        assert_bits(h1_t, h1_j)
        assert_bits(r1_t, r1_j)


def test_suffix_sums_follow_reference_order():
    """The port's float32 scan gives the bits of the reference's reversed
    ``jnp.cumsum`` (the adaptive closed form's suffix sums)."""
    rng = np.random.default_rng(3)
    f = jax.jit(lambda x: jnp.cumsum(x[:, ::-1], axis=1)[:, ::-1])
    for K in (1, 16, 17, 256, 321, 4098):
        x = (rng.random((3, K)) * 10.0 ** rng.uniform(-3, 3, (3, K))
             ).astype(np.float32)
        assert_bits(suffix_sums(torch.as_tensor(x)), f(jnp.asarray(x)))


def test_kth_smallest_top_level_without_histogram():
    """The merged-tau shape: (D, 2 B S + 2) keys with many +inf, no level-0
    histogram from a build, so shift 24 runs the level kernel too."""
    rng = np.random.default_rng(4)
    keys = rng.random((5, 2 * 64 * 4 + 2)).astype(np.float32)
    keys[rng.random(keys.shape) < 0.6] = np.inf
    keys = torch.as_tensor(keys)
    for k in (1, 65, 300):
        assert_bits(kth_smallest_ranks(keys, k),
                    torch.kthvalue(keys, k, dim=1).values)


# ------------------------------------------------- adaptive tau, the build


def test_adaptive_tau_matches_reference():
    rng = np.random.default_rng(5)
    W = _corpus(rng, D=5, n=2000) ** 2
    W[0] = 0.0                                   # all zero: tau 0
    W[1, 10:] = 0.0                              # nnz <= m: keep all
    W[2, :40] = 50.0                             # a capped head
    for m in (16, 64):
        ref = np.stack([np.asarray(jc.adaptive_tau(jnp.asarray(w), m))
                        for w in W])
        _assert_tau(adaptive_tau(torch.as_tensor(W), m), ref, 1e-6)
        _assert_tau(adaptive_tau_batched(torch.as_tensor(W), m), ref, 1e-5)


@pytest.mark.parametrize("adaptive", [True, False])
@pytest.mark.parametrize("case", THRESHOLD_CASES, ids=lambda c: c.name)
def test_build_threshold_dense_matches_reference(case, adaptive):
    A = make_payloads(case, D=3)[..., 0]
    got = build_threshold_corpus(torch.as_tensor(A), case.m, case.seed,
                                 variant=case.variant, adaptive=adaptive,
                                 device="cpu")
    ref = j_build_threshold(jnp.asarray(A), case.m, case.seed,
                            variant=case.variant, adaptive=adaptive)
    _assert_threshold(got, ref)
    # the row-by-row sort form: same kept set, tau within the reference's
    # own tolerance between its two forms
    _assert_threshold(got, build_threshold_corpus_ref(
        torch.as_tensor(A), case.m, case.seed, variant=case.variant,
        adaptive=adaptive), rtol=1e-5)


@pytest.mark.parametrize("cap", [16, 33])
def test_build_threshold_overflow_cut(cap):
    """cap below m forces the overflow eviction (the reference's
    ``test_threshold_overflow_event_parity``)."""
    rng = np.random.default_rng(13)
    A = _corpus(rng, D=5, n=2000, density=0.5)
    got = build_threshold_corpus(torch.as_tensor(A), 64, 7, cap=cap,
                                 device="cpu")
    _assert_threshold(got, j_build_threshold(jnp.asarray(A), 64, 7, cap=cap))
    _assert_threshold(got, build_threshold_corpus_ref(
        torch.as_tensor(A), 64, 7, cap=cap), rtol=1e-5)
    assert int(got.idx.ne(np.iinfo(np.int32).max).sum(1).max()) == cap


def test_build_threshold_edge_values_and_sparse():
    """Flush-to-zero traps, nnz <= m rows, an all-zero row, and explicit
    coordinates given out of order."""
    rng = np.random.default_rng(9)
    A = edge_values(rng, 4, 1000 + 77)
    A[2] = 0.0
    A[3, 30:] = 0.0
    got = build_threshold_corpus(torch.as_tensor(A), 64, 11, device="cpu")
    _assert_threshold(got, j_build_threshold(jnp.asarray(A), 64, 11))
    ind = rng.choice(40_000, A.shape[1], replace=False).astype(np.int32)
    got = build_threshold_corpus(torch.as_tensor(A), 64, 11,
                                 indices=torch.as_tensor(ind), device="cpu")
    _assert_threshold(got, j_build_threshold(jnp.asarray(A), 64, 11,
                                             indices=jnp.asarray(ind)))


@pytest.mark.parametrize("case", MATRIX_THRESHOLD, ids=lambda c: c.name)
def test_build_payload_threshold_matrix(case):
    """d > 1 payload rows: same kept rows and payloads, tau within the
    rounding of the d-lane weight sums."""
    P = make_payloads(case, D=2)
    got = build_payload_corpus(torch.as_tensor(P), case.m, case.seed,
                               method="threshold", variant=case.variant,
                               device="cpu")
    ref = j_build_payload(jnp.asarray(P), case.m, case.seed,
                          method="threshold", variant=case.variant)
    _assert_threshold(got, ref, rtol=1e-5)


# --------------------------------------------------- single vector, corpus


@pytest.mark.parametrize("variant", ["l2", "l1", "uniform"])
def test_threshold_sketch_backends_match_reference(variant):
    rng = np.random.default_rng(14)
    a = _corpus(rng, D=1, n=2500)[0]
    for adaptive in (True, False):
        ref = jc.threshold_sketch(jnp.asarray(a), 48, 3, variant=variant,
                                  adaptive=adaptive)
        _assert_threshold(threshold_sketch(torch.as_tensor(a), 48, 3,
                                           variant=variant,
                                           adaptive=adaptive), ref)
        fast = threshold_sketch(torch.as_tensor(a), 48, 3, variant=variant,
                                adaptive=adaptive, backend="kernel")
        _assert_threshold(fast, jc.threshold_sketch(
            jnp.asarray(a), 48, 3, variant=variant, adaptive=adaptive,
            backend="pallas"))
        _assert_threshold(fast, ref, rtol=1e-5)
    with pytest.raises(ValueError, match="unknown backend"):
        threshold_sketch(torch.as_tensor(a), 48, 3, backend="pallas")


@pytest.mark.parametrize("method", ["priority", "threshold"])
def test_sketch_corpus_matches_reference(method):
    rng = np.random.default_rng(15)
    A = _corpus(rng, D=4, n=2000)
    for backend, j_backend in (("reference", "reference"),
                               ("kernel", "pallas")):
        got = sketch_corpus(A, 32, 5, method=method, backend=backend,
                            device="cpu")
        ref = jc.sketch_corpus(jnp.asarray(A), 32, 5, method=method,
                               backend=j_backend)
        _assert_threshold(got, ref)
    with pytest.raises(ValueError, match="unknown method"):
        sketch_corpus(A, 32, 5, method="sorted", device="cpu")


# ------------------------------------------------------- variance helpers


def test_variance_helpers_match_reference():
    rng = np.random.default_rng(16)
    a, b = sparse_block(rng, 2, 4000, 900)
    b[:2000] = 0.5 * a[:2000]
    ta, tb = torch.as_tensor(a), torch.as_tensor(b)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    for got, ref in zip(intersection_norms(ta, tb),
                        jc.variance.intersection_norms(ja, jb)):
        np.testing.assert_allclose(to_np(got), np.asarray(ref), rtol=1e-5)
    for method in ("threshold", "priority"):
        np.testing.assert_allclose(
            to_np(variance_bound(ta, tb, 64, method=method)),
            np.asarray(jc.variance_bound(ja, jb, 64, method=method)),
            rtol=1e-5)
        np.testing.assert_allclose(
            to_np(error_guarantee(ta, tb, 64, method=method)),
            np.asarray(jc.error_guarantee(ja, jb, 64, method=method)),
            rtol=1e-5)
        lo, hi = chebyshev_interval(3.0, 40.0, 50.0, 64, method=method)
        jlo, jhi = jc.chebyshev_interval(3.0, 40.0, 50.0, 64, method=method)
        np.testing.assert_allclose([float(lo), float(hi)],
                                   [float(jlo), float(jhi)], rtol=1e-6)
    np.testing.assert_allclose(to_np(linear_sketch_error(ta, tb, 64)),
                               np.asarray(jc.linear_sketch_error(ja, jb, 64)),
                               rtol=1e-5)
    assert sketch_size_high_prob(256) == jc.sketch_size_high_prob(256)
    val = rng.standard_normal((3, 16, 4)).astype(np.float32)
    val[val < 0] = 0.0
    tau = np.array([0.5, np.inf, 2.0], np.float32)
    for got, ref in zip(rescaled_kept_norms(val, tau),
                        jc.rescaled_kept_norms(val, tau)):
        np.testing.assert_allclose(to_np(got), np.asarray(ref), rtol=1e-6)


def test_quickstart_passes_its_asserts_on_cpu():
    out = quickstart.main(device="cpu")
    assert out["scaled_error"]["priority"] < out["bound"]
    assert out["scaled_error"]["threshold"] < out["bound"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            quickstart.main()
