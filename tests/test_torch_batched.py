"""Port parity: the estimator half of the bucketized corpus — the tile
estimator (``kernels.estimate_tile_rows``, B5's plain version here), the
batched estimators (``core.estimate_all_pairs``, ``core.estimate_query``)
and the two small estimators (``core.densify``,
``core.estimate_inner_product_dense``).

The same numpy inputs go through ``repro`` (JAX on the CPU; the all-pairs
kernel in interpret mode) and ``repro_torch`` (``device="cpu"``).
Contract: sketches bit for bit, estimates within ``RTOL`` / ``atol_for``,
a tile bit-equal to the matching block of the port's full matrix."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from _torch_common import (assert_bits, assert_close, sparse_block, to_np)
from _torch_common import release_jax_executables  # noqa: F401

import repro.core as jc
import repro.kernels as jk
import repro_torch.core as tc
import repro_torch.kernels as tk

M, SEED, D, N = 48, 13, 8, 4096


@pytest.fixture(scope="module")
def corpus():
    A = sparse_block(np.random.default_rng(47), D, N, 600)
    return (tc.sketch_corpus(A, M, SEED, device="cpu"),
            jc.sketch_corpus(jnp.asarray(A), M, SEED), A)


def _bucketized(S, n_buckets=64):
    b = tk.bucketize_corpus(S, n_buckets=n_buckets, slots=4)
    return b.idx, b.val, tk.slot_inclusion_probs(b)


def test_estimate_tile_rows_against_reference(corpus):
    """Full tiles, a short tile padded with an out-of-range id (which
    clamps to the last row, as the reference's gather does), and a tile
    that repeats a row."""
    S, jS, _ = corpus
    ours = _bucketized(S)
    jb = jk.bucketize_corpus(jS, n_buckets=64, slots=4)
    theirs = (jb.idx, jb.val, jk.slot_inclusion_probs(jb))
    full = tk.estimate_all_pairs_bucketized(*(tk.bucketize_corpus(
        S, n_buckets=64, slots=4),) * 2)
    for ra, rb in (([0, 1, 2, 3], [4, 5, 6, 7]), ([6, 2, 99], [1, 1, 5]),
                   (list(range(D)), list(range(D)))):
        got = tk.estimate_tile_rows(*ours, *ours, ra, rb)
        want = jk.estimate_tile_rows(*theirs, *theirs, jnp.asarray(ra),
                                     jnp.asarray(rb))
        assert_close(got, np.asarray(want))
        clamp = lambda r: np.minimum(r, D - 1)
        assert_bits(got, full[np.ix_(clamp(ra), clamp(rb))])
        assert_bits(tk.estimate_tile_rows(*ours, *ours, ra, rb,
                                          use_kernel=False), got)


@pytest.mark.parametrize("backend", ["reference", "kernel"])
def test_estimate_all_pairs(corpus, backend):
    S, jS, _ = corpus
    jb = {"reference": "reference", "kernel": "pallas"}[backend]
    half = tc.Sketch(*(f[: D // 2] for f in S))
    jhalf = jc.Sketch(*(f[: D // 2] for f in jS))
    for sa, sb, ja, jbb in ((S, S, jS, jS), (half, S, jhalf, jS)):
        got = tc.estimate_all_pairs(sa, sb, backend=backend, n_buckets=256)
        want = jc.estimate_all_pairs(ja, jbb, backend=jb, n_buckets=256)
        assert got.shape == (sa.idx.shape[0], D)
        assert_close(got, np.asarray(want))
    # 256 buckets hold every entry: both backends give the same matrix
    assert int(tk.bucketize_corpus(S, n_buckets=256).dropped.sum()) == 0
    assert_close(tc.estimate_all_pairs(S, S, backend=backend, n_buckets=256),
                 np.asarray(jc.estimate_all_pairs(jS, jS)))
    with pytest.raises(ValueError):
        tc.estimate_all_pairs(S, S, backend="pallas")


@pytest.mark.parametrize("variant", ["l2", "l1", "uniform"])
def test_estimate_query(corpus, variant):
    _, _, A = corpus
    S = tc.sketch_corpus(A, M, SEED, variant=variant, device="cpu")
    jS = jc.sketch_corpus(jnp.asarray(A), M, SEED, variant=variant)
    got = tc.estimate_query(tc.Sketch(*(f[3] for f in S)), S,
                            variant=variant)
    want = jc.estimate_query(jc.Sketch(*(f[3] for f in jS)), jS,
                             variant=variant)
    assert_close(got, np.asarray(want))


def test_densify_and_dense_estimate(corpus):
    S, jS, A = corpus
    for d in (0, 5):
        s = tc.Sketch(*(f[d] for f in S))
        js = jc.Sketch(*(f[d] for f in jS))
        assert_close(tc.densify(s, N), np.asarray(jc.densify(js, N)))
        for variant in ("l2", "l1", "uniform"):
            assert_close(
                tc.estimate_inner_product_dense(s, torch.as_tensor(A[1]),
                                                variant=variant),
                np.asarray(jc.estimate_inner_product_dense(
                    js, jnp.asarray(A[1]), variant=variant)))
    # an all-padding sketch densifies to zeros
    empty = tc.Sketch(torch.full((M,), tc.INVALID_IDX, dtype=torch.int32),
                      torch.zeros(M), torch.tensor(float("inf")))
    assert not to_np(tc.densify(empty, N)).any()
