"""Port parity: merging partition sketches (``core.merge``,
``engine.merge``), the map-reduce build (``distributed``), the bucketized
merge (kernel B6's plain version, the merged tau, the d-generic merge) and
``SketchIndex.merge_from``.

The same numpy inputs go through ``repro`` (JAX on the CPU; the Pallas
merge kernel in interpret mode) and ``repro_torch`` (``device="cpu"``).
Contract: priority merges and every bucketized output bit for bit;
threshold merges keep the same set, with tau within rtol 1e-5 (a float sum
of partition weights, as in the reference's own tests)."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from _torch_common import assert_bits, to_np

import repro.core as jc
from repro.distributed import partitioned_sketch_corpus as j_partitioned
from repro.engine import (BucketizedPayloads as JBP,
                          merge_bucketized_payloads as j_merge_payloads)
from repro.kernels import bucketize_corpus as j_bucketize_corpus
from repro.kernels import (merge_bucketized_pallas, merge_bucketized_ref as
                           j_merge_ref, merged_tau_bucketized as j_merged_tau)
from repro.serve import SketchIndex as JIndex
from repro_torch.core import (PartitionStats, merge_sketches,
                              merge_sketches_many, merge_stats,
                              partition_stats, priority_sketch,
                              sketch_corpus, threshold_sketch)
from repro_torch.distributed import (partition_bounds,
                                     partitioned_sketch_corpus,
                                     tree_merge_sketches)
from repro_torch.engine import BucketizedPayloads, merge_bucketized_payloads
from repro_torch.kernels import (BucketizedSketch, bucketize_corpus,
                                 merge_bucketized, merge_bucketized_corpora,
                                 merged_tau_bucketized)
from repro_torch.kernels.sketch_merge import merge_bucketized_ref
from repro_torch.serve import SketchIndex

VARIANTS = ("l2", "l1", "uniform")


def _sparse(rng, n, density=0.3):
    a = rng.standard_normal(n).astype(np.float32)
    return np.where(rng.random(n) < density, a, 0.0).astype(np.float32)


def _split(rng, a):
    """Two disjoint-support partitions of ``a`` (random interleaved mask
    over the last axis)."""
    mask = rng.random(a.shape[-1]) < 0.5
    return (np.where(mask, a, 0.0).astype(np.float32),
            np.where(mask, 0.0, a).astype(np.float32))


def _bits3(got, ref):
    for g, r in zip(got, ref):
        assert_bits(g, r)


def _tau_close(got, ref, rtol=1e-5):
    got, ref = to_np(got), np.asarray(ref)
    inf = np.isinf(got) & np.isinf(ref)
    np.testing.assert_allclose(np.where(inf, 0, got), np.where(inf, 0, ref),
                               rtol=rtol)


# ------------------------------------------------------- sketch merges


@pytest.mark.parametrize("variant", VARIANTS)
def test_priority_merge_bit_exact(variant):
    rng = np.random.default_rng(0)
    a = _sparse(rng, 6000)
    lo, hi = _split(rng, a)
    m, seed = 96, 7
    got = merge_sketches(*(priority_sketch(torch.as_tensor(x), m, seed,
                                           variant=variant)
                           for x in (lo, hi)), seed, m=m, variant=variant)
    ref = jc.merge_sketches(*(jc.priority_sketch(jnp.asarray(x), m, seed,
                                                 variant=variant)
                              for x in (lo, hi)), seed, m=m,
                            variant=variant)
    _bits3(got, ref)
    _bits3(got, priority_sketch(torch.as_tensor(a), m, seed,
                                variant=variant))


@pytest.mark.parametrize("variant", VARIANTS)
def test_threshold_merge_exact_kept_set(variant):
    rng = np.random.default_rng(1)
    a = _sparse(rng, 6000)
    lo, hi = _split(rng, a)
    m, seed = 96, 7
    parts = [threshold_sketch(torch.as_tensor(x), m, seed, variant=variant)
             for x in (lo, hi)]
    st = [partition_stats(x, variant=variant, device="cpu") for x in (lo, hi)]
    got = merge_sketches(*parts, seed, m=m, method="threshold",
                         variant=variant, stats_a=st[0], stats_b=st[1])
    ref = jc.merge_sketches(
        *(jc.threshold_sketch(jnp.asarray(x), m, seed, variant=variant)
          for x in (lo, hi)), seed, m=m, method="threshold", variant=variant,
        stats_a=jc.partition_stats(lo, variant=variant),
        stats_b=jc.partition_stats(hi, variant=variant))
    for want in (ref, jc.threshold_sketch(jnp.asarray(a), m, seed,
                                          variant=variant)):
        assert_bits(got.idx, want.idx)
        assert_bits(got.val, want.val)
        _tau_close(got.tau, want.tau)
    # non-adaptive: W recovers from each part's tau = m / W_part
    parts = [threshold_sketch(torch.as_tensor(x), m, seed, variant=variant,
                              adaptive=False) for x in (lo, hi)]
    got = merge_sketches(*parts, seed, m=m, method="threshold",
                         variant=variant, adaptive=False)
    full = jc.threshold_sketch(jnp.asarray(a), m, seed, variant=variant,
                               adaptive=False)
    assert_bits(got.idx, full.idx)
    _tau_close(got.tau, full.tau)


def test_merge_errors_carry_reference_messages():
    rng = np.random.default_rng(2)
    sa = threshold_sketch(torch.as_tensor(_sparse(rng, 500)), 32, 1)
    sb = threshold_sketch(torch.as_tensor(_sparse(rng, 500)), 32, 1)
    with pytest.raises(ValueError, match="PartitionStats"):
        merge_sketches(sa, sb, 1, m=32, method="threshold")
    with pytest.raises(ValueError, match="both sides"):
        merge_sketches(sa, sb, 1, m=32, method="threshold",
                       stats_a=partition_stats(np.ones(4), device="cpu"))
    with pytest.raises(ValueError, match="unknown method"):
        merge_sketches(sa, sb, 1, m=32, method="sorted")
    sk = priority_sketch(torch.as_tensor(_sparse(rng, 3000)), 64, 3)
    with pytest.raises(ValueError, match="dedupe=False"):
        merge_sketches_many([sk, sk], 3, m=64, dedupe=False)
    assert_bits(merge_sketches(sk, sk, 3, m=64).idx, sk.idx)  # deduped


def test_merge_many_flat_equals_chain_and_single_shot():
    rng = np.random.default_rng(13)
    n, m, seed, P = 6000, 64, 27, 5
    a = _sparse(rng, n)
    owner = np.floor(rng.random(n) * P)
    parts = [np.where(owner == i, a, 0.0).astype(np.float32)
             for i in range(P)]
    ps = [priority_sketch(torch.as_tensor(p), m, seed) for p in parts]
    flat = merge_sketches_many(ps, seed, m=m)
    chain = ps[0]
    for p in ps[1:]:
        chain = merge_sketches(chain, p, seed, m=m)
    _bits3(flat, chain)
    _bits3(flat, priority_sketch(torch.as_tensor(a), m, seed))
    _bits3(merge_sketches_many(ps, seed, m=m, dedupe=False), flat)
    ts = [threshold_sketch(torch.as_tensor(p), m, seed) for p in parts]
    st = [partition_stats(p, device="cpu") for p in parts]
    st = PartitionStats(torch.stack([s.total_weight for s in st]),
                        torch.stack([s.nnz for s in st]))
    mg = tree_merge_sketches(ts, seed, m=m, method="threshold", stats=st)
    full = jc.threshold_sketch(jnp.asarray(a), m, seed)
    assert_bits(mg.idx, full.idx)
    _tau_close(mg.tau, full.tau)
    s2 = merge_stats(partition_stats(parts[0], device="cpu"),
                     partition_stats(parts[1], device="cpu"))
    assert int(s2.nnz) == int((parts[0] != 0).sum() + (parts[1] != 0).sum())


@pytest.mark.parametrize("method,P", [("priority", 2), ("priority", 3),
                                      ("threshold", 2), ("threshold", 3)])
def test_partitioned_corpus_matches_reference(method, P):
    rng = np.random.default_rng(9)
    D, n, m, seed = 6, 4096, 64, 19
    A = np.where(rng.random((D, n)) < 0.3, rng.standard_normal((D, n)),
                 0.0).astype(np.float32)
    got = partitioned_sketch_corpus(A, m, seed, num_partitions=P,
                                    method=method, device="cpu")
    ref = j_partitioned(jnp.asarray(A), m, seed, num_partitions=P,
                        method=method)
    one_shot = sketch_corpus(A, m, seed, method=method, backend="kernel",
                             device="cpu")
    for want in (ref, one_shot):
        assert_bits(got.idx, want.idx)
        assert_bits(got.val, want.val)
        if method == "priority":
            assert_bits(got.tau, want.tau)
        else:
            _tau_close(got.tau, want.tau)
    with pytest.raises(ValueError):
        partition_bounds(10, 0)
    with pytest.raises(ValueError):
        partition_bounds(3, 4)
    assert partition_bounds(10, 3) == [(0, 4), (4, 8), (8, 10)]


# -------------------------------------------------- the bucketized merge


def _partitioned_corpora(rng, D=8, n=8192, m=96, seed=11, n_buckets=512):
    """Bucketized corpora of two halves (an interleaved coordinate mask),
    built by both packages; returns (torch pair, JAX pair)."""
    A = np.where(rng.random((D, n)) < 0.3, rng.standard_normal((D, n)),
                 0.0).astype(np.float32)
    lo, hi = _split(rng, A)
    t = [bucketize_corpus(sketch_corpus(x, m, seed, backend="kernel",
                                        device="cpu"),
                          n_buckets=n_buckets, slots=4) for x in (lo, hi)]
    j = [j_bucketize_corpus(jc.sketch_corpus(jnp.asarray(x), m, seed),
                            n_buckets=n_buckets, slots=4) for x in (lo, hi)]
    return t, j


@pytest.mark.parametrize("n_buckets", [512, 16])
def test_merge_bucketized_plain_matches_pallas(n_buckets):
    """The merged tau and the plain merge against the reference's oracle
    and its Pallas kernel (interpret mode), bit for bit; with 16 buckets
    the merge itself overflows and counts its drops."""
    rng = np.random.default_rng(1)
    (tl, th), (jl, jh) = _partitioned_corpora(rng, D=4, n=4096, m=64,
                                              n_buckets=n_buckets)
    for t, j in ((tl, jl), (th, jh)):
        _bits3(t[:2], j[:2])
    tau = merged_tau_bucketized(tl, th, 11, m=64)
    j_tau = j_merged_tau(jl, jh, 11, m=64)
    assert_bits(tau, j_tau)
    got = merge_bucketized_ref(tl.idx, tl.val, th.idx, th.val, tau, 11)
    _bits3(got, j_merge_ref(jl.idx, jl.val, jh.idx, jh.val, j_tau, 11))
    _bits3(got, merge_bucketized_pallas(
        np.asarray(jl.idx), np.asarray(jl.val), np.asarray(jh.idx),
        np.asarray(jh.val), np.asarray(j_tau), 11, interpret=True))
    _bits3(merge_bucketized(tl.idx, tl.val, th.idx, th.val, tau, 11), got)
    if n_buckets == 16:
        assert int(got[2].sum()) > 0
    merged = merge_bucketized_corpora(tl, th, 11, m=64)
    _bits3(merged, (got[0], got[1], tau))
    assert_bits(merged.dropped, tl.dropped + th.dropped + got[2])
    plain = merge_bucketized_corpora(tl, th, 11, m=64, use_kernel=False)
    _bits3(plain, merged)
    # a layout too small to hold m + 1 candidates has no merged tau (the
    # reference returns NaN bits there and keeps nothing)
    with pytest.raises(ValueError, match="k <= n"):
        merged_tau_bucketized(tl, th, 11, m=2 * n_buckets * 4 + 2)


def test_bucketized_merge_matches_core_merge():
    rng = np.random.default_rng(0)
    D, n, m, seed = 6, 8192, 96, 11
    A = np.where(rng.random((D, n)) < 0.3, rng.standard_normal((D, n)),
                 0.0).astype(np.float32)
    lo, hi = _split(rng, A)
    SL, SH = (sketch_corpus(x, m, seed, device="cpu") for x in (lo, hi))
    BL, BH = (bucketize_corpus(s, n_buckets=512, slots=4) for s in (SL, SH))
    assert int(BL.dropped.sum()) == int(BH.dropped.sum()) == 0
    merged = merge_bucketized_corpora(BL, BH, seed, m=m)
    core = merge_sketches(SL, SH, seed, m=m)
    assert_bits(merged.tau, core.tau)
    _bits3(merged[:2], bucketize_corpus(core, n_buckets=512, slots=4)[:2])
    assert_bits(core.idx, sketch_corpus(A, m, seed, device="cpu").idx)


def test_merge_bucketized_payloads_d2():
    """d > 1: the payload-generic plain merge against the reference's."""
    rng = np.random.default_rng(6)
    D, B, S = 3, 64, 4
    idx = rng.choice(5000, (2, D, B, S)).astype(np.int32)
    idx[rng.random(idx.shape) < 0.4] = np.iinfo(np.int32).max
    idx[1, :, :, 0] = idx[0, :, :, 1]            # cross-side duplicates
    pay = rng.standard_normal((2, D, B, S, 2)).astype(np.float32)
    pay[idx == np.iinfo(np.int32).max] = 0.0
    tau = np.array([[0.02, 0.05, np.inf]] * 2, np.float32)
    drop = np.zeros((2, D), np.int32)
    t = [BucketizedPayloads(*(torch.as_tensor(x[i]) for x in
                              (idx, pay, tau, drop))) for i in (0, 1)]
    j = [JBP(*(jnp.asarray(x[i]) for x in (idx, pay, tau, drop)))
         for i in (0, 1)]
    got = merge_bucketized_payloads(t[0], t[1], 5, m=40)
    ref = j_merge_payloads(j[0], j[1], 5, m=40)
    for g, r in zip(got, ref):
        assert_bits(g, r)
    got = merge_bucketized_payloads(t[0], t[1], 5, m=40,
                                    tau=torch.tensor([0.1, 0.2, 0.3]))
    ref = j_merge_payloads(j[0], j[1], 5, m=40,
                           tau=jnp.asarray([0.1, 0.2, 0.3], jnp.float32))
    for g, r in zip(got, ref):
        assert_bits(g, r)


# ------------------------------------------------- SketchIndex.merge_from


def _peer_indexes(cls, rng, **kw):
    n, m, D = 4096, 64, 12
    M = np.where(rng.random((D, n)) < 0.3, rng.standard_normal((D, n)),
                 0.0).astype(np.float32)
    names = [f"col{d}" for d in range(D)]
    lo, hi = np.zeros_like(M), np.zeros_like(M)
    lo[:, :n // 2] = M[:, :n // 2]
    hi[:, n // 2:] = M[:, n // 2:]
    ixs = [cls(m=m, n_buckets=256, **kw) for _ in range(3)]
    for ix, part in zip(ixs, (lo, hi, M)):
        ix.add_many(names[:10], part[:10])
        for d in (10, 11):
            nz = np.flatnonzero(part[d])
            ix.add(names[d], indices=nz, values=part[d][nz])
    return ixs, M


def test_merge_from_matches_reference_and_one_shot():
    (j_lo, j_hi, _), M = _peer_indexes(JIndex, np.random.default_rng(3))
    (t_lo, t_hi, t_full), _ = _peer_indexes(SketchIndex,
                                            np.random.default_rng(3),
                                            device="cpu")
    assert t_lo.total_dropped == t_hi.total_dropped == 0
    j_lo.merge_from(j_hi)
    t_lo.merge_from(t_hi)
    for name in ("_idx", "_val", "_tau", "_dropped", "_g", "_kn",
                 "_head_idx", "_head_val", "_head_kept"):
        assert_bits(getattr(t_lo, name), getattr(j_lo, name))
    for name in ("_idx", "_val", "_tau", "_dropped"):
        assert_bits(getattr(t_lo, name), getattr(t_full, name))
    assert t_lo.summary_epoch == j_lo.summary_epoch
    q = M[5]
    assert [e for _, e in t_lo.query(q)] == [e for _, e in t_full.query(q)]
    np.testing.assert_array_equal(t_lo.all_pairs(), t_full.all_pairs())


def test_merge_from_validates_layout():
    a = SketchIndex(m=32, n_buckets=64, device="cpu")
    with pytest.raises(ValueError, match="share m/n_buckets/slots/seed"):
        a.merge_from(SketchIndex(m=64, n_buckets=64, device="cpu"))
    c = SketchIndex(m=32, n_buckets=64, device="cpu")
    a.add("x", np.ones(128, np.float32))
    c.add("y", np.ones(128, np.float32))
    with pytest.raises(ValueError, match="row names must align"):
        a.merge_from(c)
    empty = SketchIndex(m=32, n_buckets=64, device="cpu")
    empty.merge_from(SketchIndex(m=32, n_buckets=64, device="cpu"))
    assert len(empty) == 0
