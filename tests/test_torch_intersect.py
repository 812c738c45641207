"""Port parity: the bucketized layout and the two estimators.

The layout (ids, values, drops) is bit-equal to ``repro``'s; the query and
all-pairs estimates (plain and moments) agree with the Pallas kernels
(interpret mode) within float32 summation tolerance.  The CUDA kernels are
held against the plain versions on the card (``cuda`` marker)."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from _torch_common import (assert_bits, assert_close,
                           edge_values, sparse_block, to_np)
from _torch_common import release_jax_executables  # noqa: F401
from parity._grid import VECTOR_CASES, make_payloads

import repro.engine as je
import repro.kernels as jk
from repro.core import Sketch as JSketch
import repro_torch.engine as te
import repro_torch.kernels as tk
from repro_torch.core import Sketch
from repro_torch.kernels.intersect_estimate import (allpairs_compact_ref,
                                                    allpairs_estimate_ref,
                                                    allpairs_join_ref,
                                                    intersect_estimate_ref)


def _corpora(D=12, n=3000, nnz=400, m=64, seed=11, values=None):
    """The same priority sketches from both packages (bit-equal: the build
    parity tests hold that), as (torch Sketch, jax Sketch)."""
    rng = np.random.default_rng(D * 7 + n)
    A = sparse_block(rng, D, n, nnz) if values is None else values
    j = jk.build_priority_corpus(jnp.asarray(A), m, seed)
    t = Sketch(*(torch.as_tensor(np.array(x)) for x in j))
    return t, j


@pytest.mark.parametrize("n_buckets,slots", [(128, 4), (16, 2), (48, 3)])
def test_bucketize_corpus_bit_equal_with_drops(n_buckets, slots):
    t, j = _corpora(D=9)
    got = tk.bucketize_corpus(t, n_buckets=n_buckets, slots=slots)
    ref = jk.bucketize_corpus(j, n_buckets=n_buckets, slots=slots)
    for g, r in zip(got, ref):
        assert_bits(g, r)
    if n_buckets == 16:
        assert int(to_np(got.dropped).min()) > 0   # overflow exercised


def test_bucketize_single_sketch_and_payloads():
    t, j = _corpora(D=2)
    got = tk.bucketize(Sketch(t.idx[1], t.val[1], t.tau[1]), n_buckets=64)
    ref = jk.bucketize(JSketch(j.idx[1], j.val[1], j.tau[1]), n_buckets=64)
    for g, r in zip(got, ref):
        assert_bits(g, r)
    rng = np.random.default_rng(3)
    P = rng.normal(size=(3, 200, 4)).astype(np.float32)
    jp = je.build_payload_corpus(jnp.asarray(P), 24, 5, method="priority")
    tp = te.PayloadSketch(*(torch.as_tensor(np.array(x)) for x in jp))
    got = te.bucketize_payload_sketches(tp, n_buckets=16, slots=2)
    ref = je.bucketize_payload_sketches(jp, n_buckets=16, slots=2)
    for g, r in zip(got, ref):
        assert_bits(g, r)


@pytest.mark.parametrize("variant", ["l2", "l1", "uniform"])
def test_slot_inclusion_probs_bit_equal(variant):
    t, j = _corpora(D=5)
    bt = tk.bucketize_corpus(t, n_buckets=128)
    bj = jk.bucketize_corpus(j, n_buckets=128)
    assert_bits(tk.slot_inclusion_probs(bt, variant=variant),
                jk.slot_inclusion_probs(bj, variant=variant))


@pytest.mark.parametrize("slots", [4, 2])
def test_query_corpus_matches_pallas(slots):
    t, j = _corpora(D=13, m=96)
    bt = tk.bucketize_corpus(t, n_buckets=128, slots=slots)
    bj = jk.bucketize_corpus(j, n_buckets=128, slots=slots)
    for qrow in (0, 5):
        q_t = tk.BucketizedSketch(*(x[qrow] for x in bt))
        q_j = jk.BucketizedSketch(*(x[qrow] for x in bj))
        ref = jk.query_corpus(q_j, bj, use_pallas=True)
        assert_close(tk.query_corpus(q_t, bt), ref)
        assert_close(tk.query_corpus(q_t, bt, use_kernel=False), ref)


def test_query_corpus_edge_values():
    """Subnormal and huge values in the sketches: same estimates,
    including the infinities of overflowing products."""
    rng = np.random.default_rng(4)
    t, j = _corpora(values=edge_values(rng, 6, 3000), m=64)
    bt = tk.bucketize_corpus(t, n_buckets=128)
    bj = jk.bucketize_corpus(j, n_buckets=128)
    q_t = tk.BucketizedSketch(*(x[2] for x in bt))
    q_j = jk.BucketizedSketch(*(x[2] for x in bj))
    got = to_np(tk.query_corpus(q_t, bt))
    ref = np.asarray(jk.query_corpus(q_j, bj, use_pallas=True))
    fin = np.isfinite(ref)
    assert_bits(np.isfinite(got), fin)
    assert_bits(got[~fin], ref[~fin])
    assert_close(got[fin], ref[fin])


@pytest.mark.parametrize("variant", ["l2", "l1"])
def test_all_pairs_matches_pallas(variant):
    t, j = _corpora(D=11, m=64)
    t2, j2 = _corpora(D=9, n=3000, m=64)
    At, Bt = (tk.bucketize_corpus(x, n_buckets=128) for x in (t, t2))
    Aj, Bj = (jk.bucketize_corpus(x, n_buckets=128) for x in (j, j2))
    ref = jk.estimate_all_pairs_bucketized(Aj, Bj, variant=variant,
                                           use_pallas=True)
    got = tk.estimate_all_pairs_bucketized(At, Bt, variant=variant)
    assert got.shape == (11, 9)
    assert_close(got, ref)
    assert_close(tk.estimate_all_pairs_bucketized(
        At, Bt, variant=variant, ref_chunk=4, use_kernel=False), ref)


def test_allpairs_moments_matches_pallas():
    t, j = _corpora(D=10, m=64)
    At = tk.bucketize_corpus(t, n_buckets=128)
    Aj = jk.bucketize_corpus(j, n_buckets=128)
    pt = tk.slot_inclusion_probs(At)
    pj = jk.slot_inclusion_probs(Aj)
    ref = np.asarray(jk.allpairs_moments(Aj.idx, Aj.val, pj, Aj.idx, Aj.val,
                                         pj, use_pallas=True))
    got = tk.allpairs_moments(At.idx, At.val, pt, At.idx, At.val, pt)
    assert got.shape == (10, 10, 6)
    for ch in range(6):
        assert_close(to_np(got)[..., ch], ref[..., ch])
    chunked = tk.allpairs_moments(At.idx, At.val, pt, At.idx, At.val, pt,
                                  ref_chunk=3, use_kernel=False)
    assert_bits(chunked, got)


def test_round_up_pow2():
    assert [tk.round_up_pow2(x) for x in (0, 1, 2, 3, 8, 9, 1000)] == \
        [1, 1, 2, 4, 8, 16, 1024]


def _grid_corpora(case, D=5, n_buckets=16, slots=2):
    """The case's block sketched and bucketized by ``repro`` (priority or
    threshold, the case's variant), as (torch, jax) bucketized corpora: a
    small layout, so buckets fill, drop and share rows."""
    A = make_payloads(case, D=D)[..., 0]
    build = (jk.build_priority_corpus if case.method == "priority"
             else jk.build_threshold_corpus)
    j = jk.bucketize_corpus(build(jnp.asarray(A), case.m, case.seed,
                                  variant=case.variant),
                            n_buckets=n_buckets, slots=slots)
    t = tk.BucketizedSketch(*(torch.as_tensor(np.array(x)) for x in j))
    return t, j


@pytest.mark.parametrize("moments", [False, True])
@pytest.mark.parametrize("case", VECTOR_CASES, ids=lambda c: c.name)
def test_compacted_join_matches_pallas(case, moments):
    """The all-pairs kernel's two steps in their plain versions (the
    compaction of each corpus to its occupied slots, then the join of the
    compacted lists) against ``repro``'s all-pairs Pallas kernel in
    interpret mode, A != B and A against itself, estimates and moments,
    within the float32 summation tolerance of ``_torch_common.RTOL``."""
    At, Aj = _grid_corpora(case)
    Bt, Bj = _grid_corpora(case._replace(name=case.name + "-b"), D=3)
    for (xt, xj), (yt, yj) in (((At, Aj), (Bt, Bj)), ((At, Aj), (At, Aj))):
        pt = tk.slot_inclusion_probs(xt, variant=case.variant)
        qt = tk.slot_inclusion_probs(yt, variant=case.variant)
        ca = allpairs_compact_ref(xt.idx, xt.val, pt)
        cb = allpairs_compact_ref(yt.idx, yt.val, qt)
        got = allpairs_join_ref(*ca, *cb, xt.idx.shape[0], yt.idx.shape[0],
                                moments=moments)
        if moments:
            pj = jk.slot_inclusion_probs(xj, variant=case.variant)
            qj = jk.slot_inclusion_probs(yj, variant=case.variant)
            ref = np.asarray(jk.allpairs_moments(xj.idx, xj.val, pj, yj.idx,
                                                 yj.val, qj, use_pallas=True))
            for ch in range(6):
                assert_close(to_np(got)[..., ch], ref[..., ch])
        else:
            ref = jk.estimate_all_pairs_bucketized(
                xj, yj, variant=case.variant, use_pallas=True)
            assert_close(got, ref)


def test_compaction_layout():
    """The compacted layout by hand: occupied slots only, in (id, row,
    slot) order per tile and bucket (an id in two rows stays in row
    order), each row tagged with the length of its id's run (x 256), 1/p
    correctly rounded, padding absent, zeros past each count."""
    INV = 0x7FFFFFFF
    idx = torch.tensor([[[17, INV], [INV, INV]],
                        [[INV, 7], [9, 11]],
                        [[13, 15], [9, INV]]], dtype=torch.int32)
    val = torch.arange(12, dtype=torch.float32).reshape(3, 2, 2) + 1
    p = torch.full((3, 2, 2), 0.3)
    entries, counts = allpairs_compact_ref(idx, val, p)
    assert entries.shape == (1, 2, 64 * 2, 4)
    assert_bits(counts, np.array([[4, 3]], np.int32))
    rc = np.float32(1) / np.float32(0.3)
    want = [[(7, 1 + 256, 6.0), (13, 2 + 256, 9.0), (15, 2 + 256, 10.0),
             (17, 256, 1.0)],
            [(9, 1 + 512, 7.0), (9, 2 + 512, 11.0), (11, 1 + 256, 8.0)]]
    e = to_np(entries)
    for b, rows in enumerate(want):
        got = e[0, b]
        for j, (i, r, v) in enumerate(rows):
            assert list(got[j, :2]) == [i, r]
            assert got[j, 2:].view(np.float32).tolist() == [v, rc]
        assert not got[len(rows):].any()


def test_compaction_kernel_wrapper_on_cpu():
    """A CPU tensor takes the plain version through the wrapper; every
    occupied slot is in the layout once."""
    t, _ = _corpora(D=70)
    bt = tk.bucketize_corpus(t, n_buckets=128)
    pt = tk.slot_inclusion_probs(bt)
    got = tk.allpairs_compact(bt.idx, bt.val, pt)
    for g, r in zip(got, allpairs_compact_ref(bt.idx, bt.val, pt)):
        assert_bits(g, r)
    assert got[0].shape[0] == 2                    # 70 rows: two tiles
    assert int(got[1].sum()) == int((bt.idx != 0x7FFFFFFF).sum())
