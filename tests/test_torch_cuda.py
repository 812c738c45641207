"""The port's CUDA kernels on the card, against their plain versions.

Every test here carries the ``cuda`` marker and takes the ``cuda_device``
fixture, so it skips with the reason where there is no card.  The file
imports neither ``jax`` nor ``repro``, so it runs on a machine that has
only PyTorch: ``python -m pytest -m cuda tests/test_torch_cuda.py``.
Build kernels are held bit for bit; estimators within float32 summation
tolerance (``_torch_common.RTOL``)."""
import numpy as np
import pytest
import torch

from _torch_common import (assert_bits, assert_close, cuda_device,  # noqa: F401
                           edge_values, sparse_block)

import repro_torch.kernels as tk
from repro_torch.kernels.intersect_estimate import (allpairs_estimate_ref,
                                                    intersect_estimate_ref)
from repro_torch.kernels.hash_rank import (hash_rank_batched_ref,
                                           hash_rank_ref)
from repro_torch.kernels.sketch_build import (build_priority_corpus_ref,
                                              hash_rank_hist_ref,
                                              rank_hist_ref)
from repro_torch.kernels.matrix_sketch import matrix_products_ref
from repro_torch.kernels.sketch_merge import merge_bucketized_ref
from repro_torch.engine import payload_weight
import repro_torch.matrix as tm
from repro_torch.serve import MatrixSketchStore, SketchIndex

pytestmark = pytest.mark.cuda


@pytest.mark.parametrize("variant", ["l2", "l1", "uniform"])
def test_hash_rank_hist_kernel_matches_plain(cuda_device, variant):
    rng = np.random.default_rng(1)
    A = torch.as_tensor(edge_values(rng, 7, 65536 + 77), device=cuda_device)
    before = tk.hash_rank_hist.launches
    got = tk.hash_rank_hist(A, 11, variant=variant)
    ref = hash_rank_hist_ref(A, 11, variant=variant)
    assert tk.hash_rank_hist.launches == before + 1
    for g, r in zip(got, ref):
        assert_bits(g, r)


def test_rank_hist_kernel_and_selection(cuda_device):
    rng = np.random.default_rng(2)
    A = torch.as_tensor(edge_values(rng, 9, 20000 + 5), device=cuda_device)
    _, rank, hist0 = tk.hash_rank_hist(A, 5)
    for shift in (24, 16, 8, 0):
        prefix = torch.arange(9, dtype=torch.int32, device=cuda_device)
        assert_bits(tk.rank_hist(rank, prefix, shift=shift),
                    rank_hist_ref(rank, prefix, shift=shift))
    for k in (1, 65, 20005):
        assert_bits(tk.kth_smallest_ranks(rank, k, hist0=hist0),
                    torch.kthvalue(rank, k, dim=1).values)


def test_build_on_card_matches_reference_sketches(cuda_device):
    rng = np.random.default_rng(3)
    A = torch.as_tensor(edge_values(rng, 6, 9000 + 3), device=cuda_device)
    got = tk.build_priority_corpus(A, 64, 5, device=cuda_device)
    ref = build_priority_corpus_ref(A, 64, 5)
    for g, r in zip(got, ref):
        assert_bits(g, r)


def _card_corpus(device, D, m=64, n_buckets=128, slots=4, seed=0):
    rng = np.random.default_rng(seed)
    A = torch.as_tensor(sparse_block(rng, D, 4000, 500), device=device)
    sk = tk.build_priority_corpus(A, m, 11, device=device)
    return tk.bucketize_corpus(sk, n_buckets=n_buckets, slots=slots)


@pytest.mark.parametrize("slots", [4, 3])
def test_intersect_estimate_kernel_matches_plain(cuda_device, slots):
    c = _card_corpus(cuda_device, 37, slots=slots)
    q = tk.BucketizedSketch(*(x[4] for x in c))
    before = tk.intersect_estimate.launches
    got = tk.intersect_estimate(q.idx, q.val, q.tau, c.idx, c.val, c.tau)
    assert tk.intersect_estimate.launches == before + 1
    assert_close(got, intersect_estimate_ref(q.idx, q.val, q.tau, c.idx,
                                             c.val, c.tau))


@pytest.mark.parametrize("moments", [False, True])
@pytest.mark.parametrize("slots", [4, 3])
def test_allpairs_estimate_kernel_matches_plain(cuda_device, moments, slots):
    """Ragged tiles on both sides (37 x 141 against 64 x 64 tiles)."""
    a = _card_corpus(cuda_device, 37, slots=slots, seed=1)
    b = _card_corpus(cuda_device, 141, slots=slots, seed=2)
    pa, pb = tk.slot_inclusion_probs(a), tk.slot_inclusion_probs(b)
    got = tk.allpairs_estimate(a.idx, a.val, pa, b.idx, b.val, pb,
                               moments=moments)
    ref = allpairs_estimate_ref(a.idx, a.val, pa, b.idx, b.val, pb,
                                moments=moments)
    assert_close(got, ref)


def test_index_on_card_matches_cpu(cuda_device):
    rng = np.random.default_rng(41)
    vecs = sparse_block(rng, 40, 3000, 300)
    cfg = dict(m=64, n_buckets=128, slots=4, initial_capacity=8)
    t = SketchIndex(**cfg, device=cuda_device)
    c = SketchIndex(**cfg, device="cpu")
    for index in (t, c):
        index.add_many([f"v{d}" for d in range(30)], vecs[:30])
        for d in range(30, 39):
            index.add(f"v{d}", vecs[d])
        nz = np.flatnonzero(vecs[39])
        index.add("v39", indices=nz, values=vecs[39][nz])
    for name in ("_idx", "_val", "_tau", "_dropped", "_head_kept"):
        assert_bits(getattr(t, name), getattr(c, name))
    assert [n for n, _ in t.query(vecs[5], top_k=5)] == \
        [n for n, _ in c.query(vecs[5], top_k=5)]
    assert_close(t.all_pairs(), c.all_pairs())


@pytest.mark.parametrize("variant", ["l2", "l1", "uniform"])
def test_hash_rank_kernels_match_plain(cuda_device, variant):
    rng = np.random.default_rng(4)
    A = torch.as_tensor(edge_values(rng, 7, 65536 + 77), device=cuda_device)
    before = (tk.hash_rank_batched.launches, tk.hash_rank.launches)
    for g, r in zip(tk.hash_rank_batched(A, 11, variant=variant),
                    hash_rank_batched_ref(A, 11, variant=variant)):
        assert_bits(g, r)
    for g, r in zip(tk.hash_rank(A[3], 11, variant=variant),
                    hash_rank_ref(A[3], 11, variant=variant)):
        assert_bits(g, r)
    assert (tk.hash_rank_batched.launches, tk.hash_rank.launches) == \
        (before[0] + 1, before[1] + 1)


@pytest.mark.parametrize("cap", [None, 40])
def test_threshold_build_on_card_matches_plain(cuda_device, cap):
    """The kernel build against the same build on the kernels' plain
    versions on the card (bit for bit, tau included); cap=40 < m forces
    the overflow cut."""
    rng = np.random.default_rng(5)
    A = torch.as_tensor(edge_values(rng, 6, 9000 + 3), device=cuda_device)
    for indices in (None, torch.randperm(9003, device=cuda_device)):
        got = tk.build_threshold_corpus(A, 64, 5, cap=cap, indices=indices,
                                        device=cuda_device)
        ref = tk.build_threshold_corpus(A, 64, 5, cap=cap, indices=indices,
                                        device=cuda_device, use_kernel=False)
        for g, r in zip(got, ref):
            assert_bits(g, r)


@pytest.mark.parametrize("n_buckets", [128, 16])
def test_merge_bucketized_kernel_matches_plain(cuda_device, n_buckets):
    rng = np.random.default_rng(6)
    A = sparse_block(rng, 37, 4000, 500)
    mask = rng.random(4000) < 0.5
    halves = [torch.as_tensor(np.where(keep, A, 0.0).astype(np.float32),
                              device=cuda_device) for keep in (mask, ~mask)]
    lo, hi = (tk.bucketize_corpus(tk.build_priority_corpus(
        x, 64, 11, device=cuda_device), n_buckets=n_buckets, slots=4)
        for x in halves)
    tau = tk.merged_tau_bucketized(lo, hi, 11, m=64)
    before = tk.merge_bucketized.launches
    got = tk.merge_bucketized(lo.idx, lo.val, hi.idx, hi.val, tau, 11)
    assert tk.merge_bucketized.launches == before + 1
    ref = merge_bucketized_ref(lo.idx, lo.val, hi.idx, hi.val, tau, 11)
    for g, r in zip(got, ref):
        assert_bits(g, r)
    if n_buckets == 16:
        assert int(got[2].sum()) > 0
    # slots that miss the vector-load path (S = 3)
    lo3, hi3 = (tk.bucketize_corpus(tk.build_priority_corpus(
        x, 64, 11, device=cuda_device), n_buckets=n_buckets, slots=3)
        for x in halves)
    tau3 = tk.merged_tau_bucketized(lo3, hi3, 11, m=64)
    for g, r in zip(tk.merge_bucketized(lo3.idx, lo3.val, hi3.idx, hi3.val,
                                        tau3, 11),
                    merge_bucketized_ref(lo3.idx, lo3.val, hi3.idx, hi3.val,
                                         tau3, 11)):
        assert_bits(g, r)


def test_merge_from_on_card_matches_cpu(cuda_device):
    rng = np.random.default_rng(42)
    M = sparse_block(rng, 20, 3000, 300)
    lo, hi = M.copy(), M.copy()
    lo[:, 1500:] = 0.0
    hi[:, :1500] = 0.0
    names = [f"v{d}" for d in range(20)]
    merged = []
    for dev in (cuda_device, "cpu"):
        a = SketchIndex(m=64, n_buckets=128, device=dev)
        b = SketchIndex(m=64, n_buckets=128, device=dev)
        a.add_many(names, lo)
        b.add_many(names, hi)
        a.merge_from(b)
        merged.append(a)
    for name in ("_idx", "_val", "_tau", "_dropped", "_head_kept"):
        assert_bits(getattr(merged[0], name), getattr(merged[1], name))


def test_wrappers_reject_bad_inputs(cuda_device):
    x = torch.zeros((2, 8), dtype=torch.float64, device=cuda_device)
    with pytest.raises(ValueError, match="float32"):
        tk.hash_rank_hist(x, 0)
    keys = torch.zeros((2, 8), device=cuda_device)
    with pytest.raises(ValueError, match="prefix"):
        tk.rank_hist(keys, torch.zeros(2, dtype=torch.int64,
                                       device=cuda_device), shift=8)
    with pytest.raises(ValueError, match="shift"):
        tk.rank_hist(keys, torch.zeros(2, dtype=torch.int32,
                                       device=cuda_device), shift=4)
    with pytest.raises(ValueError, match="float32"):
        tk.hash_rank_batched(x, 0)
    with pytest.raises(ValueError, match="variant"):
        tk.hash_rank(keys[0], 0, variant="l3")
    idx = torch.zeros((2, 4, 9), dtype=torch.int32, device=cuda_device)
    val = torch.zeros((2, 4, 9), device=cuda_device)
    tau = torch.ones(2, device=cuda_device)
    with pytest.raises(ValueError, match="slots"):
        tk.merge_bucketized(idx, val, idx, val, tau, 0)
    with pytest.raises(ValueError, match="tau"):
        tk.merge_bucketized(idx[..., :4].contiguous(), val[..., :4].contiguous(),
                            idx[..., :4].contiguous(), val[..., :4].contiguous(),
                            tau[:1], 0)


def _matrix_pair(rng, n, da, db, overlap=0.5):
    """Row-partial-overlap pair with lognormal row scales, as
    ``benchmarks/matrix_product.py::_pair``."""
    A = (rng.standard_normal((n, da))
         * rng.lognormal(0.0, 1.0, (n, 1))).astype(np.float32)
    B = (rng.standard_normal((n, db))
         * rng.lognormal(0.0, 1.0, (n, 1))).astype(np.float32)
    lead = (1.0 - overlap) / 2.0
    A[int((lead + overlap) * n):] = 0
    B[: int(lead * n)] = 0
    return A, B


def _matrix_layouts(device, P, n, da, db, *, m=64, n_buckets=128, slots=4,
                    seed=0, special=False):
    """Bucketized (idx, rows, p) of both sides on the card.  ``special``:
    the last A side a padding sketch (all INVALID, tau = 1) and the first
    pair with fewer nonzero rows than m (tau = inf, everything kept)."""
    rng = np.random.default_rng(seed)
    pairs = [_matrix_pair(rng, n, da, db) for _ in range(P)]
    if special:
        pairs[0][0][40:] = 0.0
    sides = []
    for k in (0, 1):
        sks = [tm.priority_matrix_sketch(torch.as_tensor(p[k], device=device),
                                         m, 11) for p in pairs]
        S = tm.stack_matrix_sketches(sks)
        if special and k == 0:
            S.row_idx[-1] = np.iinfo(np.int32).max
            S.rows[-1] = 0.0
            S.tau[-1] = 1.0
        bc = tk.bucketize_matrix_sketches(S, n_buckets=n_buckets, slots=slots)
        sides.append((bc.idx, bc.rows, tk.matrix_slot_probs(bc), bc.dropped))
    return sides


@pytest.mark.parametrize("da,db,slots,n_buckets", [
    (16, 16, 4, 512), (8, 3, 4, 128), (6, 6, 2, 128), (5, 7, 3, 128),
    (24, 24, 4, 128), (4, 4, 4, 16)])
def test_matrix_products_kernel_matches_plain(cuda_device, da, db, slots,
                                              n_buckets):
    """Unequal widths, S = 2, 3, 4, outputs beyond one block's 256
    threads (24 x 24), a 16-bucket layout that drops rows, a padding pair
    and a keep-everything (tau = inf) pair."""
    a, b = _matrix_layouts(cuda_device, 7, 900, da, db, slots=slots,
                           n_buckets=n_buckets, special=True)
    if n_buckets == 16:
        assert int(a[3].sum()) > 0
    before = tk.matrix_products.launches
    got = tk.matrix_products(*a[:3], *b[:3])
    torch.cuda.synchronize()
    assert tk.matrix_products.launches == before + 1
    assert_close(got, matrix_products_ref(*a[:3], *b[:3]))
    assert bool((got[-1] == 0).all())
    # run to run: the same bits (the match list is built without atomics)
    assert_bits(tk.matrix_products(*a[:3], *b[:3]), got)


def test_matrix_products_broadcast_query(cuda_device):
    """One query side read for every pair (batch stride 0) equals the
    query copied P times, bit for bit, and the plain version."""
    a, b = _matrix_layouts(cuda_device, 9, 900, 16, 16, n_buckets=512)
    q = [x[:1].contiguous() for x in a[:3]]
    got = tk.matrix_products(*q, *b[:3])
    copies = tk.matrix_products(*(x.expand(9, *x.shape[1:]).contiguous()
                                  for x in q), *b[:3])
    assert_bits(got, copies)
    assert_close(got, matrix_products_ref(*q, *b[:3]))


@pytest.mark.parametrize("d", [2, 8, 16, 33, 64])
def test_payload_weight_card_equals_cpu(cuda_device, d):
    rng = np.random.default_rng(d)
    X = (rng.standard_normal((4096, d))
         * rng.lognormal(0.0, 2.0, (4096, 1))).astype(np.float32)
    for rows in (X, edge_values(rng, 512, d)):
        for variant in ("l2", "l1"):
            assert_bits(payload_weight(torch.as_tensor(rows,
                                                       device=cuda_device),
                                       variant),
                        payload_weight(torch.as_tensor(rows), variant))


def test_matrix_store_on_card_matches_cpu(cuda_device):
    rng = np.random.default_rng(43)
    stores = [MatrixSketchStore(64, dim=8, initial_capacity=2, device=dev)
              for dev in (cuda_device, "cpu")]
    mats = [_matrix_pair(rng, 2000, 8, 8)[k % 2] for k in range(6)]
    for st in stores:
        for k, X in enumerate(mats):
            st.add(f"M{k}", X)
    for name in ("_idx", "_rows", "_tau"):
        assert_bits(getattr(stores[0], name), getattr(stores[1], name))
    q = _matrix_pair(rng, 2000, 8, 8)[1]
    before = tk.matrix_products.launches
    got = np.stack([e for _, e in stores[0].query(q)])
    assert tk.matrix_products.launches == before + 1
    assert_close(got, np.stack([e for _, e in stores[1].query(q)]))
    pairs = [("M0", "M1"), ("M2", "M3"), ("M5", "M4")]
    assert_close(stores[0].products(pairs), stores[1].products(pairs))
    assert_close(stores[0].product("M0", "M3"),
                 stores[1].product("M0", "M3"))


def test_matrix_products_rejects_bad_inputs(cuda_device):
    a, b = _matrix_layouts(cuda_device, 3, 500, 4, 4)
    with pytest.raises(ValueError, match="pair"):
        tk.matrix_products(*(x[:2] for x in a[:3]), *b[:3])
    with pytest.raises(ValueError, match="float32"):
        tk.matrix_products(a[0], a[1].double(), a[2], *b[:3])
    with pytest.raises(ValueError, match="contiguous"):
        tk.matrix_products(a[0], a[1].transpose(1, 2), a[2], *b[:3])
    big = torch.zeros((1, 16384, 4), dtype=torch.int32, device=cuda_device)
    rows = torch.zeros((1, 16384, 4, 4), device=cuda_device)
    p = torch.ones((1, 16384, 4), device=cuda_device)
    with pytest.raises(ValueError, match="shared memory"):
        tk.matrix_products(big, rows, p, big, rows, p)
